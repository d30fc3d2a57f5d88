"""The port's SHEEP_* knob registry (sheep_tpu_torch/utils/knobs.py):
every knob the port reads is declared there, every entry there is read
by the port, and each entry equals the reference registry's."""

import dataclasses
import os
import re

import pytest

from sheep_tpu.utils import knobs as ref_knobs
from sheep_tpu_torch.utils import knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sheep_tpu_torch")
_QUOTED = re.compile(r'["\'](SHEEP_[A-Z0-9_]+)["\']')


def _port_reads() -> set:
    """Every quoted SHEEP_* literal in the port's Python and native
    sources (``.py``, ``.cpp``, ``.cu``, ``.h``) and in chip_smoke.py."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, names in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "_build")]
        paths += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cpp", ".cu", ".h"))]
    found = set()
    for path in paths:
        with open(path, encoding="utf-8", errors="replace") as f:
            found.update(_QUOTED.findall(f.read()))
    return found


def test_every_port_read_is_registered():
    missing = knobs.missing_from_registry(_port_reads())
    assert not missing, (f"SHEEP_* knobs the port reads but "
                         f"sheep_tpu_torch/utils/knobs.py lacks: {missing}")


def test_every_port_entry_is_read():
    stale = sorted(set(knobs.KNOBS) - _port_reads())
    assert not stale, f"registry entries the port never reads: {stale}"


def test_cli_knobs_are_registered():
    for name in ("SHEEP_WORKERS", "SHEEP_CHECKPOINT_DIR", "SHEEP_RESUME",
                 "SHEEP_MAX_RETRIES", "SHEEP_EVAL_STREAM",
                 "SHEEP_EVAL_STREAM_THRESHOLD", "SHEEP_DDUP_GRAPH",
                 "SHEEP_HEARTBEAT_FILE", "SHEEP_SELFCHECK",
                 "SHEEP_COORDINATOR", "SHEEP_EXT_BLOCK",
                 "SHEEP_DISTEXT_LEGS", "SHEEP_MEM_BUDGET"):
        assert knobs.knob(name).name == name


@pytest.mark.parametrize("name", sorted(knobs.KNOBS))
def test_entry_equals_reference(name):
    assert dataclasses.astuple(knobs.KNOBS[name]) == \
        dataclasses.astuple(ref_knobs.KNOBS[name])


def test_markdown_table_lists_every_knob():
    table = knobs.markdown_table()
    for name in knobs.KNOBS:
        assert f"| `{name}` |" in table
    assert table.count("\n") == len(knobs.KNOBS) + 2
