"""Tests of the benchmark harness.  From the repository root:

    python -m pytest portbench/tests -q            # the CPU tests
    python -m pytest portbench/tests -q -m cuda    # on the card

The harness's modules import as ``harness``; the program as
``sheep_tpu_torch``.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for path in (BENCH, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)


def tiny_spec(tmp_path, log_n: int = 10, records: int = 1 << 13,
              block: int = 1 << 11):
    """The repository's benchmark with every configuration cut to a
    graph of 2^log_n slots and ``records`` records, and every stream
    mix's block to ``block`` records: a checkout at tmp_path whose
    configuration and traffic files are copies, found at the relative
    paths the repository's ``BENCHMARK.json`` gives them."""
    from harness.spec import Spec

    spec = Spec.load(REPO)
    bench = copy.deepcopy(spec.bench)
    bench_dir = tmp_path / "portbench"
    (bench_dir / "configs").mkdir(parents=True)
    (bench_dir / "traffic").mkdir()
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        cfg["graph"]["log_vid_slots"] = log_n
        cfg["graph"]["records"] = records
        c["file"] = f"portbench/configs/{c['name']}.json"
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        traffic = spec.traffic(w["traffic"])
        if "block_records" in traffic:
            traffic["block_records"] = block
        (bench_dir / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(traffic))
    for folder in ("metrics", "entries"):
        os.symlink(os.path.join(BENCH, folder), bench_dir / folder)
    return Spec(bench, str(tmp_path), str(bench_dir))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
