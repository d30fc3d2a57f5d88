"""Live tenant migration under network faults (port of
sheep_tpu/serve/migrate.py and the ``msnap``/``mdelta``/``mcut`` sites)
against the reference's.

The twelve cases of tests/test_migrate.py's network-fault sweep (drop,
partition, slow and dup at each migration site, with their exact
re-dispatch counts) and the six of its torn delta stream (a partition
at each frame boundary) run twice in one directory: as the reference
wrote them, then rebound to the port (tests/torch_twin.py), as
tests/test_torch_migrate.py runs the rest of that file.  The
reference's assertions hold on the port, and the state dirs, the
router's ``tenant-map.json`` and its migration manifests both runs
leave are equal."""

import pytest

import test_migrate as M
from test_torch_migrate import FAULTS, twin
from torch_twin import cases, clear_fault_plans

SKIP = tuple(n for n in dir(M) if n.startswith("test_") and n not in FAULTS)


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    clear_fault_plans()
    yield
    clear_fault_plans()


@pytest.mark.parametrize("name,params", [c[1:] for c in cases(M, SKIP)],
                         ids=[c[0] for c in cases(M, SKIP)])
def test_migrate_fault_twin(tmp_path, monkeypatch, name, params):
    twin(name, tmp_path, monkeypatch, params)
