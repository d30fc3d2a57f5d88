"""Multi-tenancy (port of sheep_tpu/serve/tenants.py and the daemon's
TENANT, EVICT and batched verbs) against the reference's.

Every test of tests/test_tenants.py runs twice in one directory: as the
reference wrote it, then rebound to the port (tests/torch_twin.py).
The reference's assertions hold on the port (evict and restore
bit-identical, pressure eviction, kill -9 at every boundary across
evict and restore), and every tenant state dir both runs leave holds
equal ``.wal`` and ``.snap`` bytes."""

import pytest

import test_tenants as T
from torch_twin import (assert_same, cases, clear_fault_plans, dir_bytes,
                        run_twin)

STATE = (".wal", ".snap", ".sum")


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    clear_fault_plans()
    yield
    clear_fault_plans()


@pytest.mark.parametrize("name,params", [c[1:] for c in cases(T)],
                         ids=[c[0] for c in cases(T)])
def test_tenants_twin(tmp_path, monkeypatch, name, params):
    assert_same(run_twin(getattr(T, name), tmp_path, monkeypatch,
                         lambda work, side: dir_bytes(work, suffixes=STATE),
                         params=params, before=clear_fault_plans))
