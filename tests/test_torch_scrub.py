"""Anti-entropy (port of sheep_tpu/serve/scrub.py, plan_scrub and the
daemon's VERIFY, SCRUB and CORRUPT paths) against the reference's.

Every test of tests/test_scrub.py (the router's two among them: a
diverged member pushed to the back of the read spread, and reads
through the router skipping a quarantined member) runs twice in one
directory: as the reference wrote it, then rebound to the port
(tests/torch_twin.py).
The reference's assertions hold on the port, and what both runs leave
is equal: the state dirs' ``.wal``/``.snap`` bytes, the quarantined and
repaired artifacts, and fsck's verdicts on each state dir."""

import os

import pytest

import test_scrub as S
from torch_twin import (assert_same, cases, clear_fault_plans, dir_bytes,
                        run_twin)

KEPT = (".wal", ".snap", ".sum", ".quarantined", ".tre", ".seq", ".hist")


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    clear_fault_plans()
    yield
    clear_fault_plans()


def observe(work, side):
    """The kept artifacts' bytes and the side's own fsck lines on every
    state dir (clock-free: fsck reports chains and checksums)."""
    import importlib
    pkg = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}[side]
    fsck_paths = importlib.import_module(f"{pkg}.integrity.fsck").fsck_paths
    out = dir_bytes(work, suffixes=KEPT)
    for name in sorted(os.listdir(work)):
        path = os.path.join(work, name)
        if os.path.isdir(path):
            results, _ = fsck_paths([path], "strict")
            out[f"fsck:{name}"] = [(os.path.relpath(p, work), ok, d)
                                   for p, ok, d in results]
    return out


@pytest.mark.parametrize("name,params", [c[1:] for c in cases(S)],
                         ids=[c[0] for c in cases(S)])
def test_scrub_twin(tmp_path, monkeypatch, name, params):
    assert_same(run_twin(getattr(S, name), tmp_path, monkeypatch, observe,
                         params=params, before=clear_fault_plans))


def test_scrub_and_tenant_pricing_equal_reference(monkeypatch):
    """``plan_scrub`` (every pin, horizons around the verdict's edge,
    empty and large passes) and ``serve_tenant_nbytes`` (the eviction
    price) answer as the reference's over a grid."""
    import importlib
    monkeypatch.delenv("SHEEP_SCRUB_PIN", raising=False)
    monkeypatch.delenv("SHEEP_SCRUB_HORIZON_S", raising=False)
    got = {}
    for side, pkg in (("ref", "sheep_tpu"), ("port", "sheep_tpu_torch")):
        plan = importlib.import_module(f"{pkg}.plan.model").plan_scrub
        price = importlib.import_module(
            f"{pkg}.resources.governor").serve_tenant_nbytes
        rec = []
        for arts in (0, 1, 7):
            for nbytes in (0, 1 << 20, 3 << 30, 40 << 30):
                for horizon in (None, 0.5, 30.0, 1e6):
                    for pin in (None, "", "go", "stay"):
                        rec.append(plan(arts, nbytes, pin=pin,
                                        horizon_s=horizon))
        for pin in ("go", "stay"):
            monkeypatch.setenv("SHEEP_SCRUB_PIN", pin)
            rec.append(plan(3, 1 << 30))
        monkeypatch.delenv("SHEEP_SCRUB_PIN")
        monkeypatch.setenv("SHEEP_SCRUB_HORIZON_S", "2.5")
        rec.append(plan(3, 1 << 30))
        monkeypatch.delenv("SHEEP_SCRUB_HORIZON_S")
        rec += [price(n, v, k) for n in (0, 1, 1 << 23)
                for v in (0, 5, 1 << 24) for k in (0, 3, 1 << 16)]
        got[side] = rec
    assert got["port"] == got["ref"]
