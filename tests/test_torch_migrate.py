"""Live tenant migration and the rebalancer (port of
sheep_tpu/serve/migrate.py, rebalance.py, plan_migration and the
daemon's ``MIG`` verb) against the reference's.

Every test of tests/test_migrate.py but the network-fault sweep and the
torn delta stream (tests/test_torch_migrate_faults.py holds those, so
the two halves run on two workers) runs twice in one directory: as the
reference wrote it, then rebound to the port (tests/torch_twin.py).
The reference's assertions hold on the port (the cutover, kill -9 at
every phase boundary, the clean abort, the rebalancer's verdicts, the
manifests), and what both runs leave is equal: the state dirs' ``.wal``
and ``.snap`` bytes, the router's ``tenant-map.json`` and migration
manifests.  ``plan_migration`` answers as the reference's over a grid."""

import importlib

import pytest

import test_migrate as M
from torch_twin import (assert_same, cases, clear_fault_plans,
                        cross_recovered, dir_bytes, run_twin)

STATE = (".wal", ".snap", ".sum")
#: tests/test_torch_migrate_faults.py's share
FAULTS = ("test_netfault_sweep", "test_torn_delta_every_frame_boundary")
#: the insert count of this test depends on its writer thread, so each
#: side's state dirs are held to what both packages' stores recover
TIMED = ("test_migrate_under_write_load_zero_acked_loss",)


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    clear_fault_plans()
    yield
    clear_fault_plans()


def fast_driver(side, work, mp):
    """tests/test_migrate.py's autouse ``_fast_driver``."""
    import contextlib
    mp.setenv("SHEEP_MIGRATE_POLL_S", "0.02")
    mp.setenv("SHEEP_MIGRATE_TIMEOUT_S", "30")
    return contextlib.nullcontext({})


def observe(work, side):
    """The state dirs' bytes and the router's durable files (placement
    overrides and migration manifests)."""
    out = dir_bytes(work, suffixes=STATE)
    router = work / "router"
    if router.is_dir():
        for p in sorted(router.iterdir()):
            if p.name == "tenant-map.json" or p.name.startswith("migrate-"):
                out[f"router/{p.name}"] = p.read_bytes()
    return out


def twin(name, tmp_path, monkeypatch, params):
    timed = name in TIMED
    out = run_twin(getattr(M, name), tmp_path, monkeypatch,
                   cross_recovered if timed else observe,
                   fixtures=fast_driver, params=params,
                   before=clear_fault_plans)
    if timed:
        for side in out:
            for d, (ref_crc, port_crc) in out[side].items():
                assert ref_crc == port_crc, (side, d)
        assert sorted(out["ref"]) == sorted(out["port"])
    else:
        assert_same(out)


@pytest.mark.parametrize("name,params", [c[1:] for c in cases(M, FAULTS)],
                         ids=[c[0] for c in cases(M, FAULTS)])
def test_migrate_twin(tmp_path, monkeypatch, name, params):
    twin(name, tmp_path, monkeypatch, params)


def test_plan_migration_equals_reference(monkeypatch):
    """``plan_migration`` (every pin, records around the horizon's
    edge, shrinking and growing imbalances, ties, idle tenants) answers
    as the reference's, and ``SHEEP_REBALANCE_PIN`` pins both alike."""
    monkeypatch.delenv("SHEEP_REBALANCE_PIN", raising=False)
    got = {}
    for side, pkg in (("ref", "sheep_tpu"), ("port", "sheep_tpu_torch")):
        model = importlib.import_module(f"{pkg}.plan.model")
        rec = [model.REBALANCE_PIN_ENV]
        for records in (0, 1, 5000, 1 << 26, 1 << 30):
            for tq, sq, dq in ((0, 10, 1), (5, 50, 10), (20, 50, 25),
                               (30, 40, 0), (10, 30, 10), (7, 7, 7)):
                for pin in (None, "", "go", "stay"):
                    for horizon in (0.01, 60.0, 1e6):
                        rec.append(model.plan_migration(
                            records, tq, sq, dq, pin=pin,
                            horizon_s=horizon))
        for pin in ("go", "stay"):
            monkeypatch.setenv("SHEEP_REBALANCE_PIN", pin)
            rec.append(model.plan_migration(100, 5, 50, 10))
        monkeypatch.setenv("SHEEP_REBALANCE_PIN", "maybe")
        try:
            model.plan_migration(100, 5, 50, 10)
        except ValueError as exc:
            rec.append(str(exc))
        monkeypatch.delenv("SHEEP_REBALANCE_PIN")
        got[side] = rec
    assert got["port"] == got["ref"]
    assert not hasattr(importlib.import_module("sheep_tpu_torch.plan"),
                       "plan_migration")


def test_rebalancer_fold_and_verdicts_equal_reference():
    """``fold_fleet`` over one fleet scrape body, ``qps_of`` and
    ``decide`` over a grid of folds, placements and gates answer as the
    reference's."""
    from sheep_tpu.obs.metrics import parse_prometheus
    body = "\n".join([
        'sheep_process_rss_bytes{cluster="c0",instance="a"} 100',
        'sheep_process_rss_bytes{cluster="c1",instance="b"} 200',
        'sheep_process_rss_bytes{cluster="router",instance="r"} 5',
        'sheep_serve_repl_lag_records{cluster="c0",instance="a"} 3',
        'sheep_fleet_repl_lag_max_records{cluster="c1"} 9',
        'sheep_serve_tenant_requests_total{cluster="c0",tenant="a"} 40',
        'sheep_serve_tenant_requests_total{cluster="c1",tenant="a"} 2',
        'sheep_serve_tenant_requests_total{cluster="c1",tenant="c"} 7',
        'sheep_serve_tenant_applied_seqno{cluster="c0",tenant="a"} 12',
        'sheep_serve_tenant_window_p99_seconds{cluster="c0",tenant="a"}'
        ' 0.25',
        'sheep_serve_mig_phase{cluster="c1",tenant="c",phase="delta"} 1',
        ""])
    samples = parse_prometheus(body)
    got = {}
    for side, pkg in (("ref", "sheep_tpu"), ("port", "sheep_tpu_torch")):
        rb = importlib.import_module(f"{pkg}.serve.rebalance")
        rec = [rb.fold_fleet(samples)]
        fold = lambda **r: {"tenants": {  # noqa: E731
            t: {"requests": float(v), "applied": 500 * (i + 1),
                "p99": 0.001, "mig": False}
            for i, (t, v) in enumerate(r.items())}, "clusters": {}}
        prev = fold(a=0, b=0, c=0)
        for cur in (fold(a=60, b=50, c=100), fold(a=30, b=20, c=25),
                    fold(a=3, b=0, c=0), fold(a=400, b=100, c=10),
                    fold(a=10, b=10, c=10)):
            rec.append(rb.qps_of(prev, cur, 0.5))
            for place in ({"a": "c0", "b": "c0", "c": "c1"},
                          {"a": "c0", "c": "c1"}, {"a": "c0"},
                          {"a": "c1", "b": "c0", "c": "c1"}):
                for hyst, min_qps in ((1.5, 5.0), (1.2, 1.0)):
                    for inflight, cool in ((False, 0.0), (True, 0.0),
                                           (False, 9.0)):
                        rec.append(rb.decide(
                            prev, cur, 1.0, place, hysteresis=hyst,
                            min_qps=min_qps, migration_inflight=inflight,
                            cooldown_remaining_s=cool))
        got[side] = rec
    assert got["port"] == got["ref"]


def _rebalance_after_a_move(work, pkg):
    """ROADMAP §3's input for "after one migration the rebalancer holds
    for good": two single-node clusters of ``pkg``'s package, ``hot``
    (R-MAT 2^6 x 4) on its ring cluster, 8 routed inserts, ``MIGRATE hot
    <dst> wait=30``, 40 more inserts, then a ``Rebalancer`` (hysteresis
    1.2, min qps 1) ticked twice.  Returns the move's phase, the second
    fold's flag for ``hot`` and the second verdict."""
    from sheep_tpu.io.edges import write_dat
    from sheep_tpu.utils.synth import rmat_edges
    S = importlib.import_module(f"{pkg}.serve")
    rb = importlib.import_module(f"{pkg}.serve.rebalance")
    from sheep_tpu.obs.metrics import parse_prometheus
    work.mkdir()
    src = S.HashRing(["c0", "c1"]).lookup("hot")
    dst = "c1" if src == "c0" else "c0"
    tail, head = rmat_edges(6, 4 << 6, seed=5)
    g = str(work / "g.dat")
    write_dat(g, tail, head)
    daemons = {}
    for cid in ("c0", "c1"):
        core = S.ServeCore.bootstrap(str(work / f"{cid}-dflt"),
                                     graph_path=g, num_parts=2)
        specs = [S.TenantSpec("hot", str(work / f"{cid}-hot"), g, 2)] \
            if cid == src else []
        daemons[cid] = S.ServeDaemon(
            core, S.ServeConfig(),
            tenants=S.TenantManager(core, specs)).start()
    router = S.Router({cid: [d.core.state_dir]
                       for cid, d in daemons.items()},
                      state_dir=str(work / "router")).start()
    try:
        with S.ServeClient(*router.address, timeout_s=20.0) as c:
            c.tenant("hot")
            for i in range(8):
                c.insert([(i % 60, (i * 7 + 1) % 60)])
            phase = c.kv(f"MIGRATE hot {dst} wait=30")["phase"]
            c.tenant("hot")
            for i in range(8, 48):
                c.insert([(i % 60, (i * 7 + 1) % 60)])
        reb = rb.Rebalancer(router, interval_s=999, cooldown_s=0.0,
                            hysteresis=1.2, min_qps=1.0)
        router.rebalancer = reb
        assert reb.tick() is None
        verdict = reb.tick()
        fold = rb.fold_fleet(parse_prometheus(
            router.fleet_metrics().decode("ascii", "replace")))
    finally:
        router.shutdown()
        for d in daemons.values():
            d.shutdown()
    return phase, fold["tenants"]["hot"]["mig"], \
        {k: verdict[k] for k in ("action", "reason")}


def test_rebalancer_holds_after_one_move_as_the_reference(tmp_path):
    """The finding in both packages (ROADMAP §3): once ``hot`` has moved,
    the moved source's ``sheep_serve_mig_phase`` series stays at 1, so
    ``fold_fleet`` flags ``hot`` as mid-migration and every later verdict
    holds for that reason; the port answers as the reference does."""
    got = {side: _rebalance_after_a_move(tmp_path / side, pkg)
           for side, pkg in (("ref", "sheep_tpu"),
                             ("port", "sheep_tpu_torch"))}
    assert got["port"] == got["ref"]
    assert got["port"] == ("done", True, {
        "action": "hold", "reason": "a tenant is mid-migration on a member"})
