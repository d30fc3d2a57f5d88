"""The port's external-memory build (sheep_tpu_torch.ops.extmem) against
the reference's (sheep_tpu.ops.extmem), test for test with
tests/test_extmem.py: the SHEEP_EXT_BLOCK sweep, both per-block fold
strategies, the out-of-core degree sequence, the kill at every block
boundary then resume, the EIO/ENOSPC retries of the ``dat`` fault site,
the block-size resume refusal, the governor's pricing and env grammar,
the ext rung through the ladder and without ``edges_path``, the routing,
the CLI tree, and the prefetcher's contract.  Each compares the port's
arrays, perf records, events and files with the reference's on the same
seeded ``.dat`` file, and both with the in-RAM oracle."""

import os

import numpy as np
import pytest

import sheep_tpu.ops.extmem as ref_ext
import sheep_tpu_torch.ops.extmem as port_ext
from sheep_tpu.core import build_forest, degree_sequence
from sheep_tpu.io import faultfs as ref_faultfs
from sheep_tpu.io.edges import write_dat
from sheep_tpu_torch.io import faultfs as port_faultfs

SIDES = {"ref": ref_ext, "port": port_ext}


@pytest.fixture
def ext_env(monkeypatch):
    for k in ("SHEEP_EXT_BLOCK", "SHEEP_EXT_STRATEGY", "SHEEP_MEM_BUDGET",
              "SHEEP_IO_FAULT_PLAN", "SHEEP_FAULT_INJECT"):
        monkeypatch.delenv(k, raising=False)
    for ff in (ref_faultfs, port_faultfs):
        ff.clear_plan()
    yield monkeypatch
    for ff in (ref_faultfs, port_faultfs):
        ff.clear_plan()


def _graph_file(tmp_path, log_n=10, seed=5):
    from sheep_tpu.utils.synth import rmat_edges
    n = 1 << log_n
    tail, head = rmat_edges(log_n, 4 * n, seed=seed)
    path = str(tmp_path / "g.dat")
    write_dat(path, tail, head)
    seq = degree_sequence(tail, head)
    want = build_forest(tail, head, seq)
    return path, tail, head, seq, want


def _ecv_down(seq, forest, tail, head, parts=4):
    from sheep_tpu.partition import Partition, evaluate_partition
    part = Partition.from_forest(seq, forest, num_parts=parts)
    rep = evaluate_partition(part.parts, tail, head, seq, num_parts=parts)
    return int(rep.ecv_down)


def _both(fn):
    """``fn(side_module)`` for the reference, then the port."""
    return {name: fn(mod) for name, mod in SIDES.items()}


def _same_forest(got, seq0, want):
    for seq, f in got.values():
        np.testing.assert_array_equal(seq, seq0)
        np.testing.assert_array_equal(f.parent, want.parent)
        np.testing.assert_array_equal(f.pst_weight, want.pst_weight)


#: perf keys whose values are clock readings
_TIMES = ("seq_s", "seq_read_s", "read_s", "fold_s", "overlap_s",
          "overlap_frac", "wall_s")


def _untimed(perf: dict) -> dict:
    return {k: v for k, v in perf.items() if k not in _TIMES}


# ---------------------------------------------------------------------------
# parity: block-size sweep, strategies, streaming sequence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", ["257", "1500", "huge"])
def test_block_size_sweep_parity(tmp_path, ext_env, block):
    path, tail, head, seq0, want = _graph_file(tmp_path)
    block = str(2 * len(tail)) if block == "huge" else block
    ext_env.setenv("SHEEP_EXT_BLOCK", block)
    perfs = {"ref": {}, "port": {}}
    got = {name: mod.build_forest_extmem(path, perf=perfs[name])
           for name, mod in SIDES.items()}
    _same_forest(got, seq0, want)
    seq, f = got["port"]
    assert _ecv_down(seq, f, tail, head) == _ecv_down(seq0, want, tail, head)
    assert perfs["port"]["ext_blocks"] == -(-len(tail) // int(block))
    assert _untimed(perfs["port"]) == _untimed(perfs["ref"])


@pytest.mark.parametrize("strat", ["edges", "links"])
def test_strategy_arms_parity(tmp_path, ext_env, strat):
    path, tail, head, seq0, want = _graph_file(tmp_path, seed=7)
    ext_env.setenv("SHEEP_EXT_STRATEGY", strat)
    perfs = {"ref": {}, "port": {}}
    got = {name: mod.build_forest_extmem(path, block_edges=600,
                                         perf=perfs[name])
           for name, mod in SIDES.items()}
    _same_forest(got, seq0, want)
    assert set(perfs["port"]["strategies"]) == {strat}
    assert perfs["port"]["strategies"] == perfs["ref"]["strategies"]


def test_priced_strategy_picks_equal_reference(tmp_path, ext_env):
    """Unpinned, the governor's price picks each block's strategy, and
    both packages pick alike."""
    path, tail, head, seq0, want = _graph_file(tmp_path, seed=8)
    events = {"ref": [], "port": []}
    got = {name: mod.build_forest_extmem(path, block_edges=400,
                                         events=events[name])
           for name, mod in SIDES.items()}
    _same_forest(got, seq0, want)
    assert events["port"] == events["ref"]
    assert len([e for e in events["port"] if e[0] == "ext-block"]) == \
        -(-len(tail) // 400)


def test_streaming_degree_sequence_matches_reference(tmp_path, ext_env):
    path, tail, head, seq0, _ = _graph_file(tmp_path, seed=11)
    got = _both(lambda m: m.streaming_degree_sequence(path, 333))
    seq, max_vid, records = got["port"]
    np.testing.assert_array_equal(seq, seq0)
    np.testing.assert_array_equal(seq, got["ref"][0])
    assert (max_vid, records) == got["ref"][1:]
    assert records == len(tail)
    assert max_vid == int(max(tail.max(), head.max()))


def test_range_degree_histogram_matches_reference(tmp_path, ext_env):
    """A record slice's histogram, the distributed build's pass 1 leg."""
    path, tail, head, _, _ = _graph_file(tmp_path, seed=12)
    got = _both(lambda m: m.range_degree_histogram(path, 500, 700, 3100))
    np.testing.assert_array_equal(got["port"][0], got["ref"][0])
    assert got["port"][1:] == got["ref"][1:] == (got["ref"][1], 2400)


@pytest.mark.parametrize("strat", ["edges", "links"])
def test_given_partial_seq_keeps_pst_contract(tmp_path, ext_env, strat):
    path, tail, head, full, _ = _graph_file(tmp_path, seed=3)
    sub = full[: len(full) // 2]
    want = build_forest(tail, head, sub, max_vid=(1 << 10) - 1)
    ext_env.setenv("SHEEP_EXT_STRATEGY", strat)
    got = _both(lambda m: m.build_forest_extmem(path, block_edges=700,
                                                seq=sub))
    _same_forest(got, sub, want)


def test_range_build_needs_seq_and_folds_its_slice(tmp_path, ext_env):
    path, tail, head, seq0, _ = _graph_file(tmp_path, seed=4)
    for mod in SIDES.values():
        with pytest.raises(ValueError, match="explicit"):
            mod.build_forest_extmem(path, start_edge=100)
    got = _both(lambda m: m.build_forest_extmem(
        path, block_edges=300, seq=seq0, start_edge=1000, end_edge=2900))
    want = build_forest(tail[1000:2900], head[1000:2900], seq0,
                        max_vid=int(max(tail.max(), head.max())))
    _same_forest(got, seq0, want)


def test_perf_record_shape(tmp_path, ext_env):
    path, tail, head, _, _ = _graph_file(tmp_path)
    perfs = {"ref": {}, "port": {}}
    for name, mod in SIDES.items():
        mod.build_forest_extmem(path, block_edges=900, perf=perfs[name])
    perf = perfs["port"]
    for key in ("ext_blocks", "block_edges", "read_s", "fold_s",
                "overlap_s", "overlap_frac", "wall_s", "strategies",
                "retries", "seq_s"):
        assert key in perf, (key, perf)
    assert sorted(perf) == sorted(perfs["ref"])
    assert perf["retries"] == 0
    assert 0.0 <= perf["overlap_frac"] <= 1.0


# ---------------------------------------------------------------------------
# crash/fault story: kill-at-boundary resume, dat-site EIO/ENOSPC sweep
# ---------------------------------------------------------------------------


def _runtime(name):
    import sheep_tpu.runtime as ref_rt
    import sheep_tpu_torch.runtime as port_rt
    return {"ref": ref_rt, "port": port_rt}[name]


def test_kill_at_every_block_boundary_resume(tmp_path, ext_env):
    """Kill at EVERY block boundary, then resume: the port writes the
    reference's checkpoint (same arrays, rounds and signature), resumes
    with its events, and ends at the oracle's forest."""
    path, tail, head, seq0, want = _graph_file(tmp_path)
    ecv0 = _ecv_down(seq0, want, tail, head)
    B = 800
    nblocks = -(-len(tail) // B)
    for k in range(nblocks):
        snaps, events, got = {}, {}, {}
        for name, mod in SIDES.items():
            rt = _runtime(name)
            ck = str(tmp_path / f"{name}{k}")
            rt.reset_counters()
            rt.install_plan(rt.FaultPlan(site="ext-boundary", at=k,
                                         kind="kill"))
            with pytest.raises(rt.BuildKilled):
                mod.build_forest_extmem(path, block_edges=B,
                                        checkpoint_dir=ck)
            rt.clear_plan()
            rt.reset_counters()
            snaps[name] = rt.load_snapshot(
                os.path.join(ck, "sheep-ckpt.npz"))
            events[name] = []
            got[name] = mod.build_forest_extmem(
                path, block_edges=B, checkpoint_dir=ck, resume=True,
                events=events[name])
            assert not os.path.exists(os.path.join(ck, "sheep-ckpt.npz"))
        for field in ("n", "rounds", "boundary", "rung", "input_sig"):
            assert getattr(snaps["port"], field) == \
                getattr(snaps["ref"], field), (k, field)
        for field in ("seq", "pst", "lo", "hi"):
            np.testing.assert_array_equal(getattr(snaps["port"], field),
                                          getattr(snaps["ref"], field))
        assert events["port"] == events["ref"], k
        if k > 0:
            assert any(e[0] == "ext-resume" for e in events["port"])
        _same_forest(got, seq0, want)
        seq, f = got["port"]
        assert _ecv_down(seq, f, tail, head) == ecv0


def test_eio_at_every_block_read_retries_in_process(tmp_path, ext_env):
    """The ``dat`` fault site over every block read of BOTH passes: each
    EIO retries from the last completed block, as in the reference."""
    path, tail, head, seq0, want = _graph_file(tmp_path)
    B = 800
    nblocks = -(-len(tail) // B)
    for k in range(2 * nblocks):
        perfs, got = {"ref": {}, "port": {}}, {}
        for (name, mod), ff in zip(SIDES.items(),
                                   (ref_faultfs, port_faultfs)):
            ff.install_plan(ff.parse_io_fault_plan(f"eio@dat:{k}"))
            got[name] = mod.build_forest_extmem(
                path, block_edges=B, backoff_base_s=0.0, perf=perfs[name])
            ff.clear_plan()
        perf = perfs["port"]
        assert perf["retries"] + perf.get("seq_retries", 0) == 1, (k, perf)
        assert _untimed(perf) == _untimed(perfs["ref"]), k
        _same_forest(got, seq0, want)


def test_enospc_mid_stream_retries(tmp_path, ext_env):
    path, tail, head, seq0, want = _graph_file(tmp_path, seed=13)
    events, got = {"ref": [], "port": []}, {}
    perfs = {"ref": {}, "port": {}}
    for (name, mod), ff in zip(SIDES.items(), (ref_faultfs, port_faultfs)):
        ff.install_plan(ff.parse_io_fault_plan("enospc@dat:2"))
        got[name] = mod.build_forest_extmem(path, block_edges=700,
                                            backoff_base_s=0.0,
                                            events=events[name],
                                            perf=perfs[name])
        ff.clear_plan()
    assert events["port"] == events["ref"]
    assert _untimed(perfs["port"]) == _untimed(perfs["ref"])
    # the third block read is pass 1's: the histogram pass retries it
    assert perfs["port"]["seq_retries"] == 1
    _same_forest(got, seq0, want)


def test_reader_fault_budget_exhausts_typed_then_resumes(tmp_path,
                                                         ext_env):
    path, tail, head, seq0, want = _graph_file(tmp_path)
    plan = ",".join(f"eio@dat:{i}" for i in range(3, 24))
    got = {}
    for (name, mod), ff in zip(SIDES.items(), (ref_faultfs, port_faultfs)):
        ck = str(tmp_path / f"ck-{name}")
        ff.install_plan(ff.parse_io_fault_plan(plan))
        with pytest.raises(OSError, match="injected"):
            mod.build_forest_extmem(path, block_edges=800,
                                    checkpoint_dir=ck, max_retries=2,
                                    backoff_base_s=0.0)
        ff.clear_plan()
        got[name] = mod.build_forest_extmem(path, block_edges=800,
                                            checkpoint_dir=ck, resume=True)
    _same_forest(got, seq0, want)


def test_resume_refuses_other_block_size(tmp_path, ext_env):
    """The block size is part of the resume identity in both packages."""
    from sheep_tpu.integrity.errors import IntegrityError as RefIntegrity
    from sheep_tpu_torch.integrity.errors import IntegrityError
    path, tail, head, _, _ = _graph_file(tmp_path)
    for name, mod in SIDES.items():
        rt = _runtime(name)
        ck = str(tmp_path / f"ck-{name}")
        rt.reset_counters()
        rt.install_plan(rt.FaultPlan(site="ext-boundary", at=2,
                                     kind="kill"))
        with pytest.raises(rt.BuildKilled):
            mod.build_forest_extmem(path, block_edges=800,
                                    checkpoint_dir=ck)
        rt.clear_plan()
        rt.reset_counters()
        with pytest.raises({"ref": RefIntegrity,
                            "port": IntegrityError}[name]):
            mod.build_forest_extmem(path, block_edges=500,
                                    checkpoint_dir=ck, resume=True)


# ---------------------------------------------------------------------------
# governor pricing + ladder integration + the shared prefetcher
# ---------------------------------------------------------------------------


def test_governor_prices_ext_between_spill_and_stream(ext_env,
                                                      monkeypatch):
    import sheep_tpu.resources.governor as ref_gov
    import sheep_tpu_torch.resources.governor as gov_mod
    n, links = 1 << 20, 1 << 23
    est = {r: gov_mod.rung_peak_nbytes(r, n, links)
           for r in ("host", "stream", "ext", "spill")}
    assert est == {r: ref_gov.rung_peak_nbytes(r, n, links) for r in est}
    assert est["spill"] < est["ext"] < est["stream"] < est["host"]
    monkeypatch.setattr(gov_mod, "rss_bytes", lambda: 0)
    monkeypatch.setattr(ref_gov, "rss_bytes", lambda: 0)
    ladder = ["host", "stream", "ext", "spill"]
    for budget, want in (((est["ext"] + est["stream"]) // 2,
                          ["ext", "spill"]),
                         (est["spill"] // 2, ["spill"])):
        got = gov_mod.ResourceGovernor(mem_budget=budget).plan_rungs(
            ladder, n, links)
        assert got[0] == want
        assert got == ref_gov.ResourceGovernor(
            mem_budget=budget).plan_rungs(ladder, n, links)


@pytest.mark.parametrize("budget", [None, 1 << 20, 3 << 20, 40 << 20,
                                    1 << 30])
@pytest.mark.parametrize("pinned", ["", "64K"])
def test_ext_fitted_block_equals_reference(ext_env, monkeypatch, budget,
                                           pinned):
    """The block halves to the headroom down to its floor, and a pinned
    SHEEP_EXT_BLOCK is never second-guessed; the strategy prices agree."""
    import sheep_tpu.resources.governor as ref_gov
    import sheep_tpu_torch.resources.governor as gov_mod
    if pinned:
        ext_env.setenv("SHEEP_EXT_BLOCK", pinned)
    monkeypatch.setattr(gov_mod, "rss_bytes", lambda: 1 << 19)
    monkeypatch.setattr(ref_gov, "rss_bytes", lambda: 1 << 19)
    for n in (0, 1 << 10, 1 << 16):
        got = gov_mod.ResourceGovernor(mem_budget=budget).ext_fitted_block(n)
        assert got == ref_gov.ResourceGovernor(
            mem_budget=budget).ext_fitted_block(n)
        assert got >= min(gov_mod.EXT_BLOCK_FLOOR, gov_mod.ext_block_edges())
        for carry, rec in ((0, 1 << 19), (n, 300), (4 * n, 1 << 12)):
            assert gov_mod.ext_strategy_costs(n, carry, rec) == \
                ref_gov.ext_strategy_costs(n, carry, rec)


@pytest.mark.parametrize("spec", ["", "2M", "4096", "1k", "0", "3G"])
def test_ext_block_env_grammar(ext_env, spec):
    import sheep_tpu.resources.governor as ref_gov
    import sheep_tpu_torch.resources.governor as gov_mod
    if spec:
        ext_env.setenv("SHEEP_EXT_BLOCK", spec)
    assert gov_mod.ext_block_edges() == ref_gov.ext_block_edges()
    want = {"": gov_mod.EXT_BLOCK_DEFAULT, "2M": 1 << 21, "4096": 4096}
    if spec in want:
        assert gov_mod.ext_block_edges() == want[spec]
    for name in ("EXT_BLOCK_DEFAULT", "EXT_RECORD_BYTES", "EXT_PREFETCH",
                 "EXT_BLOCK_FLOOR", "EXT_BLOCK_ENV"):
        assert getattr(gov_mod, name) == getattr(ref_gov, name)


def _resilient(name, tail, head, **cfg):
    rt = _runtime(name)
    config = rt.RuntimeConfig(**cfg)
    kw = {"device": "cpu"} if name == "port" else {}
    seq, f = rt.build_graph_resilient(tail, head, config=config, **kw)
    return seq, f, config.events


def test_ext_rung_through_ladder(tmp_path, ext_env):
    """build_graph_resilient with edges_path: the ext rung re-streams the
    file, with the reference's events, oracle-exact."""
    path, tail, head, seq0, want = _graph_file(tmp_path, seed=9)
    ext_env.setenv("SHEEP_EXT_BLOCK", "700")
    got = {name: _resilient(name, tail, head, ladder=("ext", "spill"),
                            edges_path=path) for name in SIDES}
    _same_forest({k: v[:2] for k, v in got.items()}, seq0, want)
    assert got["port"][2] == got["ref"][2]
    assert any(e[0] == "ext-block" for e in got["port"][2])


def test_ext_rung_after_forced_degrade(tmp_path, ext_env):
    """single fails for good (an injected fault at every dispatch), the
    ladder gives it up to ext: the reference's events and the oracle's
    forest."""
    path, tail, head, seq0, want = _graph_file(tmp_path, seed=10)
    ext_env.setenv("SHEEP_EXT_BLOCK", "900")
    got = {}
    for name in SIDES:
        rt = _runtime(name)
        rt.reset_counters()
        rt.install_plan(rt.FaultPlan(site="chunk", at=0, kind="xla",
                                     times=-1))
        try:
            got[name] = _resilient(name, tail, head, ladder=("single", "ext"),
                                   edges_path=path, max_retries=1,
                                   backoff_base_s=0.0)
        finally:
            rt.clear_plan()
            rt.reset_counters()
    _same_forest({k: v[:2] for k, v in got.items()}, seq0, want)
    events = got["port"][2]
    assert events == got["ref"][2]
    assert any(e[:3] == ("degrade", "single", "ext") for e in events)
    assert any(e[0] == "ext-block" for e in events)


def test_ladder_drops_ext_without_edges_path(tmp_path, ext_env):
    path, tail, head, seq0, want = _graph_file(tmp_path, seed=2)
    for edges_path in (None, str(tmp_path / "g.net")):
        got = {name: _resilient(name, tail, head, ladder=("ext", "host"),
                                edges_path=edges_path) for name in SIDES}
        _same_forest({k: v[:2] for k, v in got.items()}, seq0, want)
        assert got["port"][2] == got["ref"][2]
        assert not any(e[0] == "ext-block" for e in got["port"][2])


def test_spill_rung_shares_block_prefetcher(tmp_path, ext_env,
                                            monkeypatch):
    """The spill rung's memmap blocks arrive through the same async
    prefetcher as the ext stream, parity intact."""
    import sheep_tpu_torch.io.prefetch as prefetch_mod
    import sheep_tpu_torch.resources.governor as gov_mod
    path, tail, head, seq0, want = _graph_file(tmp_path, seed=4)
    monkeypatch.setattr(gov_mod, "SPILL_BLOCK", 509)
    made = {"n": 0}
    real = prefetch_mod.BlockPrefetcher

    class Counting(real):
        def __init__(self, *a, **kw):
            made["n"] += 1
            super().__init__(*a, **kw)

    monkeypatch.setattr(prefetch_mod, "BlockPrefetcher", Counting)
    seq, f, events = _resilient("port", tail, head, ladder=("spill",))
    assert made["n"] == 1
    assert sum(1 for e in events if e[0] == "spill-block") > 1
    np.testing.assert_array_equal(f.parent, want.parent)
    np.testing.assert_array_equal(f.pst_weight, want.pst_weight)


def test_should_use_extmem_routing(tmp_path, ext_env):
    import sheep_tpu.resources.governor as ref_gov
    import sheep_tpu_torch.resources.governor as gov_mod
    path, tail, head, _, _ = _graph_file(tmp_path)
    net = str(tmp_path / "g.net")
    cases = [(path, {}, None, False), (net, {}, None, False),
             (path, {"SHEEP_EXT_BLOCK": "1024"}, None, True),
             (net, {"SHEEP_EXT_BLOCK": "1024"}, None, False),
             (path, {}, 1, True), (path, {}, 1 << 40, False),
             (str(tmp_path / "missing.dat"), {}, 1, False)]
    for p, env, budget, want in cases:
        for k, v in env.items():
            ext_env.setenv(k, v)
        got = port_ext.should_use_extmem(
            p, gov_mod.ResourceGovernor(mem_budget=budget)
            if budget else None)
        ref = ref_ext.should_use_extmem(
            p, ref_gov.ResourceGovernor(mem_budget=budget)
            if budget else None)
        assert got == ref == want, (p, env, budget)
        for k in env:
            ext_env.delenv(k)
    assert port_ext.dat_num_records(path) == ref_ext.dat_num_records(path)


def test_cli_ext_tree_identical(tmp_path, ext_env):
    """graph2tree under SHEEP_EXT_BLOCK writes the in-RAM run's .tre, and
    the reference's bytes (sidecar included)."""
    from sheep_tpu.cli.graph2tree import main as ref_main
    from sheep_tpu_torch.cli.graph2tree import main
    from sheep_tpu_torch.io.trefile import read_tree
    path, tail, head, _, want = _graph_file(tmp_path, seed=6)
    assert main([path, "-o", str(tmp_path / "ram.tre")], device="cpu") == 0
    ext_env.setenv("SHEEP_EXT_BLOCK", "600")
    assert main([path, "-o", str(tmp_path / "ext.tre")], device="cpu") == 0
    assert ref_main([path, "-o", str(tmp_path / "ref.tre")]) == 0
    a = read_tree(str(tmp_path / "ram.tre"))
    b = read_tree(str(tmp_path / "ext.tre"))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(b[0], want.parent)
    for suffix in ("", ".sum"):
        assert open(tmp_path / f"ext.tre{suffix}", "rb").read() == \
            open(tmp_path / f"ref.tre{suffix}", "rb").read()


# ---------------------------------------------------------------------------
# BlockPrefetcher unit contract
# ---------------------------------------------------------------------------


def test_prefetcher_preserves_order_and_counts():
    from sheep_tpu_torch.io.prefetch import BlockPrefetcher
    items = list(range(57))
    with BlockPrefetcher(iter(items), depth=3) as pf:
        assert list(pf) == items
    assert pf.blocks == len(items)


def test_prefetcher_bounded_lead():
    """The producer never runs more than ``depth`` blocks ahead of the
    consumer: that bound IS the O(depth x block) residency promise."""
    import time

    from sheep_tpu_torch.io.prefetch import BlockPrefetcher
    lead = {"max": 0}
    consumed = {"n": 0}

    def produce():
        for i in range(40):
            lead["max"] = max(lead["max"], i - consumed["n"])
            yield i

    with BlockPrefetcher(produce(), depth=2) as pf:
        for _ in pf:
            time.sleep(0.001)
            consumed["n"] += 1
    assert lead["max"] <= 3, lead


def test_prefetcher_propagates_typed_errors():
    from sheep_tpu_torch.io.prefetch import BlockPrefetcher

    def produce():
        yield 1
        yield 2
        raise OSError(5, "sick disk")

    got = []
    with pytest.raises(OSError, match="sick disk"):
        with BlockPrefetcher(produce()) as pf:
            for x in pf:
                got.append(x)
    assert got == [1, 2]


def test_prefetcher_close_releases_producer():
    from sheep_tpu_torch.io.prefetch import BlockPrefetcher

    def produce():
        i = 0
        while True:
            yield i
            i += 1

    pf = BlockPrefetcher(produce(), depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
