"""The port's copies of the host layers the fault-tolerant build stands on
(sheep_tpu_torch integrity/, io/atomic.py + io/faultfs.py, io/prefetch.py,
resources/, plan/, obs/trace.py, core/validate.py) against the
reference's modules, on the same inputs.

Each case runs the reference and the port side by side and compares what
they return or write: sidecar seal/verify under each integrity policy,
the atomic writer under injected write faults, the planner's rung
availability and plan, the governor's arithmetic, the fast forest
oracle on good and corrupted forests, the trace's write/read round trip,
and the prefetcher's order and error surface.
"""

import os
import warnings

import numpy as np
import pytest

import sheep_tpu.core.validate as ref_validate
import sheep_tpu.integrity.errors as ref_errors
import sheep_tpu.integrity.sidecar as ref_sidecar
import sheep_tpu.io.atomic as ref_atomic
import sheep_tpu.io.faultfs as ref_faultfs
import sheep_tpu.plan.model as ref_model
import sheep_tpu.resources.governor as ref_gov
from sheep_tpu.core.forest import Forest as RefForest
from sheep_tpu.core.forest import build_forest as ref_build_forest
from sheep_tpu.core.sequence import degree_sequence
from sheep_tpu.utils.synth import rmat_edges

import sheep_tpu_torch.core.validate as port_validate
import sheep_tpu_torch.integrity.errors as port_errors
import sheep_tpu_torch.integrity.sidecar as port_sidecar
import sheep_tpu_torch.io.atomic as port_atomic
import sheep_tpu_torch.io.faultfs as port_faultfs
import sheep_tpu_torch.plan.model as port_model
import sheep_tpu_torch.resources.governor as port_gov
from sheep_tpu_torch.core.forest import Forest

SIDES = {"ref": (ref_sidecar, ref_atomic, ref_faultfs, ref_errors),
         "port": (port_sidecar, port_atomic, port_faultfs, port_errors)}


@pytest.fixture(autouse=True)
def _clean_io_faults():
    for mod in (ref_faultfs, port_faultfs):
        mod.clear_plan()
    yield
    for mod in (ref_faultfs, port_faultfs):
        mod.clear_plan()


# ---------------------------------------------------------------------------
# integrity: sidecars under each policy
# ---------------------------------------------------------------------------


def _seal(side, path, data):
    sidecar = SIDES[side][0]
    with sidecar.checksummed_write(str(path), "wb") as f:
        f.write(data)


@pytest.mark.parametrize("damage", ["none", "flip", "truncate",
                                    "no_sidecar"])
@pytest.mark.parametrize("policy", ["strict", "repair", "trust"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sidecar_verify_equals_reference(tmp_path, writer, policy, damage):
    """A sidecar either package seals, both verify alike: the same status,
    or the same exception class, under each policy and each damage."""
    path = tmp_path / "a.bin"
    data = bytes(range(256)) * 40
    _seal(writer, path, data)
    sc = open(str(path) + ".sum").read()
    assert sc.startswith("sheep-sum 1\n")
    if damage == "flip":
        raw = bytearray(path.read_bytes())
        raw[100] ^= 0x5A
        path.write_bytes(bytes(raw))
    elif damage == "truncate":
        path.write_bytes(data[:-7])
    elif damage == "no_sidecar":
        os.unlink(str(path) + ".sum")
    data = path.read_bytes()
    results = {}
    for side, (sidecar, _, _, errors) in SIDES.items():
        results[side] = [
            _outcome(errors, lambda: sidecar.verify_file(str(path), policy)),
            _outcome(errors, lambda: sidecar.verify_bytes(str(path), data,
                                                          policy))]
    assert results["port"] == results["ref"]
    want = {"none": "ok", "no_sidecar": "no-sidecar"}.get(
        damage, {"strict": "ChecksumMismatch",
                 "repair": "repair-mismatch"}.get(policy))
    if policy == "trust":
        want = "trusted"
    assert results["port"] == [want, want]


def _outcome(errors, fn):
    """A verify call's status, or the name of the IntegrityError it raised
    (a repair warning is recorded, not raised)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return fn()
        except errors.IntegrityError as exc:
            return type(exc).__name__


def test_sidecar_bytes_equal_reference(tmp_path):
    data = os.urandom(5000)
    for side in ("ref", "port"):
        _seal(side, tmp_path / f"{side}.bin", data)
    ref_sc = ref_sidecar.read_sidecar(str(tmp_path / "ref.bin"))
    port_sc = port_sidecar.read_sidecar(str(tmp_path / "port.bin"))
    assert port_sc == ref_sc


@pytest.mark.parametrize("mode", [None, "strict", "repair", "trust"])
def test_resolve_policy_equals_reference(monkeypatch, mode):
    monkeypatch.setenv("SHEEP_INTEGRITY", "repair")
    assert port_sidecar.resolve_policy(mode) == \
        ref_sidecar.resolve_policy(mode)


# ---------------------------------------------------------------------------
# io: the atomic writer under injected write faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["enospc", "eio", "short"])
@pytest.mark.parametrize("side", ["ref", "port"])
def test_atomic_write_fault_leaves_target_intact(tmp_path, side, kind):
    """An injected write fault at the checkpoint site aborts the publish:
    the old artifact and its sidecar stay, no temp is left, and the
    failure is the typed DiskExhausted/WriteFault."""
    sidecar, atomic, faultfs, _ = SIDES[side]
    path = tmp_path / "sheep-ckpt.npz"
    _seal(side, path, b"old complete data")
    old_sum = open(str(path) + ".sum").read()
    faultfs.install_plan(faultfs.parse_io_fault_plan(f"{kind}@ckpt:0"))
    with pytest.raises(OSError) as info:
        with sidecar.checksummed_write(str(path), "wb") as f:
            f.write(b"half a new file, never published")
    assert type(info.value).__name__ == \
        ("WriteFault" if kind == "eio" else "DiskExhausted")
    assert path.read_bytes() == b"old complete data"
    assert open(str(path) + ".sum").read() == old_sum
    assert sorted(os.listdir(tmp_path)) == ["sheep-ckpt.npz",
                                            "sheep-ckpt.npz.sum"]


def test_atomic_write_commits_and_cleans(tmp_path):
    path = tmp_path / "out.bin"
    with port_atomic.atomic_write(str(path), "wb") as f:
        f.write(b"hello")
    assert path.read_bytes() == b"hello"
    assert os.listdir(tmp_path) == ["out.bin"]


def test_atomic_write_exception_leaves_target_intact(tmp_path):
    path = tmp_path / "out.bin"
    path.write_bytes(b"old complete data")
    with pytest.raises(RuntimeError):
        with port_atomic.atomic_write(str(path), "wb") as f:
            f.write(b"half a new fi")
            raise RuntimeError("killed mid-write")
    assert path.read_bytes() == b"old complete data"
    assert os.listdir(tmp_path) == ["out.bin"]


@pytest.mark.parametrize("name", ["a.tre", "b.seq", "c.npz", "d.tre.sum",
                                  "e.bin", "f.a3.tre"])
def test_fault_sites_equal_reference(name):
    assert port_faultfs.site_for(name) == ref_faultfs.site_for(name)


# ---------------------------------------------------------------------------
# resources: the governor's arithmetic, retention GC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "", "123", "4k", "1.5G", "64MiB",
                                  "2t"])
def test_parse_size_equals_reference(spec):
    assert _result(port_gov.parse_size, spec) == \
        _result(ref_gov.parse_size, spec)


def _result(fn, *args):
    """``fn(*args)``, or the name of the exception it raised."""
    try:
        return fn(*args)
    except Exception as exc:
        return type(exc).__name__


@pytest.mark.parametrize("rung", ["single", "host", "stream", "spill"])
@pytest.mark.parametrize("n, links", [(1 << 9, 1500), (1 << 20, 7 << 20),
                                      (1 << 23, 1 << 26)])
def test_rung_prices_equal_reference(rung, n, links):
    assert port_gov.rung_peak_nbytes(rung, n, links, 1) == \
        ref_gov.rung_peak_nbytes(rung, n, links, 1)
    assert port_gov.snapshot_nbytes(n, links) == \
        ref_gov.snapshot_nbytes(n, links)


@pytest.mark.parametrize("budget", [None, 1 << 30, 1 << 34])
def test_shrunk_levels_equal_reference(monkeypatch, budget):
    monkeypatch.setattr(ref_gov, "rss_bytes", lambda: 1 << 28)
    monkeypatch.setattr(port_gov, "rss_bytes", lambda: 1 << 28)
    ref = ref_gov.ResourceGovernor(mem_budget=budget)
    port = port_gov.ResourceGovernor(mem_budget=budget)
    for n in (1 << 10, 1 << 20, 1 << 23, 1 << 26):
        assert port.shrunk_levels(10, n) == ref.shrunk_levels(10, n)
    assert port.mem_pressure() == ref.mem_pressure()


def test_orphan_temps_swept(tmp_path):
    from sheep_tpu_torch.resources.gc import gc_orphan_temps

    (tmp_path / ".sheep-ckpt.npz.x1y2.tmp").write_bytes(b"debris")
    (tmp_path / "sheep-ckpt.npz").write_bytes(b"live")
    swept = gc_orphan_temps(str(tmp_path))
    assert [os.path.basename(p) for p in swept] == \
        [".sheep-ckpt.npz.x1y2.tmp"]
    assert os.listdir(tmp_path) == ["sheep-ckpt.npz"]


# ---------------------------------------------------------------------------
# plan: available_rungs, plan_build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ladder", [
    ("mesh", "single", "host", "stream", "ext", "spill"),
    ("single", "host"), ("host",), ("mesh", "host")])
@pytest.mark.parametrize("devices, workers", [(1, None), (8, None), (8, 1),
                                              (None, 2)])
@pytest.mark.parametrize("known", [None, ("single", "host", "stream",
                                          "spill")])
def test_available_rungs_equal_reference(ladder, devices, workers, known):
    # the port has no ext rung: it answers as the reference does for an
    # in-memory build (no whole-input .dat)
    assert port_model.available_rungs(ladder, devices, workers,
                                      known=known) == \
        ref_model.available_rungs(ladder, devices, workers, None,
                                  known=known)


@pytest.mark.parametrize("budget", [None, 1 << 24, 1 << 40])
@pytest.mark.parametrize("n, links", [(1 << 9, 1500), (1 << 23, 1 << 26)])
def test_plan_build_equals_reference(monkeypatch, budget, n, links):
    monkeypatch.delenv("SHEEP_PLAN_PRIORS", raising=False)
    rungs = ["single", "host", "stream", "spill"]
    kw = dict(rungs=rungs, ladder_forced=True, num_workers=None,
              assume_rss=1 << 27)
    ref = ref_model.plan_build(
        n, links, governor=ref_gov.ResourceGovernor(mem_budget=budget), **kw)
    port = port_model.plan_build(
        n, links, governor=port_gov.ResourceGovernor(mem_budget=budget),
        **kw)
    assert port.rungs == ref.rungs
    assert port.candidates == ref.candidates
    # the port makes the two decisions its driver reads, as the reference
    assert list(port.decisions) == ["native_threads", "rungs"]
    assert port.decisions_dict() == [ref.decision(k).to_dict()
                                     for k in port.decisions]
    assert port.native_threads == ref.native_threads
    assert port.headroom_bytes == ref.headroom_bytes


# ---------------------------------------------------------------------------
# core: the fast forest oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def forest_case():
    tail, head = rmat_edges(10, 6 << 10, seed=3)
    seq = degree_sequence(tail, head)
    return tail, head, seq, ref_build_forest(tail, head, seq)


@pytest.mark.parametrize("corrupt", ["none", "out_of_range", "cycle",
                                     "pst", "pst_length"])
def test_check_forest_fast_equals_reference(forest_case, corrupt):
    from sheep_tpu.core.forest import edges_to_positions

    tail, head, seq, good = forest_case
    parent = good.parent.copy()
    pst = good.pst_weight.copy()
    kids = np.nonzero(parent != 0xFFFFFFFF)[0]
    if corrupt == "out_of_range":
        parent[kids[3]] = len(parent) + 5
    elif corrupt == "cycle":
        parent[kids[-1]] = kids[-1] - 1 if kids[-1] else 0
    elif corrupt == "pst":
        pst[kids[0]] += 1
    elif corrupt == "pst_length":
        pst = pst[:-1]
    lo, hi = edges_to_positions(tail, head, seq)
    # with the links (a short pst makes both raise the same error)
    got = _result(port_validate.check_forest_fast, Forest(parent, pst), lo,
                  hi)
    assert got == _result(ref_validate.check_forest_fast,
                          RefForest(parent, pst), lo, hi)
    assert bool(got) is (corrupt != "none")
    assert port_validate.check_forest_fast(Forest(parent, pst)) == \
        ref_validate.check_forest_fast(RefForest(parent, pst))
    if corrupt in ("none", "cycle"):
        assert port_validate.is_valid_forest(
            Forest(parent, pst), tail, head, seq) == \
            ref_validate.is_valid_forest(RefForest(parent, pst), tail, head,
                                         seq) == (corrupt == "none")


def test_forest_links_equal_reference(forest_case):
    from sheep_tpu.core.forest import forest_links as ref_links
    from sheep_tpu_torch.core.forest import forest_links

    good = forest_case[3]
    for a, b in zip(forest_links(Forest(good.parent, good.pst_weight)),
                    ref_links(good)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# obs: the trace's write and read sides; io: the prefetcher
# ---------------------------------------------------------------------------


def test_trace_round_trip_reads_with_the_reference(tmp_path, monkeypatch):
    from sheep_tpu.obs.trace import read_trace as ref_read
    from sheep_tpu_torch.obs import trace

    path = str(tmp_path / "run.trace")
    monkeypatch.setenv("SHEEP_TRACE", path)
    with trace.span("rung", rung="single", links=7):
        trace.event("ladder.plan", rungs=["single", "host"], n=np.int64(9))
    trace.close_recorder()
    monkeypatch.delenv("SHEEP_TRACE")
    assert trace.span("x") is trace.span("y")  # disabled: the no-op
    recs, _, torn = trace.read_trace(path, "strict")
    assert not torn
    assert [r["k"] for r in recs] == ["meta", "ev", "span"]
    assert recs[1]["a"] == {"rungs": ["single", "host"], "n": 9}
    assert recs[2]["a"] == {"rung": "single", "links": 7}
    assert ref_read(path, "strict")[0] == recs
    assert port_sidecar.verify_file(path, "strict") == "ok"


@pytest.mark.parametrize("fail_at", [None, 3])
def test_prefetcher_order_and_error_surface(fail_at):
    from sheep_tpu_torch.io.prefetch import BlockPrefetcher

    class Boom(OSError):
        pass

    def blocks():
        for i in range(6):
            if i == fail_at:
                raise Boom("injected read fault")
            yield i

    got = []
    with BlockPrefetcher(blocks(), depth=2) as pf:
        if fail_at is None:
            got.extend(pf)
        else:
            with pytest.raises(Boom):
                for b in pf:
                    got.append(b)
    assert got == list(range(6 if fail_at is None else fail_at))


def test_env_capture_reports_no_jax_backend():
    from sheep_tpu_torch.utils.envinfo import effective_cores, env_capture

    cap = env_capture()
    assert cap["effective_cores"] == effective_cores() >= 1
    assert "XLA_FLAGS" not in cap.get("thread_env", {})
    assert env_capture(platform="cpu")["backend"] == "cpu"
