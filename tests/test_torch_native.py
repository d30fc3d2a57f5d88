"""The port's native host runtime (sheep_tpu_torch.native,
csrc/sheep_native.cpp) equals the reference's (sheep_tpu.native) kernel
for kernel, under the same environment and on the same seeded inputs, and
the python oracle where one exists: the histograms, both degree sorts,
the edge-to-link map, the fused, monolithic and resumable folds (blocked
on and off, 1 to 8 threads), the forward partition, FENNEL and the
evaluator's block.  It also pins the thread-count fault: the port's C++
reads SHEEP_NATIVE_THREADS / _OVERSUB / _THREAD_FLOOR as the reference's
does, and the count the runtime driver records is the count its fold
uses.
"""

import os
import threading

import numpy as np
import pytest

from conftest import random_multigraph

from sheep_tpu import native as ref_native
from sheep_tpu.core import forest as RF
from sheep_tpu.core import sequence as RS
from sheep_tpu.partition import tree_partition as RT
from sheep_tpu.utils import rmat_edges

from sheep_tpu_torch import native
from sheep_tpu_torch.core import forest as PF
from sheep_tpu_torch.core import sequence as PS

THREAD_KNOBS = ("SHEEP_NATIVE_THREADS", "SHEEP_NATIVE_OVERSUB",
                "SHEEP_NATIVE_THREAD_FLOOR", "SHEEP_NATIVE_BLOCKED",
                "SHEEP_LEG_CORES", "SHEEP_MEM_BUDGET")


@pytest.fixture
def thread_env(monkeypatch):
    """Floor 0 engages the threaded paths on test-sized inputs; OVERSUB
    lets a forced count exceed the granted cores."""
    for k in THREAD_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHEEP_NATIVE_THREAD_FLOOR", "0")
    monkeypatch.setenv("SHEEP_NATIVE_OVERSUB", "1")
    yield monkeypatch


def _eq(a, b):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _eq_pair(got, want):
    for g, w in zip(got, want):
        _eq(g, w)


def _graph(seed, log_n=11, factor=6):
    return rmat_edges(log_n, factor * (1 << log_n), seed=seed)


def test_library_builds_under_its_own_name_and_reports_openmp():
    """The port's library lives in sheep_tpu_torch/_build under its own
    file name, apart from the reference's, and both load side by side."""
    lib = native.load_library()
    assert os.path.basename(lib._name) == native.LIB_NAME
    assert os.path.basename(lib._name) != "libsheep_native.so"
    assert os.path.dirname(lib._name).endswith(
        os.path.join("sheep_tpu_torch", "_build"))
    assert ref_native.available() and native.available()
    assert native.omp_compiled() == ref_native.omp_compiled()
    assert native.omp_max_threads() >= 1


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    from sheep_tpu_torch import buildlib
    monkeypatch.setattr(buildlib, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "broken.cpp").write_text("int main( {\n")
    with pytest.raises(RuntimeError, match="build of broken.cpp failed"):
        buildlib.build_shared("broken.cpp", "libbroken.so",
                              native._command)
    assert not os.path.exists(tmp_path / "_build" / "libbroken.so")


# ---------------------------------------------------------------------------
# fault 3.1: the thread knobs have a reader, the same as the reference's
# ---------------------------------------------------------------------------

_ENVS = [
    {},
    {"SHEEP_NATIVE_THREADS": "1"},
    {"SHEEP_NATIVE_THREADS": "4"},
    {"SHEEP_NATIVE_THREADS": "4", "SHEEP_NATIVE_OVERSUB": "1"},
    {"SHEEP_NATIVE_THREADS": "64", "SHEEP_NATIVE_OVERSUB": "1"},
    {"SHEEP_NATIVE_THREADS": "64"},
    {"SHEEP_NATIVE_THREADS": "3", "SHEEP_NATIVE_THREAD_FLOOR": "0",
     "SHEEP_NATIVE_OVERSUB": "1"},
    {"SHEEP_NATIVE_THREADS": "8", "SHEEP_NATIVE_THREAD_FLOOR": "5000",
     "SHEEP_NATIVE_OVERSUB": "1"},
]


@pytest.mark.parametrize("env", _ENVS, ids=lambda e: ",".join(
    f"{k[13:]}={v}" for k, v in e.items()) or "unset")
def test_thread_resolution_equals_reference(env, monkeypatch):
    """Under the same environment the port's resolve_threads() and
    threads_for(m) equal the reference's, for m on both sides of the
    engagement floor (2^15 by default) and of the per-slice work gate."""
    for k in THREAD_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert native.resolve_threads() == ref_native.resolve_threads()
    for m in (0, 100, 255, 1000, 4999, 5000, (1 << 15) - 1, 1 << 15,
              1 << 20):
        assert native.threads_for(m) == ref_native.threads_for(m), m
    if env.get("SHEEP_NATIVE_OVERSUB") == "1":
        want = min(64, int(env["SHEEP_NATIVE_THREADS"]))
        assert native.resolve_threads() == want


@pytest.mark.parametrize("pinned", [True, False])
def test_driver_thread_event_names_the_count_the_fold_used(
        tmp_path, thread_env, pinned):
    """The runtime driver's ``native-threads`` event names a count that
    the host rung's fold then really used (the ``threads`` field of its
    native.build_forest span): pinned by the operator, or planned from a
    leg-cores budget and exported by the driver for the fold to read."""
    from sheep_tpu_torch.obs import trace as obs_trace
    from sheep_tpu_torch.runtime import RuntimeConfig, build_graph_resilient
    import sheep_tpu_torch.utils.envinfo as envinfo

    if pinned:
        thread_env.setenv("SHEEP_NATIVE_THREADS", "4")
        want = 4
    else:
        thread_env.setattr(envinfo, "effective_cores", lambda root=None: 8)
        thread_env.setenv("SHEEP_LEG_CORES", "3")
        want = 3
    tail, head = _graph(4, log_n=9)
    tpath = str(tmp_path / "t.trace")
    thread_env.setenv(obs_trace.ENV, tpath)
    cfg = RuntimeConfig(ladder=("host",))
    try:
        seq, forest = build_graph_resilient(tail, head, config=cfg,
                                            device="cpu")
    finally:
        obs_trace.close_recorder()
    events = [e for e in cfg.events if e[0] == "native-threads"]
    assert events and events[0][1] == want, cfg.events
    records, _, _ = obs_trace.read_trace(tpath, "strict")
    folds = [r.get("a", {}) for r in records if r.get("k") == "span"
             and r.get("name") == "native.build_forest"]
    assert folds and all(a.get("threads") == want for a in folds), folds
    assert all(len(a.get("thread_busy_s", [])) == want for a in folds)
    # the driver restored the environment after the rung
    assert ("SHEEP_NATIVE_THREADS" in os.environ) == pinned
    want_f = RF.build_forest(tail, head, seq, impl="python")
    _eq_pair((forest.parent, forest.pst_weight),
             (want_f.parent, want_f.pst_weight))


@pytest.mark.parametrize("blocked", ["1", "0"])
@pytest.mark.parametrize("log_n", [11, 18])
def test_threaded_fold_bit_equal_to_serial_and_reference(thread_env, blocked,
                                                         log_n):
    """SHEEP_NATIVE_THREADS=4 with SHEEP_NATIVE_OVERSUB=1: parent and pst
    of the links fold and the fused edges fold equal the single-thread
    fold and the reference's, and last_thread_stats says 4 threads ran.
    log_n 18 takes the blocked path (n and links past 2^16), 11 the
    plain one."""
    thread_env.setenv("SHEEP_NATIVE_BLOCKED", blocked)
    tail, head = _graph(7, log_n=log_n, factor=4)
    seq = RS.degree_sequence(tail, head)
    n = len(seq)
    pos = RS.sequence_positions(seq, int(max(tail.max(), head.max())))
    lo, hi = ref_native.edges_to_links(tail, head, pos)
    serial_links = native.build_forest_links(lo, hi, n)
    serial_edges = native.build_forest_edges(tail, head, pos, n)
    assert native.last_thread_stats()[0] == 1
    _eq_pair(serial_links, serial_edges)
    thread_env.setenv("SHEEP_NATIVE_THREADS", "4")
    got = native.build_forest_links(lo, hi, n)
    used, busy = native.last_thread_stats()
    assert used == 4 and len(busy) == 4
    _eq_pair(got, serial_links)
    _eq_pair(got, ref_native.build_forest_links(lo, hi, n))
    got = native.build_forest_edges(tail, head, pos, n)
    assert native.last_thread_stats()[0] == 4
    _eq_pair(got, serial_links)
    _eq_pair(got, ref_native.build_forest_edges(tail, head, pos, n))


_NO_TORCH_PROG = """\
import json, os, sys
import numpy as np
from sheep_tpu_torch import native
from sheep_tpu_torch.core import sequence as PS
from sheep_tpu_torch.utils import rmat_edges
tail, head = rmat_edges(18, 4 << 18, seed=7)
seq = PS.degree_sequence(tail, head)
pos = PS.sequence_positions(seq, int(max(tail.max(), head.max())))
lo, hi = native.edges_to_links(tail, head, pos)
out = {}
for t in ("1", "4"):
    os.environ["SHEEP_NATIVE_THREADS"] = t
    parent, pst = native.build_forest_links(lo, hi, len(seq))
    out[t] = {"used": native.last_thread_stats()[0],
              "parent": int(parent.astype(np.uint64).sum()),
              "pst": int(pst.astype(np.uint64).sum())}
maps = open("/proc/self/maps").read()
out["gomp"] = sorted({ln.split()[-1] for ln in maps.splitlines()
                      if "gomp" in ln})
out["torch"] = "torch" in sys.modules
print(json.dumps(out))
"""


def test_threaded_fold_in_a_process_without_torch(thread_env):
    """A process that never loads torch (the host routes) binds the
    library to the system's OpenMP runtime, not torch's: the threaded
    fold still runs 4 threads and gives the serial fold's result, and
    the same result as in this process, which loaded torch."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH_PROG],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["torch"] is False
    if native.omp_compiled():
        assert got["4"]["used"] == 4
    assert got["1"]["used"] == 1
    assert {k: v for k, v in got["4"].items() if k != "used"} == \
        {k: v for k, v in got["1"].items() if k != "used"}
    tail, head = _graph(7, log_n=18, factor=4)
    seq = PS.degree_sequence(tail, head)
    pos = PS.sequence_positions(seq, int(max(tail.max(), head.max())))
    lo, hi = native.edges_to_links(tail, head, pos)
    thread_env.setenv("SHEEP_NATIVE_THREADS", "4")
    parent, pst = native.build_forest_links(lo, hi, len(seq))
    assert int(parent.astype(np.uint64).sum()) == got["4"]["parent"]
    assert int(pst.astype(np.uint64).sum()) == got["4"]["pst"]


# ---------------------------------------------------------------------------
# histograms and degree sorts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("seed", range(4))
def test_histograms_match_reference(thread_env, seed, threads):
    thread_env.setenv("SHEEP_NATIVE_THREADS", threads)
    rng = np.random.default_rng(7000 + seed)
    tail, head = random_multigraph(rng, n_max=400, e_max=3000)
    n = int(max(tail.max(), head.max())) + 1 + seed
    deg = native.degree_histogram(tail, head, n)
    _eq(deg, ref_native.degree_histogram(tail, head, n))
    _eq(deg, (np.bincount(tail, minlength=n)
              + np.bincount(head, minlength=n)).astype(np.int64))
    half = len(tail) // 2
    acc, ref_acc = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for a, b in ((0, half), (half, len(tail))):
        native.degree_histogram_acc(tail[a:b], head[a:b], acc)
        ref_native.degree_histogram_acc(tail[a:b], head[a:b], ref_acc)
    _eq(acc, ref_acc)
    _eq(acc, deg)
    _eq(PS.host_degree_histogram(tail, head, n),
        RS.host_degree_histogram(tail, head, n))


@pytest.mark.parametrize("threads", ["1", "4"])
def test_bad_vid_raises_like_reference(thread_env, threads):
    """rc -3 on a vid >= n is a ValueError in both packages, for the
    histogram, its accumulating form and the fused sort."""
    thread_env.setenv("SHEEP_NATIVE_THREADS", threads)
    tail = np.repeat(np.array([0, 1, 99], np.uint32), 400)
    head = np.repeat(np.array([1, 2, 3], np.uint32), 400)
    for mod in (native, ref_native):
        with pytest.raises(ValueError, match="out of range"):
            mod.degree_histogram(tail, head, 50)
        with pytest.raises(ValueError, match="out of range"):
            mod.degree_histogram_acc(tail, head, np.zeros(50, np.int64))
        with pytest.raises(ValueError, match="out of range"):
            mod.degree_sequence_from_edges(tail, head, 50)


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("seed", range(4))
def test_degree_sorts_match_reference(thread_env, seed, threads):
    """The fused sort and the counting sort equal the reference's kernels
    and its python order; core.sequence equals core.sequence."""
    thread_env.setenv("SHEEP_NATIVE_THREADS", threads)
    tail, head = _graph(100 + seed, log_n=10)
    n = int(max(tail.max(), head.max())) + 1
    want = RS.degree_sequence_from_degrees(
        RS.host_degree_histogram(tail, head, n), impl="python")
    _eq(native.degree_sequence_from_edges(tail, head, n), want)
    _eq(ref_native.degree_sequence_from_edges(tail, head, n), want)
    deg = native.degree_histogram(tail, head, n)
    _eq(native.degree_sequence_from_degrees(deg), want)
    _eq(PS.degree_sequence_from_degrees(deg), want)
    _eq(PS.degree_sequence_from_degrees(deg, impl="python"), want)
    _eq(PS.degree_sequence(tail, head), RS.degree_sequence(tail, head))
    thread_env.setenv("SHEEP_NATIVE_BLOCKED", "0")  # the two-call path
    _eq(PS.degree_sequence(tail, head), want)


def test_counting_sort_gives_up_and_numpy_takes_over():
    """A multigraph hub past max(4n, 2^20) degrees: both counting sorts
    return None in both packages, and core.sequence falls through to the
    numpy order exactly as the reference does."""
    loops = (1 << 19) + 7  # a self-loop adds 2: degree > 2^20
    tail = np.concatenate([np.full(loops, 3, np.uint32),
                           np.array([0, 1, 5, 2], np.uint32)])
    head = np.concatenate([np.full(loops, 3, np.uint32),
                           np.array([1, 2, 4, 5], np.uint32)])
    n = 6
    deg = native.degree_histogram(tail, head, n)
    assert int(deg.max()) > max(4 * n, 1 << 20)
    for mod in (native, ref_native):
        assert mod.degree_sequence_from_degrees(deg) is None
        assert mod.degree_sequence_from_edges(tail, head, n) is None
    seq = PS.degree_sequence(tail, head)
    _eq(seq, RS.degree_sequence(tail, head))
    _eq(seq, np.array([0, 4, 1, 2, 5, 3], np.uint32))
    _eq(PS.degree_sequence_from_degrees(deg),
        RS.degree_sequence_from_degrees(deg, impl="python"))


# ---------------------------------------------------------------------------
# edge map and folds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_edges_to_links_matches_reference(seed):
    rng = np.random.default_rng(7100 + seed)
    tail, head = random_multigraph(rng, n_max=300, e_max=2000)
    seq = RS.degree_sequence(tail, head)
    seq = seq[: max(2, len(seq) * 3 // 4)]  # absent vids: pst-only links
    pos = RS.sequence_positions(seq, int(max(tail.max(), head.max())) - 1)
    got = native.edges_to_links(tail, head, pos)
    _eq_pair(got, ref_native.edges_to_links(tail, head, pos))
    lo, hi = RF.edges_to_positions(tail, head, seq)
    np.testing.assert_array_equal(got[0].astype(np.int64), lo)
    np.testing.assert_array_equal(got[1].astype(np.int64), hi)


@pytest.mark.parametrize("threads", ["1", "2", "4"])
@pytest.mark.parametrize("blocked", ["1", "0"])
@pytest.mark.parametrize("seed", range(3))
def test_build_forest_edges_matches_reference_and_oracle(thread_env, seed,
                                                         blocked, threads):
    """Small random multigraphs with absent vids: the fused build, the
    two-call build and core.build_forest equal the reference's native
    kernels and its python oracle, blocked on and off, on 1, 2 and 4
    threads."""
    thread_env.setenv("SHEEP_NATIVE_BLOCKED", blocked)
    thread_env.setenv("SHEEP_NATIVE_THREADS", threads)
    rng = np.random.default_rng(7200 + seed)
    tail, head = random_multigraph(rng, n_max=500, e_max=4000)
    seq = RS.degree_sequence(tail, head)
    seq = seq[: max(2, len(seq) * 2 // 3)]
    mv = int(max(tail.max(), head.max()))
    pos = RS.sequence_positions(seq, mv)
    n = len(seq)
    want = RF.build_forest(tail, head, seq, max_vid=mv, impl="python")
    want = (want.parent, want.pst_weight)
    _eq_pair(native.build_forest_edges(tail, head, pos, n), want)
    _eq_pair(ref_native.build_forest_edges(tail, head, pos, n), want)
    lo, hi = native.edges_to_links(tail, head, pos)
    _eq_pair(native.build_forest_links(lo, hi, n), want)
    got = PF.build_forest(tail, head, seq, max_vid=mv)
    _eq_pair((got.parent, got.pst_weight), want)


@pytest.mark.parametrize("log_n", [15, 16, 18])
def test_blocked_boundary_both_sides(thread_env, log_n):
    """use_blocked switches at n > 2^16 and links > 2^16: below (2^15,
    2^16 exactly) and past it (2^18), blocked on, off and threaded equal
    the reference's fold."""
    tail, head = _graph(11, log_n=log_n, factor=4)
    seq = RS.degree_sequence(tail, head)
    pos = RS.sequence_positions(seq, (1 << log_n) - 1)
    n = len(seq)
    want = ref_native.build_forest_edges(tail, head, pos, n)
    for blocked, threads in (("1", "1"), ("0", "1"), ("1", "4"),
                             ("0", "4")):
        thread_env.setenv("SHEEP_NATIVE_BLOCKED", blocked)
        thread_env.setenv("SHEEP_NATIVE_THREADS", threads)
        _eq_pair(native.build_forest_edges(tail, head, pos, n), want)
        got = PF.build_forest(tail, head, seq, max_vid=(1 << log_n) - 1)
        _eq_pair((got.parent, got.pst_weight), want)


def _sorted_windows(tail, head, seq, k):
    n = len(seq)
    lo, hi = RF.edges_to_positions(tail, head, seq)
    linked = hi < n
    order = np.argsort(hi[linked], kind="stable")
    lo_s, hi_s = lo[linked][order], hi[linked][order]
    cuts = np.linspace(0, len(lo_s), k + 1).astype(int)
    wins = [(lo_s[a:b], hi_s[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    # pst-only links ride in the first window
    wins[0] = (np.concatenate([lo[~linked], wins[0][0]]),
               np.concatenate([hi[~linked], wins[0][1]]))
    return lo, hi, wins


@pytest.mark.parametrize("threads", ["1", "4", "8"])
def test_resumable_fold_across_thread_counts(thread_env, threads):
    """The windowed fold under 1, 4 and 8 threads equals the reference's
    native LinksFold and its python twin window for window."""
    tail, head = _graph(3)
    seq = RS.degree_sequence(tail, head)
    n = len(seq)
    lo, hi, wins = _sorted_windows(tail, head, seq, 4)
    oracle = RF.PyLinksFold(n)
    oracle.block(lo, hi)
    want = oracle.finish()
    thread_env.setenv("SHEEP_NATIVE_THREADS", threads)
    for fold in (native.LinksFold(n), PF.links_fold(n),
                 PF.links_fold(n, impl="python"), ref_native.LinksFold(n)):
        for wl, wh in wins:
            fold.block(wl, wh)
        _eq_pair(fold.finish(), want)


def test_threaded_fold_on_another_python_thread(thread_env):
    """A threaded block folded from a non-main Python thread (as the
    streamed handoff's fetch runs beside it) gives the same forest, and
    the thread stats belong to the calling thread."""
    tail, head = _graph(5)
    seq = RS.degree_sequence(tail, head)
    n = len(seq)
    lo, hi, wins = _sorted_windows(tail, head, seq, 3)
    want = ref_native.build_forest_links(lo, hi, n)
    thread_env.setenv("SHEEP_NATIVE_THREADS", "4")
    fold = native.LinksFold(n)
    seen = []

    def run():
        for wl, wh in wins:
            fold.block(wl, wh)
            seen.append(native.last_thread_stats()[0])

    worker = threading.Thread(target=run)
    worker.start()
    thread_env.setenv("SHEEP_NATIVE_THREADS", "4")
    native.degree_histogram(np.zeros(4, np.uint32), np.ones(4, np.uint32), 2)
    worker.join()
    _eq_pair(fold.finish(), want)
    assert seen == [4, 4, 4]
    # the main thread's last call (4 records, under the 256-per-thread
    # work gate) ran serial: its stats are its own
    assert native.last_thread_stats()[0] == 1


@pytest.mark.parametrize("seed", range(3))
def test_pre_weights_match_reference(seed):
    rng = np.random.default_rng(7300 + seed)
    tail, head = random_multigraph(rng, n_max=200, e_max=1500)
    seq = RS.degree_sequence(tail, head)
    want = RF.pre_weights(tail, head, seq, impl="python")
    _eq(PF.pre_weights(tail, head, seq), want)
    _eq(PF.pre_weights(tail, head, seq, impl="python"), want)
    n = len(seq)
    pos = RS.sequence_positions(seq)
    _eq(native.build_forest_edges(tail, head, pos, n, compute_pre=True)[2],
        ref_native.build_forest_edges(tail, head, pos, n,
                                      compute_pre=True)[2])


# ---------------------------------------------------------------------------
# forward partition, FENNEL, the evaluator's block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_forward_partition_matches_reference(seed):
    tail, head = _graph(200 + seed, log_n=10, factor=4)
    seq = RS.degree_sequence(tail, head)
    forest = RF.build_forest(tail, head, seq)
    w = RT.node_weights(forest, RT.TreePartitionOptions())
    for parts in (2, 3, 7, 64):
        mc = int((int(w.sum()) // parts) * 1.03)
        got = native.forward_partition(forest.parent, w, mc)
        _eq(got, ref_native.forward_partition(forest.parent, w, mc))
        np.testing.assert_array_equal(
            got, RT.forward_partition(forest, mc, w))


def test_forward_partition_errors_match_reference():
    parent = np.array([1, 0xFFFFFFFF], np.uint32)
    w = np.array([100, 1], np.int64)
    for mod in (native, ref_native):
        with pytest.raises(ValueError, match="heaviest node"):
            mod.forward_partition(parent, w, 10)
        with pytest.raises(ValueError, match="corrupt"):
            mod.forward_partition(np.array([1, 7, 0xFFFFFFFF], np.uint32),
                                  np.ones(3, np.int64), 10)


@pytest.mark.parametrize("num_parts,eb", [(2, True), (5, False), (70, True)])
def test_fennel_kernels_match_reference(num_parts, eb):
    rng = np.random.default_rng(7400 + num_parts)
    tail, head = random_multigraph(rng, n_max=300, e_max=1500)
    nv = int(max(tail.max(), head.max())) + 3
    _eq(native.fennel_vertex(tail, head, nv, num_parts, 1.03, eb),
        ref_native.fennel_vertex(tail, head, nv, num_parts, 1.03, eb))
    _eq(native.fennel_edges(tail, head, nv, num_parts, 1.1),
        ref_native.fennel_edges(tail, head, nv, num_parts, 1.1))
    bad = np.array([nv], np.uint32)
    for mod in (native, ref_native):
        with pytest.raises(ValueError):
            mod.fennel_vertex(bad, bad, nv, 2, 1.03, True)


def _eval_state(n, P, with_pos):
    z = lambda dt, k=n: np.zeros(k, dt)  # noqa: E731
    return [z(np.uint64), z(np.uint64),
            z(np.uint64) if with_pos else None,
            z(np.uint64) if with_pos else None,
            z(np.uint8), z(np.int64, P), z(np.int64, P), z(np.int64, P)]


@pytest.mark.parametrize("with_pos", [True, False])
@pytest.mark.parametrize("w0", [0, 64])
def test_eval_block_matches_reference(with_pos, w0):
    rng = np.random.default_rng(7500 + w0)
    tail, head = random_multigraph(rng, n_max=300, e_max=3000)
    n = int(max(tail.max(), head.max())) + 1
    P = 100
    parts = rng.integers(0, P, n).astype(np.int64)
    seq = RS.degree_sequence(tail, head)
    pos = RS.sequence_positions(seq, n - 1) if with_pos else None
    states = [_eval_state(n, P, with_pos) for _ in range(2)]
    cuts = [mod.eval_block(tail, head, parts, pos, w0, w0 == 0, *st[:5],
                           *st[5:], P)
            for mod, st in zip((native, ref_native), states)]
    assert cuts[0] == cuts[1]
    for a, b in zip(*states):
        if a is not None:
            _eq(a, b)
    with pytest.raises(ValueError, match="out of range"):
        native.eval_block(np.array([n], np.uint32), np.array([0], np.uint32),
                          parts, pos, w0, True, *states[0][:5],
                          *states[0][5:], P)
