"""The port's treewidth mode (sheep_tpu_torch.core.jxn and the native
sheep_jxn_build) against the reference's (sheep_tpu.core.jxn), test for
test with tests/test_jxn.py and tests/test_treewidth_structured.py: the
port's python oracle and native insert against the reference's over the
same seeds and option sets, with exact equality of parent, pst, the
effective sequence, widths and the kids/pst/jxn tables."""

import numpy as np
import pytest

import sheep_tpu.core.jxn as ref_jxn
import sheep_tpu_torch.core.jxn as port_jxn
from sheep_tpu.core.forest import build_forest
from sheep_tpu.core.sequence import degree_sequence
from sheep_tpu_torch.core.validate import is_valid_forest

from conftest import random_multigraph

#: the option sets of tests/test_jxn.py's native-against-python sweep
OPTION_SETS = [
    dict(),
    dict(make_kids=True, make_pst=True, make_jxn=True),
    dict(make_kids=True, make_pst=True, make_jxn=True, width_limit=4),
    dict(make_kids=True, make_pst=True, make_jxn=True, width_limit=6,
         find_max_width=True),
    dict(make_kids=True, make_pst=True, make_jxn=True, do_rooting=True),
    dict(make_pst=True, width_limit=5),
    dict(make_pad=False, make_kids=True, make_jxn=True, width_limit=3),
]


def _trees(tail, head, seq, kw):
    return (ref_jxn.build_jxn_tree(tail, head, seq, ref_jxn.JxnOptions(**kw)),
            port_jxn.build_jxn_tree(tail, head, seq,
                                    port_jxn.JxnOptions(**kw)))


def _same_tree(ref, port):
    np.testing.assert_array_equal(port.forest.parent, ref.forest.parent)
    np.testing.assert_array_equal(port.forest.pst_weight,
                                  ref.forest.pst_weight)
    np.testing.assert_array_equal(port.seq, ref.seq)
    np.testing.assert_array_equal(port.widths, ref.widths)
    for name in ("kids", "pst", "jxn"):
        a, b = getattr(ref, name), getattr(port, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert len(a) == len(b)
            for x, y in zip(a, b):
                if x is None or y is None:
                    assert x is None and y is None
                else:
                    assert list(np.asarray(x)) == list(np.asarray(y))


def brute_force_fill(tail, head, seq):
    """Eliminate vertices in order; per-position fill neighborhoods."""
    n_vid = int(max(tail.max(initial=0), head.max(initial=0))) + 1
    adj = {v: set() for v in range(n_vid)}
    for t, h in zip(tail.tolist(), head.tolist()):
        if t != h:
            adj[t].add(h)
            adj[h].add(t)
    eliminated = set()
    jxns = []
    for v in seq.tolist():
        nbrs = adj[v] - eliminated
        jxns.append(sorted(nbrs))
        for a in nbrs:
            adj[a] |= nbrs - {a}
            adj[a].discard(a)
        eliminated.add(v)
    return jxns


@pytest.mark.parametrize("seed", range(10))
def test_jxn_matches_brute_force_and_reference(seed):
    rng = np.random.default_rng(seed)
    tail, head = random_multigraph(rng, n_max=30, e_max=90)
    seq = degree_sequence(tail, head)
    ref, port = _trees(tail, head, seq, dict(make_kids=True, make_pst=True,
                                             make_jxn=True))
    _same_tree(ref, port)
    expect = brute_force_fill(tail, head, seq)
    assert [j.tolist() for j in port.jxn] == expect


@pytest.mark.parametrize("seed", range(10))
def test_jxn_forest_matches_default_path(seed):
    rng = np.random.default_rng(100 + seed)
    tail, head = random_multigraph(rng)
    seq = degree_sequence(tail, head)
    ref, port = _trees(tail, head, seq, dict(make_kids=True, make_pst=True,
                                             make_jxn=True))
    _same_tree(ref, port)
    want = build_forest(tail, head, seq, impl="python")
    np.testing.assert_array_equal(port.forest.parent, want.parent)
    np.testing.assert_array_equal(port.forest.pst_weight, want.pst_weight)
    np.testing.assert_array_equal(port.seq, seq)


@pytest.mark.parametrize("seed", range(8))
def test_width_limit_defers_and_stays_valid(seed):
    rng = np.random.default_rng(200 + seed)
    tail, head = random_multigraph(rng, n_max=30, e_max=120,
                                   self_loops=False)
    seq = degree_sequence(tail, head)
    ref, tree = _trees(tail, head, seq, dict(make_kids=True, make_pst=True,
                                             make_jxn=True, width_limit=3))
    _same_tree(ref, tree)
    assert sorted(tree.seq.tolist()) == sorted(seq.tolist())
    assert is_valid_forest(tree.forest, tail, head, tree.seq,
                           max_vid=int(max(tail.max(), head.max())))
    widths = tree.widths
    for i in range(tree.forest.n):
        is_tail = len(tree.jxn[i]) > 0 and \
            set(tree.jxn[i].tolist()) == set(tree.seq[i + 1:].tolist())
        if not is_tail:
            assert widths[i] <= 1 + 3


def test_find_max_width_stops_early():
    rng = np.random.default_rng(7)
    tail, head = random_multigraph(rng, n_max=25, e_max=60, self_loops=False)
    seq = degree_sequence(tail, head)
    full = dict(make_kids=True, make_pst=True, make_jxn=True)
    ref_full, port_full = _trees(tail, head, seq, full)
    ref_early, port_early = _trees(tail, head, seq,
                                   dict(full, find_max_width=True))
    _same_tree(ref_full, port_full)
    _same_tree(ref_early, port_early)
    assert len(port_early.seq) <= len(port_full.seq)


def test_memory_limit_enforced():
    rng = np.random.default_rng(3)
    tail, head = random_multigraph(rng, n_max=30, e_max=200)
    seq = degree_sequence(tail, head)
    kw = dict(make_kids=True, make_pst=True, make_jxn=True, memory_limit=8)
    for mod in (ref_jxn, port_jxn):
        with pytest.raises(MemoryError):
            mod.build_jxn_tree(tail, head, seq, mod.JxnOptions(**kw))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", OPTION_SETS,
                         ids=[str(i) for i in range(len(OPTION_SETS))])
def test_jxn_native_and_python_equal_reference(seed, kw):
    """The port's native insert and python oracle against the
    reference's python oracle (and its native insert, where built)."""
    rng = np.random.default_rng(600 + seed)
    tail, head = random_multigraph(rng, 40, 170)
    seq = degree_sequence(tail, head)
    want = ref_jxn.build_forest_jxn(tail, head, seq,
                                    ref_jxn.JxnOptions(**kw), impl="python")
    opts = port_jxn.JxnOptions(**kw)
    for impl in ("python", "native"):
        f, s, w = port_jxn.build_forest_jxn(tail, head, seq, opts, impl=impl)
        np.testing.assert_array_equal(s, want[1])
        np.testing.assert_array_equal(f.parent, want[0].parent)
        np.testing.assert_array_equal(f.pst_weight, want[0].pst_weight)
        if want[2] is None:
            assert w is None
        else:
            np.testing.assert_array_equal(w, want[2])


def test_jxn_native_memory_limit_raises():
    rng = np.random.default_rng(1234)
    tail, head = random_multigraph(rng, 60, 400)
    seq = degree_sequence(tail, head)
    opts = port_jxn.JxnOptions(make_kids=True, make_pst=True, make_jxn=True,
                               memory_limit=16)
    for impl in ("python", "native"):
        with pytest.raises(MemoryError):
            port_jxn.build_forest_jxn(tail, head, seq, opts, impl=impl)


def test_jxn_native_rejects_out_of_range_vid():
    from sheep_tpu_torch import native
    tail = np.array([0, 1], np.uint32)
    head = np.array([1, 9], np.uint32)
    seq = np.array([0, 1], np.uint32)
    with pytest.raises(ValueError, match="rc=-3"):
        native.jxn_build(tail, head, seq, 2, 0, 1 << 30, True, False, False,
                         False, False)


def test_jxn_tail_memory_accounting_parity():
    """A tight memory_limit crossed only by tail-phase pst allocations:
    the port's two implementations and the reference's oracle agree at
    every limit."""
    rng = np.random.default_rng(77)
    tail, head = random_multigraph(rng, 14, 20)
    seq = degree_sequence(tail, head)
    for limit in range(0, 200, 4):
        kw = dict(make_pst=True, width_limit=2, memory_limit=limit)
        outcomes = []
        for mod, impl in ((ref_jxn, "python"), (port_jxn, "python"),
                          (port_jxn, "native")):
            try:
                f, s, _ = mod.build_forest_jxn(tail, head, seq,
                                               mod.JxnOptions(**kw),
                                               impl=impl)
                outcomes.append(("ok", f.parent.tolist(), s.tolist()))
            except MemoryError:
                outcomes.append(("memerr",))
        assert outcomes[0] == outcomes[1] == outcomes[2], (limit, outcomes)


def test_rejection_is_atomic():
    """The reference's documented deviation from the C++ original: a
    width-limit rejection leaves no parent write on the roots the
    rejected vertex met.  A triangle whose last vertex is rejected keeps
    the first two in their own subtree until the tail chain adopts them."""
    tail = np.array([0, 1, 0], np.uint32)
    head = np.array([1, 2, 2], np.uint32)
    seq = np.array([0, 1, 2], np.uint32)
    kw = dict(make_kids=True, make_pst=True, make_jxn=True, width_limit=1)
    ref, port = _trees(tail, head, seq, kw)
    _same_tree(ref, port)
    f, s, w = port_jxn.build_forest_jxn(tail, head, seq,
                                        port_jxn.JxnOptions(**kw),
                                        impl="native")
    np.testing.assert_array_equal(f.parent, port.forest.parent)
    np.testing.assert_array_equal(s, port.seq)


# --- structured graphs with known widths (test_treewidth_structured.py) ----


def _widths(tail, head, seq):
    kw = dict(make_kids=True, make_pst=True, make_jxn=True)
    args = (np.asarray(tail, np.uint32), np.asarray(head, np.uint32),
            np.asarray(seq, np.uint32))
    ref, port = _trees(*args, kw)
    _same_tree(ref, port)
    _, _, native = port_jxn.build_forest_jxn(*args, port_jxn.JxnOptions(**kw),
                                             impl="native")
    np.testing.assert_array_equal(native, port.widths)
    return int(port.widths.max())


def _grid(k):
    idx = np.arange(k * k).reshape(k, k)
    return (np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()]),
            np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()]))


@pytest.mark.parametrize("case", ["path", "cycle", "clique", "star",
                                  "grid"])
def test_structured_graph_width(case):
    if case == "path":
        n = 30
        args, want = (np.arange(n - 1), np.arange(1, n), np.arange(n)), 2
    elif case == "cycle":
        n = 24
        args = (np.arange(n), (np.arange(n) + 1) % n, np.arange(n))
        want = 3
    elif case == "clique":
        k = 9
        t, h = np.triu_indices(k, 1)
        args, want = (t, h, np.arange(k)), k
    elif case == "star":
        n = 20
        args = (np.zeros(n - 1, np.int64), np.arange(1, n),
                np.concatenate([np.arange(1, n), [0]]))
        want = 2
    else:
        k = 6
        args, want = (*_grid(k), np.arange(k * k)), k + 1
    assert _widths(*args) == want
