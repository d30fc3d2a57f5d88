"""The port's single-node serve store (sheep_tpu_torch.serve: wal, state,
admission, protocol, faults, netfaults) against the reference's.

The twins of tests/test_serve.py's ServeCore tests: the WAL round trip
and its torn bytes, the ``insert_link`` property, ``ecv_down`` against
the evaluator, recovery, a kill at every insert boundary, ENOSPC on a
snapshot, the seal's retention, admission, the request and fault-plan
grammars, and the group-commit tests (shared fsyncs, a kill at every
group boundary, torn group tails, a failed fsync, seqlock'd reads).
Each scenario runs through both packages on the same seeded inputs, each
in a state dir of its own beside one shared graph file (a snapshot
records the graph's absolute path), and the two must hold equal: every
state-dir file's bytes (``.wal``, ``.snap``, sidecars), ``state_crc()``,
``stats()`` and the query answers.  The concurrent tests, whose record
order depends on the threads, open the port's state dir with the
reference's store and compare what it recovers.  A seeded insert stream under
``SHEEP_SERVE_FAULT_PLAN`` runs as a process of each package, killed
for real."""

import importlib
import os
import shutil
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest

from conftest import random_multigraph

from sheep_tpu.core.forest import build_forest
from sheep_tpu.core.sequence import degree_sequence, sequence_positions
from sheep_tpu.io.edges import write_dat
from sheep_tpu.utils.synth import rmat_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}
SIG = "s" * 64


def mod(side: str, name: str):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def S(side: str):
    return mod(side, "serve")


@pytest.fixture(autouse=True)
def _clean_fault_plans(monkeypatch):
    monkeypatch.delenv("SHEEP_SERVE_FAULT_PLAN", raising=False)
    monkeypatch.delenv("SHEEP_IO_FAULT_PLAN", raising=False)
    for side in PKGS:
        mod(side, "io.faultfs").clear_plan()
        mod(side, "serve.faults").clear_plan()
    yield
    for side in PKGS:
        mod(side, "io.faultfs").clear_plan()
        mod(side, "serve.faults").clear_plan()


def outcome(fn, *args, **kw):
    """A call's result, or its exception's type name and message, with
    the warnings it raised."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            res = ("ok", fn(*args, **kw))
        except Exception as exc:  # noqa: BLE001 - compared across packages
            res = (type(exc).__name__, str(exc))
    return res, [str(x.message) for x in w]


def dir_bytes(d: str) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for f in sorted(files):
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def truncate_tail(path: str, k: int) -> None:
    """Cut the last ``k`` bytes (a tear mid-record)."""
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - k)


def view(core) -> tuple:
    """What a store answers: its crc, its stats and its queries."""
    vids = np.arange(0, len(core.parts) + 5, 3, dtype=np.int64)
    return (core.state_crc(), core.stats(), core.ecv(),
            core.part_batch(vids).tolist(), core.parent_batch(vids).tolist(),
            [np.asarray(x).tolist() for x in core.subtree_batch(vids)],
            [core.part(int(v)) for v in vids[:8]],
            [core.subtree(int(v)) for v in vids[:8]])


def graph(tmp_path, seed=3, log2=7):
    tail, head = rmat_edges(log2, 4 << log2, seed=seed)
    g = str(tmp_path / f"g{seed}-{log2}.dat")
    if not os.path.exists(g):
        write_dat(g, tail, head)
    return g, tail, head


def bootstrap(side, tmp_path, name="state", seed=3, log2=7, parts=3, **kw):
    """A store of ``side``'s package in ``work/<name>`` beside the shared
    graph in ``tmp_path``."""
    g, _, _ = graph(tmp_path, seed, log2)
    sd = str(tmp_path / "work" / name)
    return S(side).ServeCore.bootstrap(sd, graph_path=g, num_parts=parts,
                                       **kw), sd


def both(tmp_path, fn):
    """``fn(side)`` for each package in turn, each in a fresh
    ``tmp_path/work`` (so paths in messages are equal too); the two
    results must be equal."""
    got = {}
    for side in PKGS:
        shutil.rmtree(tmp_path / "work", ignore_errors=True)
        (tmp_path / "work").mkdir()
        got[side] = fn(side)
    assert got["port"] == got["ref"]
    return got["port"]


# -- the WAL ------------------------------------------------------------------


def _wal(side, path, payloads, sync=True):
    wal = mod(side, "serve.wal")
    wal.create_wal(path, SIG)
    with wal.WalAppender(path) as w:
        for p in payloads:
            w.append(p, sync=sync)


def test_wal_roundtrip_equals_reference(tmp_path):
    def run(side):
        p = str(tmp_path / "work" / "serve.wal")
        _wal(side, p, [b"alpha", b"", b"x" * 1000])
        wal = mod(side, "serve.wal")
        with wal.WalAppender(p, expect_sig=SIG) as w:
            nxt = w.next_seqno
        return (open(p, "rb").read(), wal.read_wal(p, "strict"), nxt,
                outcome(wal.WalAppender, p, expect_sig="t" * 64)[0])
    got = both(tmp_path, run)
    assert got[2] == 4 and got[3][0] == "IntegrityError"


def test_wal_torn_at_every_byte_boundary_as_the_reference(tmp_path):
    full = str(tmp_path / "full.wal")
    _wal("port", full, [b"one", b"twotwo", b"three33"])
    ref_full = str(tmp_path / "ref-full.wal")
    _wal("ref", ref_full, [b"one", b"twotwo", b"three33"])
    blob = open(full, "rb").read()
    assert blob == open(ref_full, "rb").read()
    header = mod("port", "serve.wal")._HEADER.size
    for cut in range(header, len(blob) + 1):
        got = {}
        for side in PKGS:
            wal = mod(side, "serve.wal")
            p = str(tmp_path / "torn.wal")
            with open(p, "wb") as f:
                f.write(blob[:cut])
            got[side] = (outcome(wal.read_wal, p, "strict"),
                         outcome(wal.read_wal, p, "repair"),
                         outcome(wal.repair_wal, p), open(p, "rb").read(),
                         outcome(wal.read_wal, p, "strict"))
        assert got["port"] == got["ref"], cut


@pytest.mark.parametrize("damage", ["midchain", "nonmonotone", "header"])
def test_wal_damage_refused_as_the_reference(tmp_path, damage):
    import struct
    import zlib
    p = str(tmp_path / "serve.wal")
    _wal("port", p, [b"aaaa", b"bbbb", b"cccc"])
    blob = bytearray(open(p, "rb").read())
    header = mod("port", "serve.wal")._HEADER.size
    if damage == "midchain":
        blob[header + 16 + 1] ^= 0xFF
    elif damage == "header":
        blob[3] ^= 0x10
    else:
        def rec(seqno, payload):
            head = struct.pack("<QI", seqno, len(payload))
            crc = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
            return struct.pack("<QII", seqno, len(payload), crc) + payload
        blob = blob[:header] + rec(5, b"x") + rec(5, b"y")
    open(p, "wb").write(bytes(blob))
    for mode in ("strict", "repair", "trust"):
        got = outcome(mod("port", "serve.wal").read_wal, p, mode)
        assert got == outcome(mod("ref", "serve.wal").read_wal, p, mode)
        if mode != "trust":
            assert got[0][0] == "MalformedArtifact"


@pytest.mark.parametrize("kind", ["enospc", "eio", "short"])
def test_wal_append_fault_equals_reference(tmp_path, kind):
    def run(side):
        wal = mod(side, "serve.wal")
        faultfs = mod(side, "io.faultfs")
        p = str(tmp_path / "work" / f"{kind}.wal")
        _wal(side, p, [b"base"])
        faultfs.install_plan(faultfs.parse_io_fault_plan(f"{kind}@wal:0"))
        with wal.WalAppender(p) as w:
            first = outcome(w.append, b"doomed")[0][0]
            size = os.path.getsize(p)
            retry = w.append(b"retry")
        faultfs.clear_plan()
        return first, size, retry, open(p, "rb").read()
    got = both(tmp_path, run)
    assert got[0] in ("DiskExhausted", "WriteFault") and got[2] == 2


def test_group_tail_torn_equals_reference(tmp_path):
    def run(side):
        wal = mod(side, "serve.wal")
        p = str(tmp_path / "work" / "group.wal")
        _wal(side, p, [b"one", b"twotwo", b"three33"], sync=False)
        truncate_tail(p, 3)
        return (outcome(wal.read_wal, p, "strict"),
                outcome(wal.read_wal, p, "repair"),
                outcome(wal.repair_wal, p), outcome(wal.read_wal, p,
                                                    "strict"))
    got = both(tmp_path, run)
    assert [r[1] for r in got[3][0][1][2]] == [b"one", b"twotwo"]


# -- the incremental insert transform and ECV ----------------------------------


def test_insert_link_equals_reference_with_and_without_memo():
    from sheep_tpu import INVALID_JNID
    rng = np.random.default_rng(77)
    fns = {side: mod(side, "serve.state").insert_link for side in PKGS}
    for _ in range(15):
        n = int(rng.integers(8, 300))
        base = np.full(n, INVALID_JNID, dtype=np.uint32)
        for x in range(n - 1):
            if rng.random() < 0.8:
                base[x] = int(rng.integers(x + 1, n))
        arrays = {(side, memo): (base.copy(),
                                 np.full(n, INVALID_JNID, np.uint32)
                                 if memo else None)
                  for side in PKGS for memo in (False, True)}
        for _ in range(300):
            lo, hi = sorted(int(v) for v in rng.integers(0, n, 2))
            if lo == hi:
                continue
            rets = {key: fns[key[0]](par, lo, hi, *(() if skip is None
                                                    else (skip,)))
                    for key, (par, skip) in arrays.items()}
            assert len(set(rets.values())) == 1
        first = arrays[("ref", False)][0]
        for key, (par, skip) in arrays.items():
            np.testing.assert_array_equal(par, first)
            if skip is not None:
                np.testing.assert_array_equal(skip,
                                              arrays[("ref", True)][1])


def test_insert_link_property_against_the_batch_build():
    rng = np.random.default_rng(1234)
    insert_link = mod("port", "serve.state").insert_link
    for _ in range(15):
        tail, head = random_multigraph(rng)
        seq = degree_sequence(tail, head)
        n, mv = len(seq), int(max(tail.max(), head.max()))
        split = int(rng.integers(0, len(tail) + 1))
        base = build_forest(tail[:split], head[:split], seq, max_vid=mv,
                            impl="python")
        parent = base.parent.copy()
        pos = sequence_positions(seq, mv)
        for u, v in zip(tail[split:], head[split:]):
            pu, pv = int(pos[u]), int(pos[v])
            if pu != pv and max(pu, pv) < n:
                insert_link(parent, min(pu, pv), max(pu, pv))
        want = build_forest(tail, head, seq, max_vid=mv, impl="python")
        np.testing.assert_array_equal(parent, want.parent)


def test_ecv_down_equals_reference_and_the_evaluator():
    from sheep_tpu.core.forest import Forest
    from sheep_tpu.partition.evaluate import evaluate_partition
    from sheep_tpu.partition.partition import Partition
    tail, head = rmat_edges(8, 4 << 8, seed=21)
    seq = degree_sequence(tail, head)
    forest = build_forest(tail, head, seq)
    part = Partition.from_forest(seq, Forest(forest.parent,
                                             forest.pst_weight), 4,
                                 max_vid=int(max(tail.max(), head.max())))
    pos = sequence_positions(seq, len(part.parts) - 1)
    want = evaluate_partition(part.parts, tail, head, seq, 4,
                              max_vid=len(part.parts) - 1).ecv_down
    for side in PKGS:
        assert mod(side, "serve.state").ecv_down(part.parts, tail, head,
                                                 pos) == want


@pytest.mark.parametrize("seed", range(4))
def test_native_insert_links_equal_the_reference_loop(seed):
    """The port folds a batch's links in one native call; the parent
    array, the ancestor memo and the rewrite count equal the reference's
    ``insert_link`` loop over the same links, on trees with long chains
    and a memo carried across batches."""
    from sheep_tpu import INVALID_JNID
    from sheep_tpu.serve.state import insert_link as ref_insert_link
    from sheep_tpu_torch import native
    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(50, 3000))
    base = np.full(n, INVALID_JNID, dtype=np.uint32)
    for x in range(n - 1):
        if rng.random() < 0.9:
            base[x] = int(rng.integers(x + 1, min(n, x + 4)))
    par_ref, par_port = base.copy(), base.copy()
    skip_ref = np.full(n, INVALID_JNID, dtype=np.uint32)
    skip_port = skip_ref.copy()
    for _ in range(6):
        k = int(rng.integers(1, 200))
        a = rng.integers(0, n, k)
        b = rng.integers(0, n, k)
        keep = a != b
        lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
        want = sum(ref_insert_link(par_ref, int(x), int(y), skip_ref)
                   for x, y in zip(lo, hi))
        got = native.insert_links(par_port, skip_port, lo, hi)
        assert got == want
        np.testing.assert_array_equal(par_port, par_ref)
        np.testing.assert_array_equal(skip_port, skip_ref)
    with pytest.raises(IndexError):
        native.insert_links(par_port.copy(), skip_port.copy(),
                            np.array([n + 3]), np.array([n + 5]))
    with pytest.raises(TypeError):
        native.insert_links(par_port.astype(np.int64), skip_port, lo, hi)


@pytest.mark.parametrize("seed", range(4))
def test_native_subtree_aggregates_equal_the_reference_pass(seed):
    """The port's subtree totals (one native pass) against the
    reference's python pass over a forest and over a random parent array
    whose parents are not always later; a parent past the end raises."""
    from sheep_tpu import INVALID_JNID
    from sheep_tpu_torch import native
    rng = np.random.default_rng(300 + seed)
    tail, head = random_multigraph(rng, n_max=400, e_max=2000)
    seq = degree_sequence(tail, head)
    f = build_forest(tail, head, seq)
    rand = rng.integers(0, len(seq), len(seq)).astype(np.uint32)
    rand[rng.random(len(seq)) < 0.3] = INVALID_JNID
    for parent in (f.parent, rand):
        size = np.ones(len(parent), dtype=np.int64)
        wsum = f.pst_weight.astype(np.int64)
        for k in range(len(parent)):
            p = parent[k]
            if p != INVALID_JNID:
                size[p] += size[k]
                wsum[p] += wsum[k]
        got = native.subtree_aggregates(parent, f.pst_weight)
        np.testing.assert_array_equal(got[0], size)
        np.testing.assert_array_equal(got[1], wsum)
    bad = f.parent.copy()
    bad[0] = len(bad)
    with pytest.raises(IndexError):
        native.subtree_aggregates(bad, f.pst_weight)


# -- the core's lifecycle -----------------------------------------------------


def test_bootstrap_inserts_seal_and_recovery_equal_reference(tmp_path):
    def run(side):
        core, sd = bootstrap(side, tmp_path)
        rng = np.random.default_rng(7)
        ins = rng.integers(0, 140, size=(30, 2)).astype(np.uint32)
        for row in ins[:20]:
            core.insert(row.reshape(1, 2))
        core.seal_snapshot()
        core.insert(ins[20:25])
        for row in ins[25:]:
            core.insert(row.reshape(1, 2))
        before = view(core)
        core.close()
        again = S(side).ServeCore.open(sd)
        after = view(again)
        again.close()
        return before, after, dir_bytes(sd)
    got = both(tmp_path, run)
    before, after = got[0], got[1]
    assert before[0] == after[0] and before[2:] == after[2:]
    assert after[1]["applied_seqno"] == 26


def test_recovery_equals_the_batch_rebuild(tmp_path):
    core, sd = bootstrap("port", tmp_path)
    _, tail, head = graph(tmp_path)
    ins = np.random.default_rng(7).integers(0, 140, (30, 2)).astype(np.uint32)
    for row in ins:
        core.insert(row.reshape(1, 2))
    core.close()
    again = S("port").ServeCore.open(sd)
    want = build_forest(np.concatenate([tail, ins[:, 0]]),
                        np.concatenate([head, ins[:, 1]]), again.seq,
                        max_vid=len(again.parts) - 1)
    np.testing.assert_array_equal(again.parent, want.parent)
    again.close()


def _kill_sweep(tmp_path, side, site, nth, ins, cut_to_pre_append=False):
    """Open a copy of the base dir, insert until the plan kills at
    ``site``'s ``nth`` firing, reopen and let the "client" retry what was
    not recovered; returns what the store answers and its files."""
    faults = mod(side, "serve.faults")
    base = str(tmp_path / "work" / "base")
    if not os.path.exists(base):
        bootstrap(side, tmp_path, name="base")[0].close()
    sd = str(tmp_path / "work" / f"kill-{site}-{nth}")
    shutil.copytree(base, sd)
    victim = S(side).ServeCore.open(sd)
    w = mod(side, "serve.wal").wal_path(sd)
    sizes = []
    faults.install_plan(faults.parse_serve_fault_plan(f"kill@{site}:{nth}",
                                                      kill_mode="raise"))
    killed_at = None
    for i, row in enumerate(ins):
        sizes.append(os.path.getsize(w))
        try:
            victim.insert(row.reshape(1, 2))
        except faults.ServeKilled:
            killed_at = i
            break
    faults.clear_plan()
    victim.close()
    if cut_to_pre_append:  # power loss: the unfsynced tail never landed
        with open(w, "r+b") as f:
            f.truncate(sizes[nth])
    revived = S(side).ServeCore.open(sd)
    recovered, durable = revived.applied_seqno, revived.durable_seqno
    for row in ins[recovered:]:
        revived.insert(row.reshape(1, 2))
    out = (killed_at, recovered, durable, view(revived))
    revived.close()
    return out, dir_bytes(sd)


SWEEP = [("wal", False, 1), ("apply", False, 1), ("gc-append", False, 0),
         ("gc-unsynced", False, 1), ("gc-unsynced", True, 0)]


@pytest.mark.parametrize("site,cut,extra", SWEEP,
                         ids=[f"{s}{'-cut' if c else ''}"
                              for s, c, _ in SWEEP])
def test_kill_at_every_insert_boundary_equals_reference(tmp_path, site, cut,
                                                        extra):
    """Killed at every insert of the stream: the durable insert is
    recovered (or, before its append, lost unacknowledged), the retried
    remainder converges on the uninterrupted store, and both packages'
    state dirs hold the same bytes."""
    ins = np.random.default_rng(11).integers(0, 140, (6, 2)).astype(
        np.uint32)
    (tmp_path / "work").mkdir()
    control, _ = bootstrap("port", tmp_path, name="control")
    for row in ins:
        control.insert(row.reshape(1, 2))
    want = view(control)
    control.close()
    for nth in range(len(ins)):
        got = both(tmp_path, lambda side: _kill_sweep(tmp_path, side, site,
                                                      nth, ins, cut))
        killed_at, recovered, durable, answers = got[0]
        assert killed_at == nth and recovered == durable == nth + extra
        assert answers[0] == want[0] and answers[2] == want[2]


def test_open_strict_refuses_torn_wal_repair_truncates_as_reference(
        tmp_path):
    def run(side):
        core, sd = bootstrap(side, tmp_path)
        core.insert(np.array([[1, 2]], np.uint32))
        core.close()
        w = mod(side, "serve.wal").wal_path(sd)
        truncate_tail(w, 3)
        strict = outcome(S(side).ServeCore.open, sd)[0][0]
        (kind, core), warns = outcome(S(side).ServeCore.open, sd,
                                      integrity="repair")
        out = (strict, kind, warns, view(core))
        core.close()
        return out, dir_bytes(sd)
    got = both(tmp_path, run)
    assert got[0][0] == "MalformedArtifact"
    assert got[0][3][1]["applied_seqno"] == 0


def test_open_repairs_torn_group_tail_as_reference(tmp_path):
    def run(side):
        core, sd = bootstrap(side, tmp_path, name="gtail")
        enc = mod(side, "serve.state").encode_inserts
        for r in ((1, 2), (3, 4), (5, 6)):
            core._wal.append(enc(np.array([r], np.uint32)), sync=False)
        core._wal.close()
        w = mod(side, "serve.wal").wal_path(sd)
        truncate_tail(w, 3)
        strict = outcome(S(side).ServeCore.open, sd)[0][0]
        (_, core), warns = outcome(S(side).ServeCore.open, sd,
                                   integrity="repair")
        out = (strict, warns, view(core), core.durable_seqno)
        core.close()
        return out, dir_bytes(sd)
    got = both(tmp_path, run)
    assert got[0][2][1]["applied_seqno"] == got[0][3] == 2


def test_enospc_on_snapshot_keeps_serving_as_reference(tmp_path):
    def run(side):
        faultfs = mod(side, "io.faultfs")
        core, sd = bootstrap(side, tmp_path)
        core.snap_every = 2
        faultfs.install_plan(faultfs.parse_io_fault_plan("enospc@snap:0"))
        res = [outcome(core.insert, np.array([[1, 2]], np.uint32)),
               outcome(core.insert, np.array([[3, 4]], np.uint32))]
        faultfs.clear_plan()
        out = (res, core.snap_failures, view(core))
        core.close()
        again = S(side).ServeCore.open(sd)
        out += (view(again),)
        again.close()
        return out, dir_bytes(sd)
    got = both(tmp_path, run)
    assert any("snapshot seal failed" in w for w in got[0][0][1][1])
    assert got[0][1] == 1 and got[0][3][1]["applied_seqno"] == 2


def test_seal_gc_keeps_two_generations_as_reference(tmp_path):
    def run(side):
        core, sd = bootstrap(side, tmp_path)
        for i in range(4):
            core.insert(np.array([[i, i + 1]], np.uint32))
            core.seal_snapshot()
        names = [os.path.basename(p)
                 for p in mod(side, "serve.state").snap_paths(sd)]
        core.close()
        return names, dir_bytes(sd)
    got = both(tmp_path, run)
    assert got[0] == ["snap-000000000003.snap", "snap-000000000004.snap"]


def test_group_commit_fsync_failure_as_reference(tmp_path):
    def run(side):
        faultfs = mod(side, "io.faultfs")
        core, sd = bootstrap(side, tmp_path, name="gcfail")
        core.insert(np.array([[1, 2]], np.uint32))
        faultfs.install_plan(faultfs.parse_io_fault_plan("eio@wal:0"))
        failed = outcome(core.insert, np.array([[3, 4]], np.uint32))[0][0]
        faultfs.clear_plan()
        durable = core.durable_seqno
        core.insert(np.array([[5, 6]], np.uint32))
        out = (failed, durable, view(core))
        core.close()
        return out, dir_bytes(sd)
    got = both(tmp_path, run)
    assert got[0][0] == "WriteFault" and got[0][1] == 1


# -- admission and the grammars -------------------------------------------------


def _admission(side):
    adm_mod = mod(side, "serve.admission")
    adm = adm_mod.AdmissionController(max_inflight=4)
    trail = [adm.insert_watermark]
    with adm.admit("query"), adm.admit("query"):
        trail.append(outcome(lambda: adm.admit("insert").__enter__())[0][0])
        with adm.admit("query"):
            trail.append(adm.inflight)
    trail += [adm.inflight, adm.shed]
    ro = adm_mod.AdmissionController(max_inflight=4, read_only=True)
    trail.append(outcome(lambda: ro.admit("insert").__enter__())[0][0])
    with ro.admit("query"):
        trail.append(ro.inflight)
    gov = mod(side, "resources.governor").ResourceGovernor(mem_budget=1)
    pressed = adm_mod.AdmissionController(max_inflight=4, governor=gov)
    trail.append(outcome(lambda: pressed.admit("insert").__enter__())[0][0])
    with pressed.admit("query"):
        trail.append(pressed.inflight)
    return trail


def test_admission_policy_equals_reference(tmp_path):
    got = both(tmp_path, _admission)
    assert got[0] == 2 and got[1] == "Overloaded"
    assert got[5] == got[7] == "ReadOnly"


@pytest.mark.parametrize("line", [
    "DEADLINE=0.5 PART 1 2 3", "insert 1 2", "", "DEADLINE=x PART 1",
    "DEADLINE=1", "NOPE 1", "DEADLINE=-1 PING", "PARENT 3", "SUBTREE 9 8",
    "STATS", "ECV", "SNAPSHOT", "REPARTITION", "METRICS", "INSERT 1",
    "PART", "PART x", "INSERT 1 2 3 4"])
def test_parse_request_equals_reference(line):
    def parse(side):
        def call():
            r = mod(side, "serve.protocol").parse_request(line)
            return (r.verb, r.args, r.deadline_s, r.rid, r.kind)
        return outcome(call)
    assert parse("port") == parse("ref")


@pytest.mark.parametrize("spec", [
    "kill@wal:3, hang@req:0", "kill@wal", "boom@wal:1", "kill@nowhere:1",
    "slow@query:2", "kill@reseq-fold:0,kill@gc-unsynced:4", "", " , "])
def test_serve_fault_plan_grammar_equals_reference(spec):
    def parse(side):
        def call():
            plan = mod(side, "serve.faults").parse_serve_fault_plan(spec)
            return [(f.kind, f.site, f.nth) for f in plan.faults]
        return outcome(call)
    assert parse("port") == parse("ref")


@pytest.mark.parametrize("spec", [
    "drop@append:3", "partition@append:0-5", "slow@ack:1,dup@append:2",
    "boom@append:1", "drop@nowhere:1", "drop@append", ""])
def test_netfault_plan_grammar_equals_reference(spec):
    def parse(side):
        def call():
            plan = mod(side, "serve.netfaults").parse_netfault_plan(spec)
            return repr(plan)
        return outcome(call)
    assert parse("port") == parse("ref")


# -- group commit and the seqlock, against a replay -------------------------------


def _reference_reopen(tmp_path, port_sd, name):
    """The reference's store opened on a copy of the port's state dir
    (its newest snapshot plus the WAL replayed in seqno order): what it
    recovers must be what the port holds."""
    sd = str(tmp_path / name)
    shutil.copytree(port_sd, sd)
    core = S("ref").ServeCore.open(sd)
    out = (core.state_crc(), core.applied_seqno)
    core.close()
    return out


def test_group_commit_shares_fsyncs_and_replays_on_the_reference(tmp_path):
    core, sd = bootstrap("port", tmp_path, name="gc", log2=8)
    core.group_commit_delay_s = 0.05
    core.snap_every = 1 << 30
    nthreads, per = 8, 4
    barrier = threading.Barrier(nthreads)
    errs = []

    def worker(t):
        rng = np.random.default_rng(100 + t)
        barrier.wait()
        try:
            for _ in range(per):
                core.insert(rng.integers(0, 280, (1, 2)).astype(np.uint32))
        except Exception as exc:  # pragma: no cover - surfaced below
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(nthreads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs
    st = core.stats()
    total = nthreads * per
    assert st["applied_seqno"] == st["durable_seqno"] == total
    assert 0 < st["gc_fsyncs"] < total and st["gc_records"] == total
    assert st["gc_size_p99"] >= st["gc_size_p50"] >= 1
    crc = core.state_crc()
    core.close()
    revived = S("port").ServeCore.open(sd)
    assert revived.state_crc() == crc and revived.applied_seqno == total
    revived.close()
    assert _reference_reopen(tmp_path, sd, "gc-ref") == (crc, total)


def test_seqlock_reads_under_insert_hammer(tmp_path):
    core, sd = bootstrap("port", tmp_path, name="hammer", log2=8)
    core.snap_every = 1 << 30
    vids = np.arange(0, 300, 7, dtype=np.int64)
    done = threading.Event()
    werrs = []

    def writer():
        rng = np.random.default_rng(99)
        try:
            for i in range(120):
                core.insert(rng.integers(0, 280, (3, 2)).astype(np.uint32))
                if i % 40 == 20:
                    core.repartition()
        except Exception as exc:  # pragma: no cover - surfaced below
            werrs.append(exc)
        finally:
            done.set()

    th = threading.Thread(target=writer)
    th.start()
    checked = 0
    try:
        while not done.is_set() or checked < 25:
            got_p = core.part_batch(vids)
            with core._lock:
                v0 = core._version
                want_p = core.part_batch(vids)
                want_b = core.parent_batch(vids)
                want_ps = np.array([core.part(int(v)) for v in vids])
            got_p2 = core.part_batch(vids)
            got_b2 = core.parent_batch(vids)
            if core._version == v0:
                np.testing.assert_array_equal(got_p2, want_p)
                np.testing.assert_array_equal(got_b2, want_b)
                np.testing.assert_array_equal(want_p, want_ps)
                checked += 1
            assert got_p.shape == vids.shape
    finally:
        done.set()
        th.join()
    assert not werrs and checked >= 25
    crc, applied = core.state_crc(), core.applied_seqno
    core.close()
    again = S("port").ServeCore.open(sd)
    assert (again.state_crc(), again.applied_seqno) == (crc, applied)
    again.close()
    assert _reference_reopen(tmp_path, sd, "hammer-ref") == (crc, applied)


# -- a seeded stream under SHEEP_SERVE_FAULT_PLAN, killed for real ---------------


STREAM = """
import sys, numpy as np
from {pkg}.serve import ServeCore
core = ServeCore.open(sys.argv[1])
rng = np.random.default_rng(5)
for i in range(40):
    core.insert(rng.integers(0, 140, (2, 2)).astype(np.uint32))
    print(i, flush=True)
core.close()
"""


@pytest.mark.parametrize("plan", ["kill@wal:7", "kill@gc-append:3",
                                  "kill@apply:0", ""])
def test_stream_killed_by_the_env_plan_equals_reference(tmp_path, plan):
    """The store as a process under ``SHEEP_SERVE_FAULT_PLAN``: the kill
    is ``os._exit(137)``; the reopened dirs are the reference's."""
    def run(side):
        core, sd = bootstrap(side, tmp_path, name="env")
        core.close()
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   SHEEP_SERVE_FAULT_PLAN=plan)
        proc = subprocess.run(
            [sys.executable, "-c", STREAM.format(pkg=PKGS[side]), sd],
            capture_output=True, text=True, timeout=120, env=env)
        acked = len(proc.stdout.split())
        again = S(side).ServeCore.open(sd)
        out = (proc.returncode, acked, view(again))
        again.close()
        return out, dir_bytes(sd)
    got = both(tmp_path, run)
    rc, acked, answers = got[0]
    assert rc == (137 if plan else 0)
    assert answers[1]["applied_seqno"] >= acked


def test_serve_drive_end_to_end(tmp_path):
    """``scripts/serve_drive.py run`` (chip_smoke's serve phase) at a
    small size: threaded inserts killed for real and recovered, the
    replay, the re-sequences against the oracle and each other, the ECV
    against the evaluator, fsck; every check holds."""
    import json
    env = dict(os.environ, PYTHONPATH=REPO)
    g = str(tmp_path / "G.dat")
    for argv in (["make_graph", "12", "8", g, "0"],
                 ["degree_sequence", g, str(tmp_path / "S.seq")],
                 ["graph2tree", g, "-s", str(tmp_path / "S.seq"), "-o",
                  str(tmp_path / "T.tre")]):
        subprocess.run([sys.executable, "-m",
                        f"sheep_tpu_torch.cli.{argv[0]}", *argv[1:]],
                       check=True, capture_output=True, env=env, cwd=REPO,
                       timeout=120)
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.scripts.serve_drive", "run",
         str(tmp_path / "w"), "--tree", str(tmp_path / "T.tre"), "--seq",
         str(tmp_path / "S.seq"), "--graph", g, "--log-n", "12",
         "--inserts", "2048", "--batch", "8", "--kill-at", "64",
         "--query", "32", "--subtree-every", "4"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("serve_record ")][-1]
    rec = json.loads(line.split(" ", 1)[1])
    assert all(rec["checks"].values()) and len(rec["checks"]) >= 13
    assert rec["killed"]["acked"] < 64 <= rec["resume"][
        "applied_after_recovery"]
