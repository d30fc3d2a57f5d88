"""The serve daemon's resident state: snapshot + WAL = the whole truth.

``ServeCore`` owns everything below the socket: the elimination tree
(parent/pst over jnid space), the vid-indexed partition, the optional
resident edge list (for exact ECV), the write-ahead log, and the snapshot
lifecycle.  It is deliberately socket-free so property tests and the fsck
tool drive the exact code the daemon runs.

**Incremental insert.**  An arriving edge {u, v} maps to a link
(lo, hi) by sequence position and is folded into the live tree by the
union-find transform the whole framework is built on (core/forest.py):
the merge-associativity property says the post-insert tree equals a full
rebuild over (old links + new link), and because links only ever attach a
component's max element to a later vertex, that fold has a local form —
climb lo's parents to its maximal ancestor r below hi (the component
representative under threshold-hi connectivity), attach ``parent[r] = hi``,
and re-insert r's displaced old link, whose hi is strictly larger, so the
cascade terminates at a root ("Work-Efficient Parallel and Incremental
Graph Connectivity", PAPERS.md — no rebuild).  Absent endpoints follow the
offline contract (core/forest.edges_to_positions): one endpoint in the
sequence -> pst-only; both absent or a self-loop -> recorded but inert.
The transform is deterministic, which is what makes WAL replay
bit-identical (serve/wal.py).

**Durability order** (every insert): WAL append + fsync -> in-memory
apply -> acknowledge.  Snapshots seal sidecar-first through the
writers (integrity.sidecar.sealed_write, fault site ``snap``), then the
WAL is atomically replaced by a fresh one; a crash between the two leaves
already-applied records in the log, which replay skips by seqno.  Restart
= newest loadable snapshot + replay of records with larger seqnos.

**Partition drift.**  Inserts are counted against the partition they
arrive under (an insert whose endpoints live in different parts raises
ECV(down) by at most 1); when the accumulated cut count crosses the drift
threshold the owner (daemon) runs :meth:`repartition` in the background —
queries keep answering from the stale-but-consistent partition until the
new one swaps in atomically under the state lock.
"""

from __future__ import annotations

import glob
import os
import re
import struct
import threading
import time
import warnings
from collections import deque

import numpy as np

from .. import INVALID_JNID, INVALID_PART
from ..core.forest import Forest
from ..core.sequence import (host_degree_histogram, sequence_positions)
from ..integrity.errors import IntegrityError, MalformedArtifact
from ..integrity.sidecar import resolve_policy, sealed_write, sidecar_path
from ..obs import trace as _trace
from ..partition.tree_partition import (TreePartitionOptions,
                                        partition_forest)
from ..resources import ResourceGovernor, gc_orphan_temps
from ..runtime.snapshot import input_signature
from . import faults as serve_faults
from .wal import (WalAppender, archived_wal_name, create_wal, read_wal,
                  repair_wal, wal_path)

SNAP_VERSION = 1
SNAP_RE = re.compile(r"^snap-(\d{12})\.snap$")

#: sentinels of the vectorized parent gather (:meth:`ServeCore.
#: parent_batch`): an int64 lane that cannot be a vid encodes the two
#: non-vid answers of the scalar walk ("root" / "absent")
PARENT_ROOT = -1
PARENT_ABSENT = -2

#: serve state dirs keep this many sealed snapshots (the live one plus a
#: fallback the repair policy can reach for if the newest goes bad)
KEEP_SNAPSHOTS = 2

#: how many recent records the in-memory replication window retains; a
#: follower further behind than this bootstraps from a snapshot instead
REPL_TAIL_KEEP = 4096

#: lock-free read attempts before a seqlock read falls back to the state
#: lock — bounds reader starvation under a write storm
_SEQLOCK_TRIES = 3


def snap_name(applied_seqno: int) -> str:
    return f"snap-{applied_seqno:012d}.snap"


def snap_paths(state_dir: str) -> list[str]:
    """Snapshot files in the dir, oldest first (by applied seqno)."""
    out = []
    for path in glob.glob(os.path.join(glob.escape(state_dir),
                                       "snap-*.snap")):
        if SNAP_RE.match(os.path.basename(path)):
            out.append(path)
    return sorted(out)


# -- insert payload codec ---------------------------------------------------

_PAIRS_HEAD = struct.Struct("<I")


def encode_inserts(pairs: np.ndarray) -> bytes:
    """(k, 2) uint32 edge array -> WAL record payload."""
    pairs = np.ascontiguousarray(pairs, dtype="<u4")
    if pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError(f"insert batch must be (k, 2), got {pairs.shape}")
    return _PAIRS_HEAD.pack(len(pairs)) + pairs.tobytes()


def decode_inserts(payload: bytes) -> np.ndarray:
    if len(payload) < _PAIRS_HEAD.size:
        raise MalformedArtifact(
            f"insert record payload of {len(payload)} bytes is shorter "
            f"than its count header")
    (k,) = _PAIRS_HEAD.unpack_from(payload, 0)
    body = payload[_PAIRS_HEAD.size:]
    if len(body) != 8 * k:
        raise MalformedArtifact(
            f"insert record claims {k} pairs but carries {len(body)} "
            f"payload bytes (want {8 * k})")
    return np.frombuffer(body, dtype="<u4").reshape(k, 2).copy()


# -- snapshot format --------------------------------------------------------


class ServeSnapshot:
    """One sealed serving state (see module docstring for why this tuple
    is complete): tree + partition + cumulative inserted edges + the WAL
    seqno folded in so far + the replication epoch that sealed it."""

    def __init__(self, seq, parent, pst, parts, num_parts, applied_seqno,
                 ins_tail, ins_head, drift_cut, baseline_ecv, graph_path,
                 sig, balance, epoch=0, epoch_base=0, deg=None,
                 deg_base=None, seq_drift=0, reseqs=0, seq_gen=0,
                 ins_base=0):
        self.seq = seq
        self.parent = parent
        self.pst = pst
        self.parts = parts
        self.num_parts = int(num_parts)
        self.applied_seqno = int(applied_seqno)
        self.ins_tail = ins_tail
        self.ins_head = ins_head
        self.drift_cut = int(drift_cut)
        self.baseline_ecv = int(baseline_ecv)
        self.graph_path = graph_path
        self.sig = sig
        self.balance = float(balance)
        self.epoch = int(epoch)
        #: the applied seqno at which this epoch began (the promotion
        #: boundary): an old-epoch replica at or below it shares our
        #: record prefix and may stream; past it, it may have a
        #: divergent tail and must snapshot-resync
        self.epoch_base = int(epoch_base)
        #: incremental degree histogram: vid-indexed int64
        #: counts over (graph + inserted) edges, maintained as two +1s
        #: per insert; None in a pre-reseq snapshot (recounted on load)
        self.deg = deg
        #: the histogram at the moment the CURRENT sequence was
        #: established (bootstrap or last re-sequence) — degree-rank
        #: movement is measured against it
        self.deg_base = deg_base
        self.seq_drift = int(seq_drift)
        self.reseqs = int(reseqs)
        #: sequence generation: bumped by every re-sequence swap; the
        #: reseq manifest chains (gen, sig) pairs so fsck and the
        #: replication handshake can tell a planned sequence change
        #: from corruption
        self.seq_gen = int(seq_gen)
        #: how many inserted edges the current sequence already covers
        #: (the re-sequence cut); the drift fraction is measured over
        #: inserts past it
        self.ins_base = int(ins_base)

    def validate(self) -> None:
        problems = []
        if self.epoch < 0:
            problems.append(f"negative epoch {self.epoch}")
        m = len(self.seq)
        if len(self.parent) != m or len(self.pst) != m:
            problems.append(
                f"tree arrays disagree with the sequence: "
                f"{len(self.parent)} parent / {len(self.pst)} pst / {m} seq")
        else:
            linked = self.parent != INVALID_JNID
            ids = np.arange(m, dtype=np.uint32)
            if bool((linked & (self.parent >= m)).any()):
                problems.append("parent pointer out of range")
            elif bool((linked & (self.parent <= ids)).any()):
                problems.append("non-monotone parent pointer "
                                "(parents must be strictly later)")
        if m and len(self.parts) <= int(self.seq.max()):
            problems.append(
                f"partition covers {len(self.parts)} vids but the "
                f"sequence names vid {int(self.seq.max())}")
        if len(self.ins_tail) != len(self.ins_head):
            problems.append(
                f"inserted-edge arrays disagree: {len(self.ins_tail)} "
                f"tails vs {len(self.ins_head)} heads")
        if self.applied_seqno < 0 or self.drift_cut < 0:
            problems.append("negative counters")
        if (self.seq_drift < 0 or self.reseqs < 0 or self.seq_gen < 0
                or self.ins_base < 0):
            problems.append("negative re-sequence counters")
        if self.ins_base > len(self.ins_tail):
            problems.append(
                f"re-sequence cut {self.ins_base} past the "
                f"{len(self.ins_tail)} inserted edges")
        if self.deg is not None and (
                len(self.deg) != len(self.parts)
                or self.deg_base is None
                or len(self.deg_base) != len(self.parts)):
            problems.append("degree histogram disagrees with the "
                            "vid tables")
        if self.num_parts < 1:
            problems.append(f"num_parts {self.num_parts} < 1")
        if problems:
            raise MalformedArtifact(
                "corrupt serve snapshot — " + "; ".join(problems))

    def nbytes_estimate(self) -> int:
        deg = 0 if self.deg is None \
            else self.deg.nbytes + self.deg_base.nbytes
        return (self.seq.nbytes + self.parent.nbytes + self.pst.nbytes
                + self.parts.nbytes + self.ins_tail.nbytes
                + self.ins_head.nbytes + deg + 4096)


def save_serve_snapshot(path: str, snap: ServeSnapshot,
                        governor: ResourceGovernor | None = None) -> None:
    """Seal one snapshot sidecar-first (integrity.sidecar.sealed_write):
    a crash or an injected ``snap``-site fault (io/faultfs.py) aborts
    with the previous snapshot generation intact."""
    snap.validate()
    est = snap.nbytes_estimate()
    gov = governor if governor is not None else ResourceGovernor.from_env()
    gov.check_dir_budget(os.path.dirname(os.path.abspath(path)) or ".",
                         est, "serve snapshot")
    fields = {}
    if snap.deg is not None:
        fields["deg"] = np.asarray(snap.deg, dtype=np.int64)
        fields["deg_base"] = np.asarray(snap.deg_base, dtype=np.int64)
    with sealed_write(path, "wb", expect_bytes=est) as f:
        np.savez(
            f,
            version=np.int64(SNAP_VERSION),
            seq=np.asarray(snap.seq, dtype=np.uint32),
            parent=np.asarray(snap.parent, dtype=np.uint32),
            pst=np.asarray(snap.pst, dtype=np.uint32),
            parts=np.asarray(snap.parts, dtype=np.int64),
            num_parts=np.int64(snap.num_parts),
            applied_seqno=np.int64(snap.applied_seqno),
            ins_tail=np.asarray(snap.ins_tail, dtype=np.uint32),
            ins_head=np.asarray(snap.ins_head, dtype=np.uint32),
            drift_cut=np.int64(snap.drift_cut),
            baseline_ecv=np.int64(snap.baseline_ecv),
            graph_path=np.str_(snap.graph_path or ""),
            sig=np.str_(snap.sig),
            balance=np.float64(snap.balance),
            epoch=np.int64(snap.epoch),
            epoch_base=np.int64(snap.epoch_base),
            seq_drift=np.int64(snap.seq_drift),
            reseqs=np.int64(snap.reseqs),
            seq_gen=np.int64(snap.seq_gen),
            ins_base=np.int64(snap.ins_base),
            **fields,
        )


def load_serve_snapshot(path: str,
                        integrity: str | None = None) -> ServeSnapshot:
    """Load + fully verify one serve snapshot (also the ``sheep fsck``
    checker for ``.snap``).  Like runtime checkpoints, a snapshot is
    never partially salvaged: the checksum check is strict even under the
    repair policy — repair's graceful path lives in ServeCore.open, which
    falls back to an older generation."""
    from ..integrity.sidecar import verify_file
    mode = resolve_policy(integrity)
    if mode != "trust":
        verify_file(path, "strict")
    try:
        with np.load(path) as z:
            if int(z["version"]) != SNAP_VERSION:
                raise MalformedArtifact(
                    f"{path}: serve snapshot version {int(z['version'])} "
                    f"!= supported {SNAP_VERSION}")
            snap = ServeSnapshot(
                seq=z["seq"].copy(), parent=z["parent"].copy(),
                pst=z["pst"].copy(), parts=z["parts"].copy(),
                num_parts=int(z["num_parts"]),
                applied_seqno=int(z["applied_seqno"]),
                ins_tail=z["ins_tail"].copy(), ins_head=z["ins_head"].copy(),
                drift_cut=int(z["drift_cut"]),
                baseline_ecv=int(z["baseline_ecv"]),
                graph_path=str(z["graph_path"]), sig=str(z["sig"]),
                balance=float(z["balance"]),
                # pre-replication snapshots predate epochs: term 0
                epoch=int(z["epoch"]) if "epoch" in z.files else 0,
                epoch_base=(int(z["epoch_base"])
                            if "epoch_base" in z.files else 0),
                # pre-reseq snapshots predate the incremental degree
                # histogram: None makes the core recount on load
                deg=z["deg"].copy() if "deg" in z.files else None,
                deg_base=(z["deg_base"].copy()
                          if "deg_base" in z.files else None),
                seq_drift=(int(z["seq_drift"])
                           if "seq_drift" in z.files else 0),
                reseqs=int(z["reseqs"]) if "reseqs" in z.files else 0,
                seq_gen=int(z["seq_gen"]) if "seq_gen" in z.files else 0,
                ins_base=(int(z["ins_base"])
                          if "ins_base" in z.files else 0))
    except IntegrityError:
        raise
    except Exception as exc:  # BadZipFile / KeyError / OSError / ValueError
        raise MalformedArtifact(
            f"{path}: corrupt serve snapshot "
            f"({type(exc).__name__}: {exc})")
    snap.validate()
    return snap


class ReplicationGap(RuntimeError):
    """A replicated record would leave a hole in the seqno chain; the
    follower must re-sync from its applied seqno (serve/replicate.py)."""

    def __init__(self, expected: int, got: int):
        super().__init__(f"replication gap: expected seqno {expected}, "
                         f"stream delivered {got}")
        self.expected = expected
        self.got = got


# -- the incremental transform ----------------------------------------------


def insert_link(parent: np.ndarray, lo: int, hi: int,
                skip: np.ndarray | None = None) -> int:
    """Fold one link (lo -> hi), lo < hi, into a live parent array.

    Exactly the merge replay localized (module docstring): climb lo to
    its component representative under threshold-hi connectivity, attach,
    cascade the displaced link upward.  Returns the number of parent
    pointers rewritten (0 = the edge was already implied by the tree).

    ``skip`` is an optional ancestor memo: ``skip[x]`` holds
    SOME ancestor of ``x`` in the tree, or INVALID.  Chains are strictly
    increasing (``parent[x] > x``, preserved by every attach below) and
    an attach only ever splices nodes INTO a chain — it never removes an
    ancestor relation — so between calls a recorded ancestor stays an
    ancestor for the tree's whole lifetime and the memo needs no
    invalidation.  MID-cascade there is one pending exception: the
    displaced link (lo -> old parent) is broken until this very round
    re-folds it, and lo's memo may still route through it — but every
    such stale entry is ``>= hi`` (the displaced parent and everything
    above), so jumping only through ``skip[x] < hi`` (STRICT) never
    consults one.  Strict jumps cannot overshoot either the stopping
    node or the ``parent == hi`` early-exit, because every node on the
    path to an ancestor ``a`` is ``< a``.  Climbs compress the visited
    path into the memo, so chain walks that are O(depth) cold become
    near-O(1) amortized — without it, sustained insert load degrades as
    accreted links deepen the chains (measured ~830 steps/climb after
    8k random inserts on hep-th).  The memo is a pure accelerator:
    parent outcomes and the rewrite count are bit-identical with or
    without it.

    The store itself folds through ``native.insert_links``, this loop
    in the native library (:meth:`ServeCore._fold_links`); this function
    is the public mirror that it is held equal to.
    """
    rewrites = 0
    while True:
        r = lo
        path = None
        while True:
            if skip is not None:
                s = int(skip[r])
                if s != INVALID_JNID and s < hi:
                    r = s
                    continue
            p = int(parent[r])
            if p == INVALID_JNID or p > hi:
                break
            if p == hi:
                if skip is not None and r != lo:
                    skip[lo] = r
                return rewrites  # lo's component already hangs off hi
            if skip is not None:
                if path is None:
                    path = [r]
                else:
                    path.append(r)
            r = p
        if path is not None:
            for x in path:  # r is an ancestor of every visited node
                skip[x] = r
        if skip is not None and r != lo:
            skip[lo] = r
        if r == hi:
            return rewrites
        p = int(parent[r])  # INVALID or > hi: the displaced link
        parent[r] = hi
        rewrites += 1
        if p == INVALID_JNID:
            return rewrites
        lo, hi = r, p


def ecv_down(parts: np.ndarray, tail: np.ndarray, head: np.ndarray,
             pos: np.ndarray) -> int:
    """ECV(down) — distinct (vertex, part-of-earlier-endpoint) pairs
    beyond each vertex's own, identical to partition.evaluate's
    ``ecv_down`` field but tolerant of INVALID_PART entries (vids inserted
    after the sequence was fixed have no part yet; evaluate's balance
    bincounts would reject them)."""
    t = tail.astype(np.int64)
    h = head.astype(np.int64)
    X = np.concatenate([t, h])
    Y = np.concatenate([h, t])
    pos64 = pos.astype(np.int64)
    pX = parts[X]
    pY = parts[Y]
    down = np.where(pos64[X] < pos64[Y], pX, pY)
    # distinct (X, down) keys; down in [-1, P) so shift by +1 into [0, P]
    P = int(parts.max(initial=0)) + 1
    key = X * np.int64(P + 2) + (down + 1)
    n_active = len(np.unique(X))
    return int(len(np.unique(key)) - n_active)


# -- the core ---------------------------------------------------------------


class ServeCore:
    """Resident serving state + WAL + snapshot lifecycle (socket-free).

    Thread-safe: every public method takes the state lock; the heavy
    repartition compute runs on copies outside it and swaps in under it.
    """

    def __init__(self, state_dir: str, snap: ServeSnapshot,
                 appender: WalAppender,
                 governor: ResourceGovernor | None = None,
                 snap_every: int = 256,
                 drift_frac: float = 0.1,
                 drift_min_cut: int = 64,
                 reseq_frac: float = 0.25,
                 reseq_min: int = 256,
                 reseq_rank: int = 8,
                 group_commit_max: int = 256,
                 group_commit_delay_s: float = 0.002):
        self.state_dir = state_dir
        self.governor = governor if governor is not None \
            else ResourceGovernor.from_env()
        self.snap_every = max(1, int(snap_every))
        self.drift_frac = float(drift_frac)
        self.drift_min_cut = max(1, int(drift_min_cut))
        # sequence-drift detector: an insert counts as
        # sequence drift when an endpoint is outside the sequence or its
        # degree rank moved >= reseq_rank since the sequence was fixed;
        # the detector fires at reseq_frac of the inserts past the cut,
        # floored at reseq_min
        self.reseq_frac = float(reseq_frac)
        self.reseq_min = max(1, int(reseq_min))
        self.reseq_rank = max(1, int(reseq_rank))
        self._lock = threading.RLock()
        self._wal = appender
        #: replication hook (serve/replicate.py): called with no args,
        #: under the state lock, after every durable append — the hub
        #: wakes its per-follower senders off it.  Never does I/O.
        self.on_append = None
        #: whether THIS core fires the SHEEP_SERVE_FAULT_PLAN sites; the
        #: multi-core in-process harnesses (tests) disable it on all but
        #: the node under test so "kill@wal:3" names one node's boundary
        self.fire_faults = True
        self.repartitions = 0
        self.snap_failures = 0
        # repartition ordering: a later-STARTED repartition (newer tree)
        # must never be overwritten by an earlier-started one finishing
        # late (the background thread racing a forced REPARTITION)
        self._repart_ticket = 0
        self._repart_applied = -1
        # same ordering discipline for re-sequences: a later-started
        # rebuild (fresher cut) must win over an earlier one landing late
        self._reseq_ticket = 0
        self._reseq_applied = -1
        # -- group commit: the leader-side analogue of the
        # follower burst seal.  Concurrent inserts append DEFERRED
        # (sync=False) under the state lock, then park here on a shared
        # commit ticket; one fsync covers the whole group and releases
        # every waiter at once.  A lone insert elects itself leader and
        # fsyncs immediately (idle latency unchanged); under concurrency
        # the next leader's fsync piggybacks everything appended while
        # the previous one was in flight, optionally stretched by
        # group_commit_delay_s up to group_commit_max records.
        self.group_commit_max = max(1, int(group_commit_max))
        self.group_commit_delay_s = max(0.0, float(group_commit_delay_s))
        self._gc_cv = threading.Condition()
        self._gc_leader = False
        self._gc_rids: list[tuple[int, str]] = []
        self._gc_err: BaseException | None = None
        self._gc_err_seq = 0
        self.gc_fsyncs = 0
        self.gc_records = 0
        self._gc_sizes: deque = deque(maxlen=512)
        # -- seqlock: reads are lock-free against a published
        # version counter.  Writers bump it to odd before mutating the
        # serving arrays and back to even after; readers snapshot the
        # counter + array refs, gather, re-check, bounded-retry, then
        # fall back to the lock.  CPython's GIL orders the plain
        # attribute reads/writes; the counter is only ever bumped under
        # the state lock, so "even" means "no writer mid-mutation".
        self._version = 0
        self.seqlock_retries = 0
        self.seqlock_fallbacks = 0
        # -- anti-entropy: with a verify-capable follower
        # attached, the leader captures state_crc at every verify_n-th
        # applied seqno INSIDE the apply critical section (the crc names
        # exactly that seqno's state — RLock makes state_crc re-entrant
        # here) into a small ring the replication hub stamps VERIFY
        # frames from.  0 = off: a leader with no verify-capable
        # follower pays nothing.
        self.verify_n = 0
        self._verify_crcs: dict[int, int] = {}
        self.verify_points = 0
        # mirrors the durable quarantine marker (serve/scrub.py): True
        # refuses reads typed (`ERR diverged`) until the snapshot
        # re-sync re-verifies and durably clears it
        self.quarantined = False
        self._load_snapshot(snap)

    def _load_snapshot(self, snap: ServeSnapshot) -> None:
        """(Re)build every piece of in-memory serving state from one
        snapshot — the shared tail of __init__ and the follower full
        resync (:meth:`reset_from_snapshot`)."""
        self._mut_begin()
        try:
            self._load_snapshot_inner(snap)
        finally:
            self._mut_end()

    def _load_snapshot_inner(self, snap: ServeSnapshot) -> None:
        self.seq = np.asarray(snap.seq, dtype=np.uint32)
        self.parent = np.asarray(snap.parent, dtype=np.uint32).copy()
        self.pst = np.asarray(snap.pst, dtype=np.uint32).copy()
        self.parts = np.asarray(snap.parts, dtype=np.int64).copy()
        self.num_parts = snap.num_parts
        self.balance = snap.balance
        self.applied_seqno = snap.applied_seqno
        # everything up to the snapshot boundary is durable by
        # definition; the group-commit coordinator advances this as its
        # shared fsyncs land, and replication senders never ship past it
        self.durable_seqno = snap.applied_seqno
        self.drift_cut = snap.drift_cut
        self.baseline_ecv = snap.baseline_ecv
        self.graph_path = snap.graph_path or None
        self.sig = snap.sig
        self.epoch = snap.epoch
        self.epoch_base = snap.epoch_base
        self.pos = sequence_positions(self.seq,
                                      max(len(self.parts) - 1, 0))
        self.ins_tail: list[int] = [int(x) for x in snap.ins_tail]
        self.ins_head: list[int] = [int(x) for x in snap.ins_head]
        self._inserts_since_snap = 0
        self._subtree_cache = None
        self._part_lut = None
        self._link_skip = None  # ancestor memo is per-tree: new tree, new memo
        # replication bookkeeping: an in-memory window of recent records
        # (seqno, payload) follower senders stream from without touching
        # the file.  Deliberately DECOUPLED from the WAL swap: a seal
        # must not strand a follower that is one record behind, so the
        # window survives seals and is trimmed by count instead
        # (repl_floor = the seqno just before the oldest retained
        # record; anything at or below it needs a snapshot bootstrap).
        self._wal_tail: list[tuple[int, bytes]] = []
        self.repl_floor = snap.applied_seqno
        # trace-context forwarding: seqno -> rid for records
        # still in the replication window, so the hub can stamp APPEND
        # frames with the originating request's id (trimmed with the
        # window — a bootstrapping follower has no rids to forward)
        self._rid_tail: dict[int, str] = {}

        self.edges_tail = None
        self.edges_head = None
        if self.graph_path:
            try:
                from ..io.edges import load_edges
                el = load_edges(self.graph_path)
                self.edges_tail = el.tail
                self.edges_head = el.head
            except (OSError, IntegrityError) as exc:
                warnings.warn(
                    f"serve: graph {self.graph_path} unavailable ({exc}); "
                    f"ECV queries and drift baselines are disabled")
                self.graph_path = None

        # the incremental degree histogram: adopt the
        # snapshot's when it carries one (and still matches the vid
        # domain), else recount from the resident edge set — the one-off
        # upgrade path for pre-reseq snapshots
        self.seq_gen = snap.seq_gen
        self.seq_drift = snap.seq_drift
        self.reseqs = snap.reseqs
        self.ins_base = min(snap.ins_base, len(self.ins_tail))
        n_v = len(self.parts)
        if snap.deg is not None and len(snap.deg) == n_v:
            self.deg = np.asarray(snap.deg, dtype=np.int64).copy()
            self.deg_base = np.asarray(snap.deg_base,
                                       dtype=np.int64).copy()
        else:
            tail, head = self._all_edges()
            self.deg = host_degree_histogram(tail, head, n_v)
            ins_deg = host_degree_histogram(
                np.asarray(self.ins_tail, dtype=np.uint32),
                np.asarray(self.ins_head, dtype=np.uint32), n_v)
            self.deg_base = self.deg - ins_deg

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def bootstrap(cls, state_dir: str,
                  tre_path: str | None = None,
                  seq_path: str | None = None,
                  graph_path: str | None = None,
                  parts_path: str | None = None,
                  num_parts: int = 2,
                  balance: float = 1.03,
                  integrity: str | None = None,
                  **core_kw) -> "ServeCore":
        """First start: load artifacts through the strict integrity
        readers, partition, seal generation 0, create the WAL, then enter
        through :meth:`open` so bootstrap exercises the exact recovery
        path every later restart takes."""
        from ..io.seqfile import read_sequence
        from ..io.trefile import read_tree
        if (tre_path is None) != (seq_path is None):
            raise ValueError("bootstrap needs BOTH -T tree and -s sequence "
                             "(or neither, with a graph to build from)")
        if tre_path is None:
            if graph_path is None:
                raise ValueError("bootstrap needs a tree+sequence or a "
                                 "graph to build them from")
            from ..core.forest import build_forest
            from ..core.sequence import degree_sequence
            from ..io.edges import load_edges
            el = load_edges(graph_path)
            seq = degree_sequence(el.tail, el.head)
            forest = build_forest(el.tail, el.head, seq,
                                  max_vid=el.max_vid)
            parent, pst = forest.parent, forest.pst_weight
            max_vid = el.max_vid
        else:
            seq = read_sequence(seq_path, binary="auto",
                                integrity=integrity)
            parent, pst = read_tree(tre_path, integrity=integrity)
            if len(parent) != len(seq):
                raise MalformedArtifact(
                    f"{tre_path}: tree has {len(parent)} nodes but "
                    f"{seq_path} orders {len(seq)} vertices — not a pair")
            max_vid = int(seq.max()) if len(seq) else 0
            if graph_path is not None:
                from ..io.edges import load_edges
                el = load_edges(graph_path)
                max_vid = max(max_vid, el.max_vid)

        n_v = max_vid + 1 if len(seq) else 0
        if parts_path is not None:
            from ..partition.partition import Partition
            part = Partition.from_file(seq, parts_path)
            parts = np.full(n_v, INVALID_PART, dtype=np.int64)
            parts[: len(part.parts)] = part.parts[:n_v]
            num_parts = part.num_parts
        else:
            jparts = partition_forest(
                Forest(parent, pst), num_parts,
                TreePartitionOptions(balance_factor=balance))
            parts = np.full(n_v, INVALID_PART, dtype=np.int64)
            parts[seq] = jparts

        sig = input_signature(len(seq), seq)
        baseline = -1
        if graph_path is not None:
            pos = sequence_positions(seq, n_v - 1 if n_v else None)
            baseline = ecv_down(parts, el.tail, el.head, pos)

        os.makedirs(state_dir, exist_ok=True)
        gc_orphan_temps(state_dir)
        snap = ServeSnapshot(
            seq=seq, parent=parent, pst=pst, parts=parts,
            num_parts=num_parts, applied_seqno=0,
            ins_tail=np.empty(0, np.uint32), ins_head=np.empty(0, np.uint32),
            drift_cut=0, baseline_ecv=baseline,
            graph_path=os.path.abspath(graph_path) if graph_path else "",
            sig=sig, balance=balance)
        save_serve_snapshot(os.path.join(state_dir, snap_name(0)), snap)
        create_wal(wal_path(state_dir), sig)
        return cls.open(state_dir, integrity=integrity, **core_kw)

    @classmethod
    def open(cls, state_dir: str, integrity: str | None = None,
             **core_kw) -> "ServeCore":
        """Restart: newest loadable snapshot + WAL replay.  strict (the
        default) refuses a torn WAL or a corrupt newest snapshot; repair
        truncates the tear / falls back a snapshot generation, warning
        either way."""
        mode = resolve_policy(integrity)
        snaps = snap_paths(state_dir)
        if not snaps:
            raise MalformedArtifact(
                f"{state_dir}: no serve snapshots — not a serve state dir "
                f"(bootstrap one with `sheep serve -d DIR <artifacts>`)")
        loaded = []
        errors = []
        for path in reversed(snaps):
            try:
                loaded.append(load_serve_snapshot(path, integrity=mode))
            except (IntegrityError, OSError) as exc:
                errors.append(f"{path}: {exc}")
                if mode == "strict":
                    raise
                warnings.warn(
                    f"serve: snapshot {path} unusable ({exc}); falling "
                    f"back a generation")
        if not loaded:
            raise MalformedArtifact(
                f"{state_dir}: every snapshot generation is corrupt — "
                + "; ".join(errors))
        # the epoch is the senior key: a promotion or follower re-sync
        # that crashed mid-swap can leave a HIGHER-epoch snapshot under a
        # lower applied-seqno filename, and the later term always wins
        snap = max(loaded, key=lambda s: (s.epoch, s.applied_seqno))

        wpath = wal_path(state_dir)
        if not os.path.exists(wpath):
            if mode == "strict":
                raise MalformedArtifact(
                    f"{wpath}: WAL missing — any insert acknowledged after "
                    f"the last snapshot is unrecoverable; repair mode "
                    f"restarts from the snapshot alone")
            warnings.warn(f"serve: {wpath} missing; restarting the log "
                          f"from the snapshot alone (repair mode)")
            create_wal(wpath, snap.sig)
        elif mode != "strict":
            dropped = repair_wal(wpath)
            if dropped:
                warnings.warn(f"serve: truncated {dropped} torn byte(s) "
                              f"off {wpath}")
        wal_sig, wal_epoch, records, _, _ = read_wal(wpath, mode)
        if wal_sig != snap.sig:
            # a re-sequence changes the input signature ON PURPOSE; the
            # crash window between the new-generation snapshot seal and
            # the WAL swap leaves an old-sig log whose every record is
            # already in the snapshot.  The durable reseq manifest is
            # the sanction: without it (or with records past the
            # snapshot boundary) this is the torn mid-swap state fsck
            # refuses.
            from .reseq import sanctions_sig_change
            sanctioned = (
                sanctions_sig_change(state_dir, wal_sig, snap.sig)
                and (not records
                     or records[-1][0] <= snap.applied_seqno))
            if not sanctioned:
                raise IntegrityError(
                    f"{wpath}: WAL belongs to a different build input "
                    f"(log sig {wal_sig[:12]}..., snapshot "
                    f"{snap.sig[:12]}...) — refusing to replay")
            warnings.warn(
                f"serve: {wpath} predates the sealed re-sequence "
                f"(manifest-sanctioned sig change); swapping in a fresh "
                f"generation-{snap.seq_gen} log")
            create_wal(wpath, snap.sig, epoch=snap.epoch)
            wal_sig, wal_epoch, records = snap.sig, snap.epoch, []
        if wal_epoch > snap.epoch:
            # only reachable when repair mode fell back a snapshot
            # generation ACROSS a promotion: the epoch-E log starts after
            # the epoch-E snapshot this dir no longer has a readable copy
            # of, so replaying it onto the older snapshot would skip the
            # gap silently.  No mode can bridge that.
            raise MalformedArtifact(
                f"{wpath}: WAL epoch {wal_epoch} is ahead of snapshot "
                f"epoch {snap.epoch} — the snapshot that sealed epoch "
                f"{wal_epoch} is missing or unreadable; recovery cannot "
                f"bridge a promotion boundary")
        if wal_epoch < snap.epoch:
            if records and records[-1][0] > snap.applied_seqno:
                raise MalformedArtifact(
                    f"{wpath}: cross-epoch seqno overlap — epoch "
                    f"{wal_epoch} log reaches seqno {records[-1][0]} past "
                    f"the epoch-{snap.epoch} snapshot boundary "
                    f"{snap.applied_seqno}; a fenced log may never extend "
                    f"a later epoch's history")
            # benign crash window between the promotion seal and the WAL
            # swap: every surviving record is already in the snapshot
            warnings.warn(
                f"serve: {wpath} carries the pre-promotion epoch "
                f"{wal_epoch} (snapshot is {snap.epoch}); swapping in a "
                f"fresh epoch-{snap.epoch} log")
            create_wal(wpath, snap.sig, epoch=snap.epoch)
            records = []

        appender = WalAppender(wpath, expect_sig=snap.sig)
        core = cls(state_dir, snap, appender, **core_kw)
        for seqno, payload in records:
            if seqno <= core.applied_seqno:
                continue  # already folded into the snapshot
            core._apply_pairs(decode_inserts(payload))
            core.applied_seqno = seqno
            core._tail_push(seqno, payload)
        # replayed records came off the durable log
        core.durable_seqno = core.applied_seqno
        # A crash between snapshot seal and WAL swap leaves a log whose
        # last seqno <= applied; new records must still sort AFTER the
        # snapshot or the next replay would skip them.
        core._wal.next_seqno = max(core._wal.next_seqno,
                                   core.applied_seqno + 1)
        return core

    def close(self) -> None:
        try:
            self._wal.sync()
            self.durable_seqno = self.applied_seqno
        except OSError:
            pass  # unsynced records were never acked; replay truncates
        self._wal.close()

    # -- queries -----------------------------------------------------------
    #
    # Reads are LOCK-FREE: a seqlock'd published version.  The
    # read loop snapshots the version counter (odd = a writer is
    # mid-mutation), gathers from locally captured array refs, then
    # re-checks the counter — a bump in between means the gather may mix
    # generations and the attempt is discarded.  After _SEQLOCK_TRIES
    # failed attempts the read falls back to the state lock (bounded
    # starvation under a write storm).  Mixed-generation refs can also
    # raise IndexError (a reseq swap replaces pos/parent with different
    # lengths); that is a retry, not an error.

    def _mut_begin(self) -> None:
        self._version += 1  # odd: lock-free readers retry

    def _mut_end(self) -> None:
        self._version += 1  # even: stable again

    def _read_enter(self) -> int:
        """One seqlock read attempt's opening: the current version, or
        -1 when a write is in flight."""
        v = self._version
        return -1 if (v & 1) else v

    def part(self, vid: int) -> int:
        """Part of ``vid`` (INVALID_PART = -1 when the vertex is absent
        from the partition — including vertices first seen by insert)."""
        for _ in range(_SEQLOCK_TRIES):
            v = self._read_enter()
            if v < 0:
                self.seqlock_retries += 1
                continue
            parts = self.parts
            res = int(parts[vid]) if 0 <= vid < len(parts) \
                else INVALID_PART
            if self._version == v:
                return res
            self.seqlock_retries += 1
        self.seqlock_fallbacks += 1
        with self._lock:
            if 0 <= vid < len(self.parts):
                return int(self.parts[vid])
            return INVALID_PART

    def parent_vid(self, vid: int):
        """Parent VERTEX of ``vid`` in the elimination tree: a vid,
        "root", or None when the vertex is not in the sequence."""
        for _ in range(_SEQLOCK_TRIES):
            v = self._read_enter()
            if v < 0:
                self.seqlock_retries += 1
                continue
            pos, parent, seq = self.pos, self.parent, self.seq
            try:
                res = self._parent_vid_from(vid, pos, parent, seq)
            except IndexError:  # mixed-generation refs mid-swap
                self.seqlock_retries += 1
                continue
            if self._version == v:
                return res
            self.seqlock_retries += 1
        self.seqlock_fallbacks += 1
        with self._lock:
            return self._parent_vid_from(vid, self.pos, self.parent,
                                         self.seq)

    @staticmethod
    def _parent_vid_from(vid, pos, parent, seq):
        if not (0 <= vid < len(pos)):
            return None
        j = int(pos[vid])
        if j == INVALID_JNID:
            return None
        p = int(parent[j])
        if p == INVALID_JNID:
            return "root"
        return int(seq[p])

    def subtree(self, vid: int):
        """(size, pst_total) of the subtree rooted at ``vid`` (inclusive),
        or None when the vertex is not in the sequence.  O(n) on the first
        query after a mutation, O(1) after (cached aggregates)."""
        for _ in range(_SEQLOCK_TRIES):
            v = self._read_enter()
            if v < 0:
                self.seqlock_retries += 1
                continue
            pos = self.pos
            try:
                if not (0 <= vid < len(pos)):
                    res = None
                else:
                    j = int(pos[vid])
                    if j == INVALID_JNID:
                        res = None
                    else:
                        agg = self._subtree_aggregates_at(v)
                        if agg is None:
                            self.seqlock_retries += 1
                            continue
                        size, wsum = agg
                        res = (int(size[j]), int(wsum[j]))
            except IndexError:
                self.seqlock_retries += 1
                continue
            if self._version == v:
                return res
            self.seqlock_retries += 1
        self.seqlock_fallbacks += 1
        with self._lock:
            if not (0 <= vid < len(self.pos)):
                return None
            j = int(self.pos[vid])
            if j == INVALID_JNID:
                return None
            size, wsum = self._subtree_aggregates()
            return int(size[j]), int(wsum[j])

    def _subtree_aggregates(self):
        """(size, wsum) per jnid, cached until the next mutation.  Caller
        holds the state lock (the version is therefore even and stable)."""
        return self._subtree_aggregates_at(self._version)

    def _subtree_aggregates_at(self, v: int):
        """(size, wsum) per jnid as of version ``v``, or None when a
        mutation raced the O(n) build.  The cache is keyed by the version
        it was built under, so a stale entry can never be served and a
        torn build is never stored."""
        cache = self._subtree_cache
        if cache is not None and cache[0] == v:
            return cache[1], cache[2]
        parent = self.parent
        pst = self.pst
        m = len(parent)
        if len(pst) != m:  # mixed-generation refs mid-swap
            return None
        # parents strictly later: one pass, in the native library (a
        # python loop costs over a microsecond a node: seconds for each
        # query after a mutation at 2^23 nodes)
        from .. import native
        size, wsum = native.subtree_aggregates(parent, pst)
        if self._version != v:
            return None
        self._subtree_cache = (v, size, wsum)
        return size, wsum

    # -- vectorized batch queries -------------------------------
    #
    # The hot read path: one lock acquisition and one numpy gather per
    # BATCH instead of per vertex.  Answers are element-for-element what
    # the scalar methods return (the grammar property tests hold the two
    # paths bit-identical), sentinels included: INVALID_PART for a vid
    # outside the partition, PARENT_ABSENT/PARENT_ROOT for the tree walk.

    def part_batch(self, vids: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`part`: int64 parts, INVALID_PART where the
        vid is outside the partition tables."""
        vids = np.asarray(vids, dtype=np.int64)
        for _ in range(_SEQLOCK_TRIES):
            v = self._read_enter()
            if v < 0:
                self.seqlock_retries += 1
                continue
            parts = self.parts
            out = np.full(vids.shape, INVALID_PART, dtype=np.int64)
            ok = (vids >= 0) & (vids < len(parts))
            out[ok] = parts[vids[ok]]
            if self._version == v:
                return out
            self.seqlock_retries += 1
        self.seqlock_fallbacks += 1
        with self._lock:
            out = np.full(vids.shape, INVALID_PART, dtype=np.int64)
            ok = (vids >= 0) & (vids < len(self.parts))
            out[ok] = self.parts[vids[ok]]
            return out

    def part_tokens(self, vids: np.ndarray) -> str:
        """:meth:`part_batch` rendered as the wire token list.  Part ids
        live in the tiny domain [-1, num_parts), so the render is a
        cached string-table lookup instead of 1000 ``str()`` calls —
        str() was half the batched PART budget once the gather
        vectorized."""
        out = self.part_batch(vids)
        lut = self._part_lut
        if lut is None or len(lut) < self.num_parts + 1:
            lut = self._part_lut = [str(i)
                                    for i in range(-1, self.num_parts)]
        try:
            return " ".join([lut[x] for x in (out + 1).tolist()])
        except IndexError:  # parts file named more parts than num_parts
            return " ".join(map(str, out.tolist()))

    @staticmethod
    def _parent_batch_from(vids, pos, parent, seq):
        out = np.full(vids.shape, PARENT_ABSENT, dtype=np.int64)
        ok = (vids >= 0) & (vids < len(pos))
        j = pos[vids[ok]].astype(np.int64)
        present = j != INVALID_JNID
        res = np.full(j.shape, PARENT_ABSENT, dtype=np.int64)
        pj = parent[j[present]].astype(np.int64)
        rooted = pj == INVALID_JNID
        val = seq[np.where(rooted, 0, pj)].astype(np.int64)
        res[present] = np.where(rooted, PARENT_ROOT, val)
        out[ok] = res
        return out

    def parent_batch(self, vids: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`parent_vid`: int64 parent vids, with
        PARENT_ROOT (-1) for roots and PARENT_ABSENT (-2) where the vid
        is not in the sequence."""
        vids = np.asarray(vids, dtype=np.int64)
        for _ in range(_SEQLOCK_TRIES):
            v = self._read_enter()
            if v < 0:
                self.seqlock_retries += 1
                continue
            pos, parent, seq = self.pos, self.parent, self.seq
            try:
                out = self._parent_batch_from(vids, pos, parent, seq)
            except IndexError:  # mixed-generation refs mid-swap
                self.seqlock_retries += 1
                continue
            if self._version == v:
                return out
            self.seqlock_retries += 1
        self.seqlock_fallbacks += 1
        with self._lock:
            return self._parent_batch_from(vids, self.pos, self.parent,
                                           self.seq)

    def subtree_batch(self, vids: np.ndarray):
        """Vectorized :meth:`subtree`: (size, pst_total) int64 arrays,
        -1 in both where the vid is not in the sequence."""
        vids = np.asarray(vids, dtype=np.int64)

        def gather(pos, size, wsum):
            out_s = np.full(vids.shape, -1, dtype=np.int64)
            out_w = np.full(vids.shape, -1, dtype=np.int64)
            ok = (vids >= 0) & (vids < len(pos))
            j = pos[vids[ok]].astype(np.int64)
            present = j != INVALID_JNID
            s = np.full(j.shape, -1, dtype=np.int64)
            w = np.full(j.shape, -1, dtype=np.int64)
            s[present] = size[j[present]]
            w[present] = wsum[j[present]]
            out_s[ok] = s
            out_w[ok] = w
            return out_s, out_w

        for _ in range(_SEQLOCK_TRIES):
            v = self._read_enter()
            if v < 0:
                self.seqlock_retries += 1
                continue
            pos = self.pos
            agg = self._subtree_aggregates_at(v)
            if agg is None:
                self.seqlock_retries += 1
                continue
            try:
                out = gather(pos, agg[0], agg[1])
            except IndexError:  # mixed-generation refs mid-swap
                self.seqlock_retries += 1
                continue
            if self._version == v:
                return out
            self.seqlock_retries += 1
        self.seqlock_fallbacks += 1
        with self._lock:
            size, wsum = self._subtree_aggregates()
            return gather(self.pos, size, wsum)

    def state_crc(self) -> int:
        """crc32 over every serving-state array — the cheap bit-identity
        fingerprint the tenant isolation and evict/restore tests compare
        (two cores answer identically iff their crcs match)."""
        import zlib
        with self._lock:
            crc = 0
            for arr in (self.seq, self.parent, self.pst, self.parts,
                        np.asarray(self.ins_tail, dtype=np.uint32),
                        np.asarray(self.ins_head, dtype=np.uint32)):
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
            return crc & 0xFFFFFFFF

    # -- anti-entropy ------------------------------------------

    def enable_verify(self, every_n: int) -> None:
        """Start (or retune) verify-point capture: every ``every_n``-th
        applied seqno gets its state_crc recorded for VERIFY stamping.
        Called by the hub when a verify-capable follower attaches."""
        with self._lock:
            self.verify_n = max(0, int(every_n))
            if not self.verify_n:
                self._verify_crcs.clear()

    def _capture_verify(self, seqno: int) -> None:
        """Under the state lock, right after ``applied_seqno`` advanced:
        record the crc that names this exact seqno's state."""
        n = self.verify_n
        if not n or seqno % n:
            return
        self._verify_crcs[seqno] = self.state_crc()
        self.verify_points += 1
        while len(self._verify_crcs) > 32:
            self._verify_crcs.pop(next(iter(self._verify_crcs)))

    def verify_crc(self, seqno: int) -> int | None:
        """The captured verify-point crc for ``seqno`` (None when the
        seqno is not a verify point or fell out of the ring)."""
        with self._lock:
            return self._verify_crcs.get(seqno)

    def corrupt_one_byte(self) -> int:
        """TEST/BENCH ONLY (the daemon gates the CORRUPT verb behind
        ``SHEEP_SCRUB_ALLOW_CORRUPT=1``): flip one bit of an inserted-edge
        endpoint in the live serving state — the silent-corruption shape
        the anti-entropy stream exists to catch.  state_crc changes; the
        WAL and snapshots do not (nothing was written), so only stream
        VERIFY can see it.  Returns the new state_crc.  Raises
        RuntimeError when there are no inserted edges to corrupt."""
        with self._lock:
            if not self.ins_head:
                raise RuntimeError("corrupt_one_byte: no inserted edges")
            self._mut_begin()
            try:
                self.ins_head[-1] = int(self.ins_head[-1]) ^ 0x1
            finally:
                self._mut_end()
            return self.state_crc()

    def ecv(self) -> dict:
        """Exact ECV(down) over (original + inserted) edges under the
        CURRENT partition, plus the drift accounting.  Raises
        RuntimeError when no graph edges are resident."""
        if self.edges_tail is None and self.graph_path is None:
            raise RuntimeError(
                "no graph edges resident (serve was started without a "
                "graph); ECV is unavailable")
        for _ in range(_SEQLOCK_TRIES):
            v = self._read_enter()
            if v < 0:
                self.seqlock_retries += 1
                continue
            parts, pos = self.parts, self.pos
            try:
                out = self._ecv_locked(parts, pos)
            except (IndexError, ValueError):
                # mixed-generation refs, or the ins lists grew between
                # the tail and head snapshots — discard and retry
                self.seqlock_retries += 1
                continue
            if self._version == v:
                return out
            self.seqlock_retries += 1
        self.seqlock_fallbacks += 1
        with self._lock:
            return self._ecv_locked(self.parts, self.pos)

    def _ecv_locked(self, parts, pos) -> dict:
        if self.edges_tail is None:
            raise RuntimeError(
                "no graph edges resident (serve was started without a "
                "graph); ECV is unavailable")
        tail, head = self._all_edges()
        if len(tail) != len(head):
            raise ValueError("torn ins tail/head snapshot")
        val = ecv_down(parts, tail, head, pos)
        return {"ecv_down": val, "baseline": self.baseline_ecv,
                "drift_cut": self.drift_cut,
                "seq_drift": self.seq_drift,
                "reseqs": self.reseqs,
                "parts": int(parts.max(initial=0)) + 1}

    def stats(self) -> dict:
        with self._lock:
            linked = int((self.parent != INVALID_JNID).sum())
            return {
                "n": len(self.seq), "links": linked,
                "vids": len(self.parts),
                "epoch": self.epoch,
                "wal_seqno": self._wal.next_seqno - 1,
                "applied_seqno": self.applied_seqno,
                "inserted": len(self.ins_tail),
                "drift_cut": self.drift_cut,
                "seq_drift": self.seq_drift,
                "reseqs": self.reseqs,
                "seq_gen": self.seq_gen,
                "baseline_ecv": self.baseline_ecv,
                "repartitions": self.repartitions,
                "snap_failures": self.snap_failures,
                "durable_seqno": self.durable_seqno,
                "gc_fsyncs": self.gc_fsyncs,
                "gc_records": self.gc_records,
                "gc_size_p50": self._gc_size_quantile(0.5),
                "gc_size_p99": self._gc_size_quantile(0.99),
                "seqlock_retries": self.seqlock_retries,
                "seqlock_fallbacks": self.seqlock_fallbacks,
            }

    def _gc_size_quantile(self, q: float) -> int:
        """Quantile of recent group-commit sizes (records per shared
        fsync) over a sliding window of the last 512 groups."""
        sizes = sorted(self._gc_sizes)
        if not sizes:
            return 0
        k = min(len(sizes) - 1, int(q * len(sizes)))
        return int(sizes[k])

    def _all_edges(self):
        ins_t = np.asarray(self.ins_tail, dtype=np.uint32)
        ins_h = np.asarray(self.ins_head, dtype=np.uint32)
        if self.edges_tail is None:
            return ins_t, ins_h
        return (np.concatenate([self.edges_tail, ins_t]),
                np.concatenate([self.edges_head, ins_h]))

    # -- inserts -----------------------------------------------------------

    def insert(self, pairs: np.ndarray, rid: str | None = None) -> int:
        """Accept one batch of edges: WAL append (DEFERRED fsync) +
        in-memory apply under a short critical section, then park on the
        shared group-commit ticket until one fsync seals the whole group
        (:meth:`_group_commit`) — the leader-side analogue of the
        follower burst seal.  Returns the batch's seqno only
        AFTER the covering fsync: the durability contract is unchanged
        (nothing the caller acknowledges can be lost), only the fsync is
        amortized across every insert in flight.

        Fault sites (serve/faults): ``gc-append`` before the deferred
        append, ``gc-unsynced`` after append+apply but before the shared
        fsync (both may lose the never-acked record), then ``wal`` /
        ``apply`` after the fsync — the record is durable there, so a
        kill MUST recover it from the log.  A DiskExhausted/WriteFault
        from the append propagates with NOTHING applied or logged; a
        failed GROUP fsync propagates to every waiter it covered and
        none of them acknowledge.  ``rid`` (the request's trace-context
        id) is retained alongside the replication window so
        APPEND frames forward it, and the shared ``wal.fsync`` span is
        attributed to every rid it seals."""
        pairs = np.ascontiguousarray(pairs, dtype=np.uint32)
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            raise ValueError(f"insert batch must be (k, 2), got "
                             f"{pairs.shape}")
        with self._lock:
            payload = encode_inserts(pairs)
            self._fire("gc-append")
            seqno = self._wal.append(payload, sync=False)
            self._apply_pairs(pairs)
            self.applied_seqno = seqno
            self._capture_verify(seqno)
            self._tail_push(seqno, payload, rid)
            self._fire("gc-unsynced")
            self._inserts_since_snap += 1
            if self._inserts_since_snap >= self.snap_every:
                self.maybe_seal()  # the seal itself makes the group durable
        self._group_commit(seqno, rid)
        self._fire("wal")
        self._fire("apply")
        return seqno

    def _group_commit(self, seqno: int, rid: str | None) -> None:
        """Park until ``seqno`` is durable.  One waiter elects itself
        group leader and pays the shared fsync for everything appended
        so far; the rest sleep on the ticket.  A lone insert becomes
        leader instantly and fsyncs with no window (idle latency
        unchanged); with company the leader stretches the window by up
        to ``group_commit_delay_s`` while the group is still under
        ``group_commit_max`` records.  A failed fsync propagates to
        EVERY waiter whose record it covered."""
        cv = self._gc_cv
        with cv:
            if rid is not None:
                self._gc_rids.append((seqno, rid))
            cv.notify_all()  # a delaying leader re-checks the group size
            while True:
                if self.durable_seqno >= seqno:
                    return
                err = self._gc_err
                if err is not None and seqno <= self._gc_err_seq:
                    raise err
                if not self._gc_leader:
                    self._gc_leader = True
                    break
                cv.wait(0.1)
        try:
            delay = self.group_commit_delay_s
            if delay > 0:
                deadline = time.monotonic() + delay
                with cv:
                    while True:
                        pending = self.applied_seqno - self.durable_seqno
                        if pending <= 1 or pending >= self.group_commit_max:
                            break  # lone insert or a full window: go now
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        cv.wait(left)
            prev = self.durable_seqno
            with cv:
                rids = [r for s, r in self._gc_rids if s > prev]
                del self._gc_rids[:]
            newest = rids[-1] if rids else None
            attrs = {"records": self.applied_seqno - prev}
            if rids:  # one span, many rids
                attrs["rids"] = ",".join(rids[-32:])
            try:
                with _trace.rid_scope(newest):
                    self.wal_sync(**attrs)
            except OSError as exc:
                with cv:
                    # fail every waiter the attempted fsync covered:
                    # none of their records may be acknowledged
                    self._gc_err = exc
                    self._gc_err_seq = self.applied_seqno
                raise
            with cv:
                self._gc_err = None
                group = self.durable_seqno - prev
                if group > 0:
                    self.gc_fsyncs += 1
                    self.gc_records += group
                    self._gc_sizes.append(group)
        finally:
            with cv:
                self._gc_leader = False
                cv.notify_all()

    def _fire(self, site: str) -> None:
        if self.fire_faults:
            serve_faults.fire(site)

    def _tail_push(self, seqno: int, payload: bytes,
                   rid: str | None = None) -> None:
        self._wal_tail.append((seqno, payload))
        if rid is not None:
            self._rid_tail[seqno] = rid
        if len(self._wal_tail) > REPL_TAIL_KEEP:
            drop = len(self._wal_tail) - REPL_TAIL_KEEP
            del self._wal_tail[:drop]
            self.repl_floor = self._wal_tail[0][0] - 1
            if self._rid_tail:
                floor = self.repl_floor
                for s in [s for s in self._rid_tail if s <= floor]:
                    del self._rid_tail[s]

    def rid_for(self, seqno: int) -> str | None:
        """The trace-context id of a retained record (None when the
        insert carried none or the window moved past it)."""
        return self._rid_tail.get(seqno)

    def apply_replicated(self, seqno: int, payload: bytes,
                         sync: bool = True,
                         rid: str | None = None) -> str:
        """Fold one record shipped by the leader into a FOLLOWER's state
        (serve/replicate.py).  The record lands in the local WAL under
        the leader's seqno (same durability order as :meth:`insert`:
        append + fsync -> apply), so a follower crash recovers through
        the exact snapshot+replay path a leader does.

        ``sync=False`` defers the WAL fsync (batched follower acks): the
        applier folds a whole APPEND burst, then pays ONE
        :meth:`wal_sync` before its single cumulative ACK — nothing is
        ever acknowledged ahead of its fsync, and a crash mid-burst
        loses only unacknowledged records (recovery replays the durable
        prefix, a valid earlier boundary).

        Returns ``"applied"`` or ``"dup"`` (seqno already applied — a
        re-sent frame, dropped idempotently).  A seqno that would leave
        a gap raises :class:`ReplicationGap`: the stream lost a record
        (injected ``drop`` or a real torn connection) and the follower
        must re-sync from its applied seqno instead of corrupting order.
        """
        with self._lock:
            if seqno <= self.applied_seqno:
                return "dup"
            if seqno != self.applied_seqno + 1:
                raise ReplicationGap(self.applied_seqno + 1, seqno)
            pairs = decode_inserts(payload)  # refuse garbage pre-append
            self._wal.append_at(seqno, payload, sync=sync)
            self._fire("wal")
            self._apply_pairs(pairs)
            self.applied_seqno = seqno
            self._capture_verify(seqno)
            if sync:
                self.durable_seqno = seqno
            self._tail_push(seqno, payload, rid)
            if self.on_append is not None:
                self.on_append()  # chained replication / status hooks
            self._fire("apply")
            self._inserts_since_snap += 1
            if self._inserts_since_snap >= self.snap_every:
                self.maybe_seal()
            return "applied"

    def wal_sync(self, **attrs) -> None:
        """Seal a deferred-fsync burst (follower :meth:`apply_replicated`
        ``sync=False`` bursts and leader group commits alike): one fsync
        covering every unsynced append.  The caller acknowledges only
        after this returns.  ``attrs`` annotate the shared ``wal.fsync``
        span (group size, covered rids)."""
        with self._lock:
            self._wal.sync(**attrs)
            if self.durable_seqno != self.applied_seqno:
                self.durable_seqno = self.applied_seqno
                if self.on_append is not None:
                    self.on_append()  # durable advanced: wake the senders

    def records_from(self, seqno: int):
        """Replication backlog: every retained DURABLE record with a
        seqno beyond ``seqno``, or None when the request predates the
        retention window (the follower needs a snapshot bootstrap, not
        a stream).  Records past ``durable_seqno`` (appended but not yet
        group-fsync'd) are withheld: a follower must never hold a record
        its leader could still lose."""
        with self._lock:
            if seqno < self.repl_floor:
                return None
            durable = self.durable_seqno
            return [(s, p) for s, p in self._wal_tail
                    if seqno < s <= durable]

    def _apply_pairs(self, pairs: np.ndarray) -> None:
        """Fold one decoded batch into the live state (also the WAL
        replay path — keep it deterministic and side-effect-free beyond
        the state arrays).  Bumps the seqlock version around the whole
        batch so lock-free readers never observe a half-applied one.

        Vectorized: the per-pair bookkeeping — vid growth,
        the incremental degree histogram (two +1s per record, the
        bincount semantics of core.sequence.host_degree_histogram, so
        the counting-sort rebuild never needs a recount pass), position
        gathers, pst counts, and both drift detectors — runs as whole-
        batch numpy ops in :meth:`_fold_links`; only the order-dependent
        tree links still walk one at a time (``native.insert_links``,
        the loop of :func:`insert_link` in the native library).  The
        rank-drift test therefore sees the BATCH's full degree counts rather than a mid-batch prefix — detection
        moves at most a few records earlier, and stays deterministic
        because every path (live insert, WAL replay, follower apply)
        folds identical record batches through this same code."""
        self._mut_begin()
        try:
            self._subtree_cache = None
            if len(pairs) == 0:
                return
            us = pairs[:, 0].astype(np.int64)
            vs = pairs[:, 1].astype(np.int64)
            self._ensure_vid(int(max(us.max(), vs.max())))
            self.ins_tail.extend(us.tolist())
            self.ins_head.extend(vs.tolist())
            np.add.at(self.deg, us, 1)
            np.add.at(self.deg, vs, 1)
            self._fold_links(us, vs)
        finally:
            self._mut_end()

    def _link_skip_for(self) -> np.ndarray:
        """The tree's ancestor memo for :func:`insert_link`, allocated
        lazily and dropped whenever :attr:`parent` is swapped (snapshot
        load, re-sequence).  Caller holds the state lock."""
        skip = self._link_skip
        if skip is None or len(skip) != len(self.parent):
            skip = np.full(len(self.parent), INVALID_JNID, dtype=np.uint32)
            self._link_skip = skip
        return skip

    def _fold_links(self, us: np.ndarray, vs: np.ndarray) -> None:
        """The incremental transform for a batch of edges (int64 vids)
        already counted into ``deg`` and the ins lists: position
        mapping, pst, tree links in order, and both drift detectors.
        Shared by the live insert/replay path and the post-cut replay of
        :meth:`reseq_swap` — the determinism of this fold is what makes
        a resumed re-sequence bit-identical.  Caller holds the state
        lock inside a seqlock write."""
        inv = int(INVALID_JNID)
        pu = self.pos[us].astype(np.int64)
        pv = self.pos[vs].astype(np.int64)
        nonself = us != vs
        # sequence drift (distinct from cut drift): the edge landed
        # outside the fixed sequence, or an endpoint's degree rank moved
        # far enough that the fixed order is now lying
        absent = (pu == inv) | (pv == inv)
        moved = ((self.deg[us] - self.deg_base[us] >= self.reseq_rank)
                 | (self.deg[vs] - self.deg_base[vs] >= self.reseq_rank))
        self.seq_drift += int(np.count_nonzero(nonself & (absent | moved)))
        live = pu != pv  # self-loops and both-absent pairs are inert
        lo = np.minimum(pu, pv)[live]
        hi = np.maximum(pu, pv)[live]
        # pst counts at the present earlier endpoint (INVALID is the
        # uint32 max, so min() lands on the present one)
        np.add.at(self.pst, lo, 1)
        linkable = (hi != inv) & (hi < len(self.parent))
        if np.any(linkable):
            # the insert_link loop, in one native call (the python
            # climbs take tens of ms a batch on deep chains)
            from .. import native
            native.insert_links(self.parent, self._link_skip_for(),
                                lo[linkable], hi[linkable])
            lu = us[live][linkable]
            lv = vs[live][linkable]
            # drift: a cut insert raises ECV(down) by at most one
            self.drift_cut += int(np.count_nonzero(
                self.parts[lu] != self.parts[lv]))

    def _ensure_vid(self, vid: int) -> None:
        """Grow the vid-indexed tables over a never-seen vertex (absent
        from the sequence: pst-only until a future re-sequence)."""
        if vid < len(self.parts):
            return
        grow = vid + 1 - len(self.parts)
        self.parts = np.concatenate(
            [self.parts, np.full(grow, INVALID_PART, dtype=np.int64)])
        self.pos = np.concatenate(
            [self.pos, np.full(grow, INVALID_JNID, dtype=np.uint32)])
        zeros = np.zeros(grow, dtype=np.int64)
        self.deg = np.concatenate([self.deg, zeros])
        self.deg_base = np.concatenate([self.deg_base, zeros])

    # -- snapshots ---------------------------------------------------------

    def seal_snapshot(self) -> str:
        """Seal the current state as a new snapshot generation, swap in a
        fresh WAL, and GC old generations (keep :data:`KEEP_SNAPSHOTS`).
        Raises on failure with the previous generation + log intact."""
        with self._lock:
            snap = ServeSnapshot(
                seq=self.seq, parent=self.parent, pst=self.pst,
                parts=self.parts, num_parts=self.num_parts,
                applied_seqno=self.applied_seqno,
                ins_tail=np.asarray(self.ins_tail, dtype=np.uint32),
                ins_head=np.asarray(self.ins_head, dtype=np.uint32),
                drift_cut=self.drift_cut, baseline_ecv=self.baseline_ecv,
                graph_path=self.graph_path or "", sig=self.sig,
                balance=self.balance, epoch=self.epoch,
                epoch_base=self.epoch_base, deg=self.deg,
                deg_base=self.deg_base, seq_drift=self.seq_drift,
                reseqs=self.reseqs, seq_gen=self.seq_gen,
                ins_base=self.ins_base)
            path = os.path.join(self.state_dir,
                                snap_name(self.applied_seqno))
            save_serve_snapshot(path, snap, self.governor)
            # the snapshot is durable: later records are redundant — swap
            # in a fresh log.  A crash between the two leaves <=applied
            # records in the old log, which replay skips by seqno.
            create_wal(wal_path(self.state_dir), self.sig,
                       epoch=self.epoch)
            self._wal.close()
            self._wal = WalAppender(wal_path(self.state_dir),
                                    expect_sig=self.sig)
            self._wal.next_seqno = self.applied_seqno + 1
            self._inserts_since_snap = 0
            # the durable snapshot covers every applied record, synced
            # or not: group-commit waiters parked on the old log are
            # released by the seal itself
            if self.durable_seqno != self.applied_seqno:
                self.durable_seqno = self.applied_seqno
                if self.on_append is not None:
                    self.on_append()
            with self._gc_cv:
                self._gc_cv.notify_all()
            # the replication window deliberately survives the swap:
            # followers one record behind keep streaming (trim is by
            # count, _tail_push), only the on-disk log starts fresh
            self._gc_snapshots(keep=KEEP_SNAPSHOTS)
            return path

    def maybe_seal(self) -> str | None:
        """Cadence-driven seal that refuses to die: a full disk or an
        injected snap/ENOSPC fault is counted and the daemon keeps
        serving off the WAL (which already holds every acked insert)."""
        try:
            return self.seal_snapshot()
        except OSError as exc:
            self.snap_failures += 1
            self._inserts_since_snap = 0  # retry at the NEXT cadence
            warnings.warn(f"serve: snapshot seal failed ({exc}); "
                          f"continuing on the WAL")
            return None

    def _gc_snapshots(self, keep: int) -> None:
        for path in snap_paths(self.state_dir)[:-keep]:
            for p in (path, sidecar_path(path)):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    # -- replication epoch transitions -------------------------------------

    def advance_epoch(self, new_epoch: int) -> str:
        """Move this state into a later replication term: archive the
        outgoing epoch's log (the fsck audit trail for the promotion
        boundary), bump the epoch, and seal a snapshot so the boundary
        is durable before anyone is told about it.  Used by a follower
        PROMOTING to leader and by a follower ADOPTING a new leader's
        epoch mid-stream (serve/cluster.py, serve/replicate.py).

        Raises with the epoch UNCHANGED if the seal fails — a promotion
        that cannot persist its fence must not claim it."""
        with self._lock:
            if new_epoch <= self.epoch:
                raise ValueError(
                    f"epoch must advance: {new_epoch} <= {self.epoch}")
            wpath = wal_path(self.state_dir)
            arch = os.path.join(self.state_dir,
                                archived_wal_name(self.epoch))
            try:
                import shutil
                shutil.copyfile(wpath, arch)
                with open(arch, "rb") as f:
                    os.fsync(f.fileno())
                # the archive bypasses atomic_write (a straight copy), so
                # the post-seal rot seam fires here explicitly: archived
                # epoch WALs are scrubbable artifacts like any other
                from ..io import faultfs
                faultfs.rot_after_seal(arch)
            except OSError as exc:
                # the archive is an audit artifact, not a recovery
                # dependency (every record is in the sealed snapshot)
                warnings.warn(f"serve: could not archive epoch-"
                              f"{self.epoch} WAL ({exc})")
            old = self.epoch
            old_base = self.epoch_base
            self.epoch = new_epoch
            self.epoch_base = self.applied_seqno
            try:
                return self.seal_snapshot()
            except BaseException:
                self.epoch = old
                self.epoch_base = old_base
                raise

    def reset_from_snapshot(self, snap: ServeSnapshot,
                            allow_sig_change: bool = False,
                            allow_gen_rollback: bool = False,
                            allow_rollback: bool = False) -> None:
        """Follower full re-sync: discard the local chain and adopt a
        snapshot shipped by the leader (the stream could not be resumed
        — the follower lagged past the leader's WAL, or carries a fenced
        ex-leader's divergent tail).  Every intermediate crash window
        re-opens consistently: the local log is emptied FIRST (the local
        history is being discarded either way), the adopted snapshot is
        sealed under its own epoch, and only then is the stale chain
        removed — :meth:`open` prefers the higher epoch throughout.

        ``allow_sig_change`` — the leader re-sequenced: the
        adopted snapshot carries a LATER sequence generation under a new
        input signature.  The caller must have written the local reseq
        manifest sanctioning old->new first, or a crash mid-adoption
        leaves a sig mismatch :meth:`open` correctly refuses.

        ``allow_gen_rollback`` — the CLUSTER lost our generation: this replica applied a re-sequence swap the failed leader
        never quorum-acked, and the surviving leader's chain has never
        seen our sig.  Rolling back to the leader's (older) generation
        is then the only exit that doesn't strand the replica in a
        ``badrepl`` retry loop.  It is sound because nothing a client
        was ever acked lives only in the orphaned generation (the swap
        itself carries no client writes, and the surviving leader holds
        every quorum-acked record); the caller MUST have written the
        adoption manifest (reseq.write_adoption) sanctioning the
        rollback first, same discipline as ``allow_sig_change``.

        ``allow_rollback`` — quarantine healing: the stream
        anti-entropy check proved this replica's tail DIVERGENT, so
        adopting the leader's (possibly older-seqno) snapshot and
        re-streaming from its boundary is the point, not an accident.
        Sound because every acked record past the snapshot boundary is
        in the leader's chain and re-ships on reconnect; the caller must
        hold the durable quarantine marker (serve/scrub.py) sanctioning
        the discard, same discipline as the other two flags."""
        snap.validate()
        with self._lock:
            if snap.sig != self.sig and not (
                    allow_sig_change and (snap.seq_gen > self.seq_gen
                                          or allow_gen_rollback)):
                raise IntegrityError(
                    f"replication snapshot belongs to a different build "
                    f"input (sig {snap.sig[:12]}..., ours "
                    f"{self.sig[:12]}...) — refusing to adopt")
            if (snap.epoch, snap.applied_seqno) < (self.epoch,
                                                   self.applied_seqno) \
                    and not (allow_gen_rollback or allow_rollback):
                raise IntegrityError(
                    f"replication snapshot (epoch {snap.epoch}, seqno "
                    f"{snap.applied_seqno}) is older than the local state "
                    f"(epoch {self.epoch}, seqno {self.applied_seqno}) — "
                    f"refusing to roll back")
            old_snaps = snap_paths(self.state_dir)
            from .wal import archived_wal_paths
            for p in archived_wal_paths(self.state_dir):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            # 1. empty the local log (old epoch): the divergent/lagged
            #    tail is discarded by design, and the dir still opens
            self._wal.close()
            create_wal(wal_path(self.state_dir), self.sig,
                       epoch=self.epoch)
            # 2. seal the adopted snapshot; open() now picks it by epoch
            path = os.path.join(self.state_dir,
                                snap_name(snap.applied_seqno))
            save_serve_snapshot(path, snap, self.governor)
            # 3. fresh log for the adopted epoch (and, after a leader
            #    re-sequence, the adopted SIGNATURE), then drop the
            #    stale chain
            create_wal(wal_path(self.state_dir), snap.sig,
                       epoch=snap.epoch)
            self._wal = WalAppender(wal_path(self.state_dir),
                                    expect_sig=snap.sig)
            self._wal.next_seqno = snap.applied_seqno + 1
            for p in old_snaps:
                if p != path:
                    for q in (p, sidecar_path(p)):
                        try:
                            os.unlink(q)
                        except OSError:
                            pass
            self._load_snapshot(snap)

    def snapshot_bytes(self) -> tuple[bytes, int, int]:
        """Seal the current state and return ``(blob, applied_seqno,
        epoch)`` — the bootstrap payload a leader ships to a follower
        that cannot be served from the live WAL (serve/replicate.py)."""
        with self._lock:
            path = self.seal_snapshot()
            with open(path, "rb") as f:
                blob = f.read()
            return blob, self.applied_seqno, self.epoch

    # -- repartition -------------------------------------------------------

    def drift_exceeded(self) -> bool:
        """Has insert drift crossed the re-partition threshold?  The
        threshold is ``drift_frac`` of the baseline ECV(down) when one is
        known, floored at ``drift_min_cut`` cut inserts."""
        with self._lock:
            threshold = self.drift_min_cut
            if self.baseline_ecv > 0:
                threshold = max(threshold,
                                int(self.drift_frac * self.baseline_ecv))
            return self.drift_cut >= threshold

    def repartition(self) -> dict:
        """Re-run the tree partitioner over the CURRENT tree and swap the
        new part table in atomically.  The compute runs on copies outside
        the lock — queries keep answering from the stale partition until
        the swap."""
        with self._lock:
            forest = Forest(self.parent.copy(), self.pst.copy())
            num_parts = self.num_parts
            balance = self.balance
            ticket = self._repart_ticket
            self._repart_ticket += 1
        jparts = partition_forest(
            forest, num_parts, TreePartitionOptions(balance_factor=balance))
        with self._lock:
            if ticket <= self._repart_applied:
                # a repartition that STARTED later (fresher tree) already
                # swapped in; this stale result must not clobber it
                return {"parts": int(self.parts.max(initial=0)) + 1,
                        "baseline_ecv": self.baseline_ecv,
                        "stale": 1}
            self._repart_applied = ticket
            vparts = np.full(len(self.parts), INVALID_PART, dtype=np.int64)
            vparts[self.seq] = jparts
            self._mut_begin()
            try:
                self.parts = vparts
            finally:
                self._mut_end()
            self.drift_cut = 0
            self.repartitions += 1
            if self.edges_tail is not None:
                tail, head = self._all_edges()
                self.baseline_ecv = ecv_down(self.parts, tail, head,
                                             self.pos)
            # make the swap durable: without a seal a restart would
            # serve the PRE-repartition parts (the snapshot's) — legal
            # (stale-but-consistent) but a silent quality regression.
            # Best-effort: a full disk keeps the old generation and the
            # in-memory swap still serves.
            self.maybe_seal()
            return {"parts": int(vparts.max(initial=0)) + 1,
                    "baseline_ecv": self.baseline_ecv}

    # -- re-sequence --------------------------------------------
    #
    # Repartition re-bins the EXISTING tree; it cannot recover quality
    # lost to inserts that landed outside the bootstrap-fixed sequence
    # (pst-only vertices never enter the tree).  The re-sequence path
    # rebuilds sequence + tree + partition from the durable edge set
    # (graph .dat + WAL'd inserts) under a degree order that reflects
    # the churn, and swaps it in under the same ticket discipline.  The
    # heavy fold runs in serve/reseq.py (durable manifest, extmem fold,
    # kill-safe phases); the core owns only the bookkeeping and the
    # atomic swap.

    def recount_degrees(self) -> np.ndarray:
        """Full recount of the degree histogram over the RESIDENT edge
        set — the parity oracle for the incremental counters (only
        meaningful while the graph edges are resident or the core never
        had a graph)."""
        with self._lock:
            tail, head = self._all_edges()
            return host_degree_histogram(tail, head, len(self.parts))

    def degree_parity(self) -> bool:
        """Does the incrementally maintained histogram equal a full
        recount?  Asserted by the reseq driver before trusting the
        incremental counts for a sequence rebuild."""
        with self._lock:
            return bool(np.array_equal(self.deg, self.recount_degrees()))

    def seq_drift_exceeded(self) -> bool:
        """Has SEQUENCE drift (inserts the fixed order mis-handles)
        crossed the re-sequence threshold?  ``reseq_frac`` of the
        inserts past the current cut, with at least ``reseq_min``
        inserts observed first."""
        with self._lock:
            since = len(self.ins_tail) - self.ins_base
            if since < self.reseq_min:
                return False
            return self.seq_drift >= max(1, int(self.reseq_frac * since))

    def reseq_begin(self) -> dict:
        """Capture the inputs of one re-sequence attempt under the lock:
        the ticket (later-started wins, exactly the repartition rule)
        and the CUT — how many inserted edges the rebuild will cover.
        (durable edges + cut) fully determine the rebuilt state, which
        is what makes a crash-resumed rebuild bit-identical."""
        with self._lock:
            ticket = self._reseq_ticket
            self._reseq_ticket += 1
            return {
                "ticket": ticket,
                "cut": len(self.ins_tail),
                "num_parts": self.num_parts,
                "balance": self.balance,
                "graph_path": self.graph_path,
                "old_sig": self.sig,
                "seq_gen": self.seq_gen,
                "epoch": self.epoch,
                "applied_seqno": self.applied_seqno,
                "seq_drift": self.seq_drift,
                "deg": self.deg.copy(),
            }

    def ins_slice(self, cut: int):
        """The first ``cut`` WAL'd inserts as uint32 arrays (copies)."""
        with self._lock:
            return (np.asarray(self.ins_tail[:cut], dtype=np.uint32),
                    np.asarray(self.ins_head[:cut], dtype=np.uint32))

    def reseq_swap(self, ticket: int, cut: int, new_seq: np.ndarray,
                   parent: np.ndarray, pst: np.ndarray,
                   jparts: np.ndarray, new_sig: str, gen: int) -> dict:
        """Swap a rebuilt (sequence, tree, partition) in atomically.
        The rebuild covers the durable edge set up to ``cut``; inserts
        that arrived DURING the rebuild are replayed through the
        incremental transform under the lock, so queries go from one
        consistent state to the other with no torn window.  Stale
        tickets (a later-started rebuild already swapped) are refused.
        NOT durable by itself — the driver seals right after (its own
        kill boundary)."""
        with self._lock:
            if ticket <= self._reseq_applied:
                return {"stale": 1}
            self._reseq_applied = ticket
            # any in-flight repartition was computed over the old jnid
            # space: its result must not land on the new tree
            self._repart_applied = self._repart_ticket - 1
            n_v = len(self.parts)
            # the whole multi-array swap + post-cut replay is ONE
            # seqlock write: lock-free readers either see the old
            # generation or the fully replayed new one, never a mix
            self._mut_begin()
            try:
                self.seq = np.asarray(new_seq, dtype=np.uint32)
                self.parent = np.asarray(parent, dtype=np.uint32)
                self._link_skip = None  # memo is per-tree: swapped, reset
                self.pst = np.asarray(pst, dtype=np.uint32)
                self.pos = sequence_positions(self.seq, max(n_v - 1, 0))
                vparts = np.full(n_v, INVALID_PART, dtype=np.int64)
                vparts[self.seq] = np.asarray(jparts, dtype=np.int64)
                self.parts = vparts
                self.sig = str(new_sig)
                self.seq_gen = int(gen)
                # the new sequence was established at the cut: rank
                # drift is measured against the histogram AS OF the cut
                post_t = np.asarray(self.ins_tail[cut:], dtype=np.uint32)
                post_h = np.asarray(self.ins_head[cut:], dtype=np.uint32)
                self.deg_base = self.deg - host_degree_histogram(
                    post_t, post_h, n_v)
                self.ins_base = int(cut)
                self.seq_drift = 0
                self.drift_cut = 0
                self._subtree_cache = None
                self._part_lut = None
                if len(post_t):
                    self._fold_links(post_t.astype(np.int64),
                                     post_h.astype(np.int64))
            finally:
                self._mut_end()
            if self.edges_tail is not None:
                tail, head = self._all_edges()
                self.baseline_ecv = ecv_down(self.parts, tail, head,
                                             self.pos)
            self.reseqs += 1
            return {"n": len(self.seq),
                    "parts": int(self.parts.max(initial=0)) + 1,
                    "baseline_ecv": self.baseline_ecv,
                    "seq_gen": self.seq_gen,
                    "replayed": len(post_t)}
