"""Resumable build snapshots: the checkpoint format + atomic persistence
(port of sheep_tpu/runtime/snapshot.py; a snapshot holds host numpy
arrays only, never a device tensor).

What makes a mid-build checkpoint SOUND here is a structural property of
the whole architecture (ops/forest.py module docstring): every chunk
transform preserves threshold connectivity, and the elimination forest is a
function of threshold connectivity only.  So the complete build state at
any chunk boundary is just

    (sequence, pst accumulator, live link multiset, round counter)

— no schedule position, no lifting depth, no device state.  A build
resumed from ANY boundary snapshot converges to the bit-identical parent
array, because every trajectory over the same link multiset reaches the
same (unique) forest; and pst is order-free (counted once from the
original links before any reduction).  The same property is what lets the
degradation ladder hand a snapshot from the single-card rung to the
host rungs: all rungs operate on the same link multiset over
the same sequence.

On disk a snapshot is ONE uncompressed ``.npz`` written crash-safely
(io/atomic.py: temp + fsync + atomic rename), so the file under the final
name is always a complete, self-consistent checkpoint — a kill mid-write
leaves the previous checkpoint in place.  An ``input_sig`` (sha256 over
the vertex count, sequence, and edge bytes) guards against resuming
someone else's build: a mismatch is an error, not a silent wrong tree.

Integrity: every snapshot is sealed with a ``.sum`` sidecar
(integrity.sidecar) and loads through :func:`load_snapshot`, which layers
sidecar checksum -> zip member CRCs -> schema -> structural invariants
(Snapshot.validate).  A corrupt snapshot is NEVER partially salvaged —
under the repair policy the driver discards it and rebuilds fresh.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from dataclasses import dataclass

import numpy as np

from ..integrity.errors import IntegrityError, MalformedArtifact
from ..integrity.sidecar import (resolve_policy, sealed_write, sidecar_path,
                                 verify_file)
from ..resources import (ResourceGovernor, gc_orphan_temps, retention_gc,
                         snapshot_nbytes)

SNAPSHOT_NAME = "sheep-ckpt.npz"
_VERSION = 1


def input_signature(n: int, seq: np.ndarray,
                    tail: np.ndarray | None = None,
                    head: np.ndarray | None = None) -> str:
    """Stable identity of a build input.  Edge bytes are included when the
    caller still has them (one linear pass); a resume deliberately hashes
    the same fields so mismatched graphs are rejected up front."""
    h = hashlib.sha256()
    h.update(f"v{_VERSION}:n{n}:".encode())
    h.update(np.ascontiguousarray(seq, dtype=np.uint32).tobytes())
    for arr in (tail, head):
        if arr is not None:
            h.update(np.ascontiguousarray(arr, dtype=np.uint32).tobytes())
    return h.hexdigest()


@dataclass
class Snapshot:
    """One resumable build state (see module docstring for why this tuple
    is complete)."""

    n: int                 # position-space size (len(seq))
    seq: np.ndarray        # uint32 [m] — the elimination order
    pst: np.ndarray        # uint32 [n] — order-free, final from round 0
    lo: np.ndarray         # int32 [k] live links (lo < hi < n)
    hi: np.ndarray         # int32 [k]
    rounds: int            # chunk rounds completed so far
    boundary: int          # checkpointed chunk boundaries so far
    rung: str              # ladder rung that wrote it (mesh/single/host)
    input_sig: str         # sha256 identity of the build input

    def verify(self, input_sig: str | None) -> None:
        if input_sig is not None and input_sig != self.input_sig:
            raise IntegrityError(
                "checkpoint does not belong to this input graph/sequence "
                f"(snapshot sig {self.input_sig[:12]}..., "
                f"input sig {input_sig[:12]}...) — refusing to resume")

    def validate(self) -> None:
        """Structural invariants a well-formed snapshot always satisfies;
        violation means the file was corrupted (or written by a sick rung)
        and resuming from it would build a silently wrong tree."""
        problems = []
        if self.n < 0:
            problems.append(f"negative n {self.n}")
        if len(self.seq) != self.n:
            problems.append(f"len(seq)={len(self.seq)} != n={self.n}")
        if len(self.pst) != self.n:
            problems.append(f"len(pst)={len(self.pst)} != n={self.n}")
        if len(self.lo) != len(self.hi):
            problems.append(
                f"link arrays disagree: {len(self.lo)} lo vs "
                f"{len(self.hi)} hi")
        else:
            lo = np.asarray(self.lo, dtype=np.int64)
            hi = np.asarray(self.hi, dtype=np.int64)
            if len(lo) and not bool(((lo >= 0) & (lo < hi)
                                     & (hi < self.n)).all()):
                problems.append(
                    "live links violate 0 <= lo < hi < n")
        if self.rounds < 0 or self.boundary < 0:
            problems.append(
                f"negative counters (rounds={self.rounds}, "
                f"boundary={self.boundary})")
        if problems:
            raise MalformedArtifact(
                "corrupt snapshot — " + "; ".join(problems))


#: auto-cadence targets: snapshot overhead <= this fraction of compute
#: time between persisted boundaries, with the cadence capped so a crash
#: never loses more than _AUTO_MAX chunks of progress.
_AUTO_OVERHEAD = 0.1
_AUTO_MAX = 64


class Checkpointer:
    """Owns the snapshot file of one build: save at chunk boundaries,
    load at resume, clear on success.

    ``every``: persist every k-th boundary (the fetch + write costs one
    host sync; where that is slow a coarser cadence may be wanted).
    Boundaries are still COUNTED every time so fault-injection indices
    stay stable regardless of cadence.

    ``every=0`` selects AUTO cadence (env ``SHEEP_CHECKPOINT_EVERY=auto``):
    start persisting every boundary, then retune from measurement — the
    driver reports each persisted snapshot's cost and the chunk compute
    time since the previous boundary (:meth:`observe`), and the cadence is
    scaled so snapshot overhead stays under ~10% of compute.  A fast
    local-disk run keeps every=1 (cheap snapshots, maximum resumability);
    a run whose checkpoints are expensive backs off automatically instead
    of making the operator guess a number.
    """

    def __init__(self, directory: str, every: int = 1,
                 governor: ResourceGovernor | None = None):
        if every < 0:
            raise ValueError(f"checkpoint every={every} must be >= 0 "
                             f"(0 = auto-tune)")
        self.directory = directory
        self.auto = every == 0
        self.every = 1 if self.auto else every
        self.boundary = 0
        self.governor = governor if governor is not None \
            else ResourceGovernor.from_env()
        os.makedirs(directory, exist_ok=True)
        # a killed/faulted predecessor's write debris: unpublished by
        # construction, reclaimed before it can crowd out OUR snapshots
        gc_orphan_temps(directory)

    def observe(self, save_s: float, chunk_s: float) -> int | None:
        """Feed one (snapshot cost, chunk compute time) measurement; in
        auto mode retunes ``every`` and returns the new cadence when it
        changed (None otherwise).  Deterministic given the measurements —
        the property tests drive it with synthetic costs."""
        if not self.auto or chunk_s <= 0 or save_s < 0:
            return None
        import math
        want = save_s / (_AUTO_OVERHEAD * chunk_s)
        new = int(min(_AUTO_MAX, max(1, math.ceil(want))))
        if new == self.every:
            return None
        self.every = new
        return new

    @property
    def path(self) -> str:
        return os.path.join(self.directory, SNAPSHOT_NAME)

    def want(self) -> bool:
        """Will the NEXT boundary be persisted?  Callers use this to skip
        an expensive link fetch/gather when the answer is no."""
        return (self.boundary % self.every) == 0

    def skip(self) -> None:
        """Count an off-cadence boundary without persisting anything."""
        self.boundary += 1

    def preflight(self, n: int, links: int) -> int:
        """Disk preflight for the NEXT snapshot: price it
        analytically, run the retention GC when the ``SHEEP_DISK_BUDGET``
        cap would trip (keep-resumable: the live snapshot + sidecar are
        protected; orphan temps and stale files go first), and refuse
        with a typed DiskExhausted when neither the budget nor the
        filesystem can hold it.  Returns the estimate."""
        est = snapshot_nbytes(n, links)
        gov = self.governor
        deficit = gov.dir_budget_deficit(self.directory, est)
        if deficit > 0:
            retention_gc(self.directory,
                         protect=(self.path, sidecar_path(self.path)),
                         keep_last=0, need=deficit)
            gov.check_dir_budget(self.directory, est, "checkpoint")
        gov.preflight_write(self.directory, est)
        return est

    def save(self, snap: Snapshot) -> None:
        """Persist ``snap`` at the current boundary and advance the
        counter (callers gate on :meth:`want` first).  Snapshot writes
        guard themselves twice over: structurally invalid state (a sick
        rung handing over garbage links) is refused BEFORE it becomes
        durable, and a disk that cannot hold the snapshot is refused
        BEFORE any bytes land (:meth:`preflight`) — in both cases the
        previous checkpoint stays in place and the run stays resumable."""
        snap.boundary = self.boundary
        self.boundary += 1
        snap.validate()
        est = self.preflight(snap.n, len(snap.lo))
        from ..obs import trace as obs
        # The npz writer seeks (zip local headers), so the sidecar sums
        # the sealed temp by read-back (sealed_write) — sidecar first,
        # artifact second, like every publish in the system.
        with obs.span("checkpoint.save", rung=snap.rung,
                      boundary=snap.boundary, rounds=snap.rounds,
                      links=len(snap.lo)), \
                sealed_write(self.path, "wb", expect_bytes=est) as f:
            np.savez(
                f,
                version=np.int64(_VERSION),
                n=np.int64(snap.n),
                seq=np.asarray(snap.seq, dtype=np.uint32),
                pst=np.asarray(snap.pst, dtype=np.uint32),
                lo=np.asarray(snap.lo, dtype=np.int32),
                hi=np.asarray(snap.hi, dtype=np.int32),
                rounds=np.int64(snap.rounds),
                boundary=np.int64(snap.boundary),
                rung=np.str_(snap.rung),
                input_sig=np.str_(snap.input_sig),
            )

    def load(self, integrity: str | None = None) -> Snapshot | None:
        """The last persisted snapshot, or None when there is none.
        Raises IntegrityError when the snapshot exists but is corrupt —
        resuming into garbage is never an option (the driver decides
        whether to fall back to a fresh build, per policy)."""
        if not os.path.exists(self.path):
            return None
        snap = load_snapshot(self.path, integrity=integrity)
        # resume continues counting boundaries where the dead build stopped
        self.boundary = snap.boundary + 1
        return snap

    def clear(self) -> None:
        """Remove the snapshot and its sidecar (the build completed; a
        later --resume must start fresh rather than replay a finished
        state)."""
        for path in (self.path, sidecar_path(self.path)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


def load_snapshot(path: str, integrity: str | None = None) -> Snapshot:
    """Load + fully verify one snapshot file: sidecar checksum, zip-member
    CRCs (np.load's zipfile layer), schema, and structural invariants.
    Every corruption class surfaces as a typed IntegrityError — this is
    also the ``sheep fsck`` checker for ``.npz`` artifacts."""
    mode = resolve_policy(integrity)
    # A snapshot is never partially salvageable — resuming from bytes that
    # "mostly parse" builds a wrong tree.  So the checksum check is strict
    # even under the repair policy; repair's graceful path lives in the
    # DRIVER, which catches the IntegrityError and rebuilds from scratch.
    if mode != "trust":
        verify_file(path, "strict")
    try:
        with np.load(path) as z:
            if int(z["version"]) != _VERSION:
                raise MalformedArtifact(
                    f"{path}: snapshot version {int(z['version'])} "
                    f"!= supported {_VERSION}")
            snap = Snapshot(
                n=int(z["n"]), seq=z["seq"].copy(), pst=z["pst"].copy(),
                lo=z["lo"].copy(), hi=z["hi"].copy(),
                rounds=int(z["rounds"]), boundary=int(z["boundary"]),
                rung=str(z["rung"]), input_sig=str(z["input_sig"]))
    except IntegrityError:
        raise
    except (zipfile.BadZipFile, KeyError, OSError, ValueError,
            EOFError) as exc:
        # np.load surfaces member bit-flips as BadZipFile ("Bad CRC-32"),
        # missing members as KeyError, torn files as OSError/EOFError
        raise MalformedArtifact(
            f"{path}: corrupt snapshot ({type(exc).__name__}: {exc})")
    snap.validate()
    return snap
