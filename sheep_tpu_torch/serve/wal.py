"""Write-ahead log for the serve daemon: every accepted insert is durable
before it is acknowledged.

The recovery contract is ARIES-shaped but deliberately tiny: the
serving state is a pure function of (snapshot, ordered insert records), so
the log needs no undo, no pages, no LSN map — just records that are (a)
individually checksummed, (b) strictly ordered, and (c) fsync'd before the
client hears "OK".  Restart = load snapshot + replay the records with
``seqno > snapshot.applied_seqno``; because the incremental insert
transform is deterministic (serve/state.py), the replayed tree is
bit-identical to the pre-crash tree at every insert boundary.

On-disk format (little-endian throughout)::

    header   "SHEEPWAL" | uint32 version | 64-byte ascii input signature
             | uint64 epoch                                  (version 2)
    record   uint64 seqno | uint32 payload_len | uint32 crc32 | payload

``epoch`` stamps the log with the replication term that wrote
it: every leader promotion bumps the epoch and swaps in a fresh log, so
two logs with different epochs must cover DISJOINT seqno ranges — the
fence that makes a rejoining ex-leader's divergent tail detectable
instead of silently merged (``sheep fsck`` refuses cross-epoch seqno
overlap).  Version-1 logs (pre-replication state dirs) read as epoch 0.

``crc32`` (zlib, pinned — the WAL must verify on any host, so the algo is
not environment-gated like sidecars) covers seqno + payload_len + payload.
The signature ties the log to the (n, sequence) identity of the build it
mutates (runtime.snapshot.input_signature): replaying someone else's WAL
into a tree is refused up front, same as checkpoint resume.

A kill mid-append leaves a torn trailing record.  ``read_wal`` surfaces it
per the integrity policy: **strict** refuses the whole log (typed
MalformedArtifact — an operator must decide), **repair** returns the clean
prefix and reports the tear so the owner (ServeCore.open) can truncate it
away; a record that went bad in the MIDDLE of the chain (CRC or sequence
break with clean records after it) is corruption, not a tear, and is
refused in every mode.  Torn-at-every-byte-boundary behavior is property
tested (tests/test_serve.py).

Appends run through the I/O fault layer (io/faultfs.py, site ``wal``) so
ENOSPC/EIO/short/slow fire through the exact path a real failure takes; a
failed append truncates back to the record boundary and re-raises typed
(DiskExhausted/WriteFault) — the log never retains a torn record that was
never acknowledged.
"""

from __future__ import annotations

import os
import re
import struct
import warnings
import zlib

from ..integrity.errors import IntegrityError, MalformedArtifact
from ..integrity.sidecar import resolve_policy
from ..io import faultfs
from ..io.atomic import _typed, atomic_write
from ..obs import trace as _obs
from ..resources.governor import ResourceGovernor

WAL_NAME = "serve.wal"
_MAGIC = b"SHEEPWAL"
_VERSION = 2
_SIG_BYTES = 64  # ascii sha256 hexdigest

_HEADER_V1 = struct.Struct(f"<8sI{_SIG_BYTES}s")
#: v2 appends the replication epoch; new logs always write v2
_HEADER = struct.Struct(f"<8sI{_SIG_BYTES}sQ")
_RECORD = struct.Struct("<QII")  # seqno, payload_len, crc32

#: refuse absurd record claims up front (a corrupt length field must not
#: make the reader allocate gigabytes): one insert batch is bounded by the
#: protocol's line length; 16MB is orders of magnitude above it
MAX_PAYLOAD = 16 << 20


def wal_path(state_dir: str) -> str:
    return os.path.join(state_dir, WAL_NAME)


def archived_wal_name(epoch: int) -> str:
    return f"serve-e{epoch:06d}.wal"


def archived_wal_paths(state_dir: str) -> list[str]:
    """Epoch-archived logs in the dir, oldest epoch first.  A promotion
    (state.ServeCore.advance_epoch) copies the outgoing epoch's log aside
    before sealing, so the seqno hand-off across the promotion boundary
    stays auditable by ``sheep fsck``."""
    import glob
    out = []
    for path in glob.glob(os.path.join(glob.escape(state_dir),
                                       "serve-e*.wal")):
        if re.match(r"^serve-e\d{6}\.wal$", os.path.basename(path)):
            out.append(path)
    return sorted(out)


def _record_crc(seqno: int, payload: bytes) -> int:
    head = struct.pack("<QI", seqno, len(payload))
    return zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF


def create_wal(path: str, sig: str, epoch: int = 0) -> None:
    """Write a fresh, empty WAL (crash-safely — the old log, if any, stays
    intact until the new one is complete), stamped with the replication
    ``epoch`` that owns it (0 = never promoted / standalone)."""
    sig_b = sig.encode("ascii")
    if len(sig_b) != _SIG_BYTES:
        raise ValueError(f"input signature must be {_SIG_BYTES} ascii "
                         f"chars, got {len(sig_b)}")
    if epoch < 0:
        raise ValueError(f"negative WAL epoch {epoch}")
    with atomic_write(path, "wb", expect_bytes=_HEADER.size) as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, sig_b, epoch))


def read_wal(path: str, mode: str | None = None):
    """Parse the whole log.  Returns ``(sig, epoch, records, clean_end,
    torn)``: ``records`` is a list of (seqno, payload) in log order,
    ``clean_end`` the byte offset after the last intact record, ``torn``
    whether bytes follow it.  Never mutates the file (fsck uses this too).

    Policy (``mode``: strict/repair/trust, default SHEEP_INTEGRITY):
    strict raises MalformedArtifact on a torn tail; repair/trust warn and
    return the clean prefix.  Mid-chain corruption — a bad CRC or a
    non-monotone seqno with a VALID record after it — raises in every
    mode: that log did not tear, it rotted.
    """
    mode = resolve_policy(mode)
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _HEADER_V1.size:
        raise MalformedArtifact(
            f"{path}: corrupt WAL — {len(data)} bytes is shorter than the "
            f"{_HEADER_V1.size}-byte header")
    magic, version, sig_b = _HEADER_V1.unpack_from(data, 0)
    if magic != _MAGIC:
        raise MalformedArtifact(
            f"{path}: corrupt WAL — bad magic {magic!r}")
    if version > _VERSION:
        raise MalformedArtifact(
            f"{path}: WAL version {version} > supported {_VERSION}")
    if version >= 2:
        if len(data) < _HEADER.size:
            raise MalformedArtifact(
                f"{path}: corrupt WAL — v2 log of {len(data)} bytes is "
                f"shorter than the {_HEADER.size}-byte epoch header")
        magic, version, sig_b, epoch = _HEADER.unpack_from(data, 0)
        header_size = _HEADER.size
    else:
        epoch = 0  # pre-replication log: never promoted
        header_size = _HEADER_V1.size
    try:
        sig = sig_b.decode("ascii")
    except UnicodeDecodeError:
        raise MalformedArtifact(f"{path}: corrupt WAL — unreadable "
                                f"input signature in header")

    records: list[tuple[int, bytes]] = []
    off = header_size
    bad_at = None  # (offset, reason) of the first unreadable record
    last_seqno = None
    while off < len(data):
        if off + _RECORD.size > len(data):
            bad_at = (off, f"{len(data) - off} trailing bytes are shorter "
                           f"than a record header")
            break
        seqno, length, crc = _RECORD.unpack_from(data, off)
        if length > MAX_PAYLOAD:
            bad_at = (off, f"record claims {length} payload bytes "
                           f"(cap {MAX_PAYLOAD})")
            break
        if off + _RECORD.size + length > len(data):
            bad_at = (off, f"record claims {length} payload bytes but only "
                           f"{len(data) - off - _RECORD.size} follow")
            break
        payload = data[off + _RECORD.size: off + _RECORD.size + length]
        if _record_crc(seqno, payload) != crc:
            bad_at = (off, f"record {seqno} fails its crc32")
            break
        if last_seqno is not None and seqno <= last_seqno:
            # never a tear: both records are intact, the ORDER is lying
            raise MalformedArtifact(
                f"{path}: corrupt WAL — seqno {seqno} after {last_seqno} "
                f"(sequence numbers must be strictly monotone)")
        last_seqno = seqno
        records.append((seqno, payload))
        off += _RECORD.size + length

    if bad_at is None:
        return sig, epoch, records, off, False

    # A bad record is only a TEAR if nothing valid follows it; scan for a
    # clean record past the damage — finding one means mid-chain rot.
    tail_off, reason = bad_at
    scan = tail_off + 1
    while scan + _RECORD.size <= len(data):
        seqno, length, crc = struct.unpack_from("<QII", data, scan)
        if (length <= MAX_PAYLOAD
                and scan + _RECORD.size + length <= len(data)
                and _record_crc(
                    seqno,
                    data[scan + _RECORD.size: scan + _RECORD.size + length]
                ) == crc):
            raise MalformedArtifact(
                f"{path}: corrupt WAL — record at offset {tail_off} is "
                f"damaged ({reason}) but an intact record follows at "
                f"{scan}: mid-chain corruption, not a torn tail")
        scan += 1

    msg = (f"{path}: torn WAL — {reason} at offset {tail_off} "
           f"({len(records)} intact record(s) precede it)")
    if mode == "strict":
        raise MalformedArtifact(
            msg + "; refusing in strict mode (repair mode truncates the "
                  "torn tail)")
    warnings.warn(msg + "; salvaging the clean prefix")
    return sig, epoch, records, tail_off, True


def repair_wal(path: str) -> int:
    """Truncate a torn tail off the log (the repair-mode recovery step,
    ServeCore.open).  Returns the number of bytes removed (0 when the log
    was already clean).  Mid-chain corruption still raises — truncation
    can only ever amputate a tear, never resurrect rot."""
    _, _, _, clean_end, torn = read_wal(path, "repair")
    if not torn:
        return 0
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(clean_end)
        f.flush()
        os.fsync(f.fileno())
    return size - clean_end


class WalAppender:
    """Append-side handle: owns the open fd, the next sequence number, and
    the durability discipline (write -> flush -> fsync -> only then return).

    The constructor verifies the existing log end-to-end (``read_wal``
    strict — an appender must never extend a log it cannot vouch for) and
    positions at the clean end.
    """

    def __init__(self, path: str, expect_sig: str | None = None,
                 governor: ResourceGovernor | None = None):
        sig, epoch, records, clean_end, _ = read_wal(path, "strict")
        if expect_sig is not None and sig != expect_sig:
            raise IntegrityError(
                f"{path}: WAL belongs to a different build input "
                f"(log sig {sig[:12]}..., expected {expect_sig[:12]}...) — "
                f"refusing to append")
        self.path = path
        self.sig = sig
        self.epoch = epoch
        self.next_seqno = (records[-1][0] + 1) if records else 1
        self.governor = governor if governor is not None \
            else ResourceGovernor.from_env()
        self._f = open(path, "r+b")
        self._f.seek(clean_end)
        self._unsynced = False

    def append(self, payload: bytes, sync: bool = True) -> int:
        """Durably append one record; returns its seqno.  The record is
        on disk (fsync'd) when this returns — the caller may acknowledge.
        On ANY write failure the log is truncated back to the record
        boundary and the error re-raises typed (DiskExhausted/WriteFault
        for ENOSPC/EIO, real or injected): a failed append leaves no
        trace, so it can be retried or refused without a repair pass."""
        return self.append_at(self.next_seqno, payload, sync=sync)

    def append_at(self, seqno: int, payload: bytes,
                  sync: bool = True) -> int:
        """Append one record under a CALLER-chosen seqno (the follower
        apply path, serve/replicate.py: a replica logs records under the
        leader's numbering so the two logs stay comparable).  ``seqno``
        must keep the chain strictly monotone; same durability contract
        as :meth:`append`.

        ``sync=False`` defers the fsync (write+flush only): the batched
        follower apply appends a whole APPEND burst and pays ONE
        :meth:`sync` for the lot — the caller MUST NOT acknowledge any
        deferred record before that sync returns.  A crash in the window
        loses only unacknowledged records, and the torn-tail repair
        truncates any partially-flushed one."""
        if len(payload) > MAX_PAYLOAD:
            raise ValueError(f"WAL payload of {len(payload)} bytes exceeds "
                             f"the {MAX_PAYLOAD} cap")
        if seqno < self.next_seqno:
            raise ValueError(
                f"{self.path}: append_at seqno {seqno} would break the "
                f"strictly-monotone chain (next is {self.next_seqno})")
        rec = _RECORD.pack(seqno, len(payload),
                           _record_crc(seqno, payload)) + payload
        start = self._f.tell()
        # cheap preflight: an append that cannot fit should refuse before
        # bytes land, same contract as the atomic writers (io/atomic.py)
        self.governor.preflight_write(self.path, len(rec))
        w = faultfs.wrap(self._f, faultfs.arm(self.path), text=False)
        try:
            w.write(rec)
            self._f.flush()
            if sync:
                # flight-recorder span (obs/trace.py): WAL fsyncs are
                # the serve write path's dominant latency term
                with _obs.span("wal.fsync", seqno=seqno):
                    os.fsync(self._f.fileno())
        except OSError as exc:
            try:
                self._f.truncate(start)
                self._f.seek(start)
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError:
                pass  # the truncate is best-effort; recovery re-truncates
            typed = _typed(exc, self.path)
            if typed is not exc:
                raise typed from exc
            raise
        if not sync:
            self._unsynced = True
        self.next_seqno = seqno + 1
        return seqno

    def sync(self, **attrs) -> None:
        """fsync any deferred appends (the burst seal).  No-op when
        nothing is pending.  On failure the error re-raises typed and the
        log is NOT truncated: deferred records are already applied by the
        caller and a truncation here could leave a seqno gap on disk —
        the bytes stay buffered for a later retry, and a crash before one
        lands is covered by the torn-tail repair (none of the deferred
        records were acknowledged).

        ``attrs`` land on the ``wal.fsync`` span: the group-commit
        coordinator (serve/state.py) attributes the one shared fsync to
        every rid it seals (one span, many rids)."""
        if not self._unsynced:
            return
        try:
            self._f.flush()
            with _obs.span("wal.fsync", burst=True, **attrs):
                os.fsync(self._f.fileno())
        except OSError as exc:
            typed = _typed(exc, self.path)
            if typed is not exc:
                raise typed from exc
            raise
        self._unsynced = False

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def __enter__(self) -> "WalAppender":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
