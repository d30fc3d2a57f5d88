"""Edge-list file formats (port of sheep_tpu/io/edges.py).

- ``.dat``  XS1 / Graph500 binary: little-endian 12-byte records
  ``{uint32 tail, uint32 head, float32 weight}``.
- ``.net``  SNAP whitespace-separated text, ``tail head`` per line;
  lines starting with '#' are skipped.

Every reader takes an integrity policy (``integrity=``: strict, repair or
trust; None reads ``SHEEP_INTEGRITY``, default strict), as the
reference's does:

- strict: a ``.sum`` sidecar, when one exists, must match the whole file
  (``ChecksumMismatch``), and a torn trailing ``.dat`` record or a bad
  ``.net`` token raises ``MalformedArtifact``; a file without a sidecar
  still loads;
- repair: the checksum mismatch is a warning, a torn ``.dat`` tail is
  dropped with a warning, and a ``.net`` keeps only its well-formed
  ``tail head`` lines;
- trust: no sidecar is read and a torn ``.dat`` tail is dropped.

The block streamers (:func:`iter_dat_blocks`, :func:`iter_net_blocks`)
check a sidecar's size up front and its checksum at the end of the
stream.  The writers (:func:`write_dat`, :func:`write_net`,
:func:`write_edges`) are crash-safe and seal a ``.sum`` sidecar, byte for
byte as the reference's.  Partial loads (part k of num_parts, 1-indexed)
are the contiguous record ranges [floor((k-1)*E/n), floor(k*E/n)).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np

from ..integrity.errors import ChecksumMismatch, MalformedArtifact
from ..integrity.sidecar import (checksummed_write, crc_update, read_sidecar,
                                 resolve_policy, verify_bytes)
from . import faultfs

_XS1_DTYPE = np.dtype(
    [("tail", "<u4"), ("head", "<u4"), ("weight", "<f4")]
)


@dataclass
class EdgeList:
    """A batch of undirected edge records."""

    tail: np.ndarray  # uint32 [E]
    head: np.ndarray  # uint32 [E]
    #: total records in the underlying file (== len(tail) unless partial load)
    file_edges: int = 0
    #: record range [start, stop) of this (possibly partial) load
    start: int = 0

    def __post_init__(self):
        if self.file_edges == 0:
            self.file_edges = len(self.tail)

    @property
    def num_edges(self) -> int:
        return len(self.tail)

    @property
    def max_vid(self) -> int:
        if self.num_edges == 0:
            return 0
        return int(max(self.tail.max(), self.head.max()))

    def degrees(self, num_vertices: int | None = None) -> np.ndarray:
        """Per-vertex degree of the undirected-doubled graph: each record
        adds 1 to both endpoints, a self-loop 2 to its vertex."""
        n = num_vertices if num_vertices is not None else self.max_vid + 1
        deg = np.bincount(self.tail, minlength=n)
        deg += np.bincount(self.head, minlength=n)
        return deg.astype(np.int64)


def partial_range(num_records: int, part: int,
                  num_parts: int) -> tuple[int, int]:
    """Record range of partial load `part`/`num_parts` (part is 1-indexed)."""
    if num_parts <= 0:
        return 0, num_records
    if not (1 <= part <= num_parts):
        raise ValueError(f"part {part} out of range 1..{num_parts}")
    start = ((part - 1) * num_records) // num_parts
    stop = (part * num_records) // num_parts
    return start, stop


def read_dat(path: str, part: int = 0, num_parts: int = 0,
             integrity: str | None = None) -> EdgeList:
    mode = resolve_policy(integrity)
    nbytes = os.path.getsize(path)
    rec_size = _XS1_DTYPE.itemsize
    if nbytes % rec_size:
        msg = (f"{path}: corrupt .dat — {nbytes} bytes is not a multiple "
               f"of the {rec_size}-byte XS1 record (torn trailing record)")
        if mode == "strict":
            raise MalformedArtifact(msg)
        if mode == "repair":
            warnings.warn(msg + "; repair drops the partial record")
    num_records = nbytes // rec_size
    start, stop = partial_range(num_records, part, num_parts) \
        if num_parts else (0, num_records)
    if mode != "trust" and read_sidecar(path) is not None:
        # a sidecar exists: verify the WHOLE file (corruption anywhere
        # invalidates the load) and slice records from the same bytes
        with open(path, "rb") as f:
            data = f.read()
        verify_bytes(path, data, mode)
        raw = np.frombuffer(data, dtype=_XS1_DTYPE,
                            count=num_records)[start:stop]
    else:
        with open(path, "rb") as f:
            f.seek(start * rec_size)
            raw = np.fromfile(f, dtype=_XS1_DTYPE, count=stop - start)
    return EdgeList(
        tail=np.ascontiguousarray(raw["tail"]),
        head=np.ascontiguousarray(raw["head"]),
        file_edges=num_records,
        start=start,
    )


def _salvage_net_lines(path: str, data: bytes):
    """Repair-mode .net parse: keep exactly the well-formed ``tail head``
    lines, drop (and count) everything else.  Any byte damage can only
    REMOVE edges from the result, never invent pairings that span lines —
    which is what makes repair output a subset-or-equal of the clean edge
    multiset under token-invalidating corruption."""
    tails, heads, dropped = [], [], 0
    for ln in data.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith(b"#"):
            continue
        toks = ln.split()
        if len(toks) != 2:
            dropped += 1
            continue
        try:
            t, h = int(toks[0]), int(toks[1])
        except ValueError:
            dropped += 1
            continue
        if not (0 <= t <= 0xFFFFFFFF and 0 <= h <= 0xFFFFFFFF):
            dropped += 1
            continue
        tails.append(t)
        heads.append(h)
    if dropped:
        warnings.warn(f"{path}: repair dropped {dropped} malformed line(s)")
    return (np.array(tails, dtype=np.uint32),
            np.array(heads, dtype=np.uint32))


def read_net(path: str, part: int = 0, num_parts: int = 0,
             integrity: str | None = None) -> EdgeList:
    mode = resolve_policy(integrity)
    # np.loadtxt is slow for big graphs; use fromstring on the filtered text.
    with open(path, "rb") as f:
        data = f.read()
    verify_bytes(path, data, mode)
    if b"#" in data:
        lines = [ln for ln in data.splitlines()
                 if not ln.lstrip().startswith(b"#")]
        data = b"\n".join(lines)
    if mode == "repair":
        tails, heads = _salvage_net_lines(path, data)
    else:
        toks = data.split()
        try:
            flat = np.array(toks, dtype=np.int64) if toks else \
                np.empty(0, dtype=np.int64)
        except (ValueError, OverflowError):
            bad = next((i for i, t in enumerate(toks) if not t.isdigit()),
                       0)
            raise MalformedArtifact(
                f"{path}: corrupt .net — non-integer token "
                f"{toks[bad][:40]!r} (token {bad}); repair mode would drop "
                f"the malformed lines")
        out_of_range = (flat < 0) | (flat > 0xFFFFFFFF)
        if out_of_range.any():
            j = int(np.flatnonzero(out_of_range)[0])
            raise MalformedArtifact(
                f"{path}: corrupt .net — token {int(flat[j])} (token {j}) "
                f"is not a uint32 vid")
        if flat.size % 2 != 0:
            raise MalformedArtifact(
                f"{path}: corrupt .net — odd token count {flat.size} "
                f"(a dangling tail with no head)")
        tails = flat[0::2].astype(np.uint32)
        heads = flat[1::2].astype(np.uint32)
    num_records = len(tails)
    if num_parts:
        start, stop = partial_range(num_records, part, num_parts)
        tails, heads = tails[start:stop].copy(), heads[start:stop].copy()
    else:
        start = 0
        tails, heads = tails.copy(), heads.copy()
    return EdgeList(tail=tails, head=heads, file_edges=num_records,
                    start=start)


def dedup_edges(edges: EdgeList) -> EdgeList:
    """Drop duplicate undirected records and self-loops (the reference's
    DDUP_GRAPH option); records become (min, max) oriented."""
    a = np.minimum(edges.tail, edges.head).astype(np.uint64)
    b = np.maximum(edges.tail, edges.head).astype(np.uint64)
    keep = a != b
    key = np.unique(a[keep] << np.uint64(32) | b[keep])
    return EdgeList(tail=(key >> np.uint64(32)).astype(np.uint32),
                    head=(key & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                    file_edges=len(key), start=edges.start)


def load_edges(path: str, part: int = 0, num_parts: int = 0,
               dedup: bool = False, integrity: str | None = None) -> EdgeList:
    """Suffix-dispatching loader (``.dat`` binary, else SNAP text).
    ``dedup`` (or SHEEP_DDUP_GRAPH=1) drops duplicates and self-loops;
    ``integrity``: strict/repair/trust (None: env SHEEP_INTEGRITY)."""
    if path.endswith(".dat"):
        el = read_dat(path, part, num_parts, integrity=integrity)
    else:
        el = read_net(path, part, num_parts, integrity=integrity)
    if dedup or os.environ.get("SHEEP_DDUP_GRAPH", "") == "1":
        el = dedup_edges(el)
    return el


def iter_dat_blocks(path: str, block_edges: int, part: int = 0,
                    num_parts: int = 0, start_edge: int = 0,
                    end_edge: int | None = None,
                    integrity: str | None = None):
    """Stream a ``.dat`` file as (tail, head) uint32 blocks of at most
    ``block_edges`` records; nothing but the current block is held.
    Honors partial-load ranges like :func:`read_dat`.

    Blocks are plain buffered reads (seek + read), not a whole-file
    memmap, so the resident set stays O(block) whatever the file's size.
    ``start_edge`` skips that many records of the (possibly partial)
    range before the first block, and ``end_edge`` stops the stream after
    that many records of the range, so ``[start_edge, end_edge)`` is a
    contiguous record slice; an empty slice yields no blocks.  Raw records
    only: SHEEP_DDUP_GRAPH is not applied (block-local dedup would differ
    from load-level dedup), and a warning says so.

    Integrity (``integrity``, None: ``SHEEP_INTEGRITY``; the reference's
    streamer reads only the environment): the record-size check runs up
    front like :func:`read_dat`; when a sidecar exists and the whole file
    is streamed, the checksum accumulates across blocks and a mismatch
    raises at the END of the stream, so memory stays bounded and a
    corrupted file still fails the run.  Each block read is a ``dat``-site
    fault point (``SHEEP_IO_FAULT_PLAN``, io/faultfs.hurt_read)."""
    mode = resolve_policy(integrity)
    if os.environ.get("SHEEP_DDUP_GRAPH", "") == "1":
        warnings.warn("SHEEP_DDUP_GRAPH is ignored by the streaming block "
                      "reader; dedup the file up front instead")
    nbytes = os.path.getsize(path)
    if nbytes % _XS1_DTYPE.itemsize and mode != "trust":
        msg = (f"{path}: corrupt .dat — {nbytes} bytes is not a multiple "
               f"of the {_XS1_DTYPE.itemsize}-byte XS1 record")
        if mode == "strict":
            raise MalformedArtifact(msg)
        warnings.warn(msg + "; repair drops the partial record")
    num_records = nbytes // _XS1_DTYPE.itemsize
    if num_records == 0:
        return  # an empty file yields no blocks (mmap would reject it)
    start, stop = partial_range(num_records, part, num_parts) if num_parts \
        else (0, num_records)
    sc = read_sidecar(path) if mode != "trust" else None
    whole = (start, stop) == (0, num_records) and start_edge == 0 \
        and end_edge is None
    base = start
    if end_edge is not None:
        stop = min(stop, base + max(0, end_edge))
    if start_edge:
        start = min(stop, base + start_edge)
    if sc is not None and sc["size"] != nbytes:
        msg = (f"{path}: checksum mismatch (size {nbytes} != recorded "
               f"{sc['size']})")
        if mode == "strict":
            raise ChecksumMismatch(msg)
        warnings.warn(msg)
        sc = None
    crc = 0
    with open(path, "rb") as f:
        for a in range(start, stop, block_edges):
            b = min(a + block_edges, stop)
            faultfs.hurt_read(path)
            f.seek(a * _XS1_DTYPE.itemsize)
            rec = np.fromfile(f, dtype=_XS1_DTYPE, count=b - a)
            if len(rec) < b - a:
                raise MalformedArtifact(
                    f"{path}: short read at record {a} (file truncated "
                    f"mid-stream?)")
            if sc is not None and whole:
                crc = crc_update(rec.tobytes(), crc, sc["algo"])
            tail = np.ascontiguousarray(rec["tail"])
            head = np.ascontiguousarray(rec["head"])
            del rec  # the raw records go before the block is handed out
            yield tail, head
    if sc is not None and whole:
        # trailing torn bytes (if any) are part of the recorded sum
        tail_bytes = nbytes - num_records * _XS1_DTYPE.itemsize
        if tail_bytes:
            with open(path, "rb") as f:
                f.seek(num_records * _XS1_DTYPE.itemsize)
                crc = crc_update(f.read(), crc, sc["algo"])
        if (crc & 0xFFFFFFFF) != sc["sum"]:
            msg = (f"{path}: checksum mismatch detected at end of stream "
                   f"({sc['algo']} {crc & 0xFFFFFFFF:08x} != recorded "
                   f"{sc['sum']:08x}) — the consumed blocks are suspect")
            if mode == "strict":
                raise ChecksumMismatch(msg)
            warnings.warn(msg)


def iter_net_blocks(path: str, block_bytes: int = 1 << 26,
                    integrity: str | None = None):
    """Stream a SNAP ``.net`` text file as (tail, head) uint32 blocks.

    The reference's fileSequence streams text files record by record
    (lib/sequence.h:95-128); here chunks of ~block_bytes are read, split at
    the last newline, comment lines dropped, and the tokens parsed in bulk.
    A trailing half-record (odd token count in the whole file) raises like
    :func:`read_net`.

    Integrity: stream-verified block-wise like the ``.dat`` path
    (:func:`iter_dat_blocks`) — when a sidecar exists, its recorded size is
    checked up front and the checksum accumulates over the raw chunks as
    they are read, raising AT THE END of the stream on a mismatch: bounded
    memory is kept, and a corrupted file still fails the run instead of
    feeding garbage into the fold.  (An abandoned generator never reaches
    the end-of-stream check; the consumed prefix was parseable but
    unvouched — same contract as the ``.dat`` streamer.)
    """
    mode = resolve_policy(integrity)
    sc = read_sidecar(path) if mode != "trust" else None
    if sc is not None and sc["size"] != os.path.getsize(path):
        msg = (f"{path}: checksum mismatch (size {os.path.getsize(path)} "
               f"!= recorded {sc['size']})")
        if mode == "strict":
            raise ChecksumMismatch(msg)
        warnings.warn(msg)
        sc = None
    crc = 0
    carry = b""
    pending = None  # a dangling tail token whose head is in the next chunk
    with open(path, "rb") as f:
        while True:
            chunk = f.read(block_bytes)
            if not chunk:
                break
            if sc is not None:
                crc = crc_update(chunk, crc, sc["algo"])
            buf = carry + chunk
            cut = buf.rfind(b"\n")
            if cut < 0:
                carry = buf
                continue
            carry, text = buf[cut + 1:], buf[:cut]
            if b"#" in text:
                text = b"\n".join(ln for ln in text.splitlines()
                                  if not ln.lstrip().startswith(b"#"))
            toks = text.split()
            if pending is not None:
                toks.insert(0, pending)
                pending = None
            if len(toks) % 2:
                pending = toks.pop()
            if toks:
                flat = _net_tokens(path, toks)
                yield flat[0::2].copy(), flat[1::2].copy()
    if carry.strip() and not carry.lstrip().startswith(b"#"):
        toks = carry.split()
        if pending is not None:
            toks.insert(0, pending)
            pending = None
        if len(toks) % 2:
            raise MalformedArtifact(f"{path}: odd token count")
        if toks:
            flat = _net_tokens(path, toks)
            yield flat[0::2].copy(), flat[1::2].copy()
    elif pending is not None:
        raise MalformedArtifact(f"{path}: odd token count")
    if sc is not None and (crc & 0xFFFFFFFF) != sc["sum"]:
        msg = (f"{path}: checksum mismatch detected at end of stream "
               f"({sc['algo']} {crc & 0xFFFFFFFF:08x} != recorded "
               f"{sc['sum']:08x}) — the consumed blocks are suspect")
        if mode == "strict":
            raise ChecksumMismatch(msg)
        warnings.warn(msg)


def _net_tokens(path: str, toks) -> np.ndarray:
    """Bulk-parse SNAP text tokens with a typed error on garbage."""
    try:
        return np.array(toks, dtype=np.uint32)
    except (ValueError, OverflowError) as exc:
        raise MalformedArtifact(
            f"{path}: corrupt .net — non-integer token in stream ({exc})")


def write_dat(path: str, tail: np.ndarray, head: np.ndarray) -> None:
    # Crash-safe like every writer in this package (io/atomic.py): the
    # per-part edge files feed the next pipeline stage through a polling
    # filesystem handoff, so a torn record prefix must be impossible.
    # checksummed_write additionally seals a .sum sidecar next to it and
    # preflights the disk with the exact record size.
    rec = np.empty(len(tail), dtype=_XS1_DTYPE)
    rec["tail"] = tail
    rec["head"] = head
    rec["weight"] = 1.0
    with checksummed_write(path, "wb", expect_bytes=rec.nbytes) as f:
        f.write(rec.tobytes())


def write_net(path: str, tail: np.ndarray, head: np.ndarray) -> None:
    # preflight at the uint32 text ceiling (two 10-digit vids + sep/NL)
    with checksummed_write(path, "w",
                           expect_bytes=22 * len(tail)) as f:
        for x, y in zip(tail.tolist(), head.tolist()):
            f.write(f"{x} {y}\n")


def write_edges(path: str, tail: np.ndarray, head: np.ndarray) -> None:
    if path.endswith(".dat"):
        write_dat(path, tail, head)
    else:
        write_net(path, tail, head)
