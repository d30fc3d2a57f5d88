"""Edge-list file formats (port of sheep_tpu/io/edges.py, trust mode).

- ``.dat``  XS1 / Graph500 binary: little-endian 12-byte records
  ``{uint32 tail, uint32 head, float32 weight}``.
- ``.net``  SNAP whitespace-separated text, ``tail head`` per line;
  lines starting with '#' are skipped.

Trust mode reads no integrity sidecar: a torn trailing ``.dat`` record is
dropped, and a malformed ``.net`` token raises ValueError.  The writers
(:func:`write_dat`, :func:`write_net`, :func:`write_edges`) are
crash-safe and seal a ``.sum`` sidecar, byte for byte as the
reference's.  Partial loads
(part k of num_parts, 1-indexed) are the contiguous record ranges
[floor((k-1)*E/n), floor(k*E/n)).  :func:`iter_dat_blocks` streams a
``.dat`` file block by block, the source of the out-of-core builds
(``ops.stream``).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np

from ..integrity.sidecar import checksummed_write

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


def read_dat(path: str, part: int = 0, num_parts: int = 0) -> EdgeList:
    rec_size = _XS1_DTYPE.itemsize
    num_records = os.path.getsize(path) // rec_size
    start, stop = partial_range(num_records, part, num_parts) \
        if num_parts else (0, num_records)
    with open(path, "rb") as f:
        f.seek(start * rec_size)
        raw = np.fromfile(f, dtype=_XS1_DTYPE, count=stop - start)
    return EdgeList(
        tail=np.ascontiguousarray(raw["tail"]),
        head=np.ascontiguousarray(raw["head"]),
        file_edges=num_records,
        start=start,
    )


def iter_dat_blocks(path: str, block_edges: int, part: int = 0,
                    num_parts: int = 0, start_edge: int = 0,
                    end_edge: int | None = None):
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
    from load-level dedup), and a warning says so.  Trust mode: a torn
    trailing record is dropped; a short read mid-stream raises
    ValueError."""
    if os.environ.get("SHEEP_DDUP_GRAPH", "") == "1":
        warnings.warn("SHEEP_DDUP_GRAPH is ignored by the streaming block "
                      "reader; dedup the file up front instead")
    rec_size = _XS1_DTYPE.itemsize
    num_records = os.path.getsize(path) // rec_size
    if num_records == 0:
        return
    start, stop = partial_range(num_records, part, num_parts) \
        if num_parts else (0, num_records)
    base = start
    if end_edge is not None:
        stop = min(stop, base + max(0, end_edge))
    if start_edge:
        start = min(stop, base + start_edge)
    with open(path, "rb") as f:
        for a in range(start, stop, block_edges):
            b = min(a + block_edges, stop)
            f.seek(a * rec_size)
            raw = np.fromfile(f, dtype=_XS1_DTYPE, count=b - a)
            if len(raw) < b - a:
                raise ValueError(f"{path}: short read at record {a} (file "
                                 f"truncated mid-stream?)")
            yield np.ascontiguousarray(raw["tail"]), \
                np.ascontiguousarray(raw["head"])


def read_net(path: str, part: int = 0, num_parts: int = 0) -> EdgeList:
    with open(path, "rb") as f:
        data = f.read()
    if b"#" in data:
        lines = [ln for ln in data.splitlines()
                 if not ln.lstrip().startswith(b"#")]
        data = b"\n".join(lines)
    toks = data.split()
    try:
        flat = np.array(toks, dtype=np.int64) if toks else \
            np.empty(0, dtype=np.int64)
    except (ValueError, OverflowError):
        bad = next((i for i, t in enumerate(toks) if not t.isdigit()), 0)
        raise ValueError(f"{path}: corrupt .net — non-integer token "
                         f"{toks[bad][:40]!r} (token {bad})")
    out_of_range = (flat < 0) | (flat > 0xFFFFFFFF)
    if out_of_range.any():
        j = int(np.flatnonzero(out_of_range)[0])
        raise ValueError(f"{path}: corrupt .net — token {int(flat[j])} "
                         f"(token {j}) is not a uint32 vid")
    if flat.size % 2 != 0:
        raise ValueError(f"{path}: corrupt .net — odd token count "
                         f"{flat.size} (a dangling tail with no head)")
    tails = flat[0::2].astype(np.uint32)
    heads = flat[1::2].astype(np.uint32)
    num_records = len(tails)
    start = 0
    if num_parts:
        start, stop = partial_range(num_records, part, num_parts)
        tails, heads = tails[start:stop], heads[start:stop]
    return EdgeList(tail=tails.copy(), head=heads.copy(),
                    file_edges=num_records, start=start)


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
               dedup: bool = False) -> EdgeList:
    """Suffix-dispatching loader (``.dat`` binary, else SNAP text).
    ``dedup`` (or SHEEP_DDUP_GRAPH=1) drops duplicates and self-loops."""
    if path.endswith(".dat"):
        el = read_dat(path, part, num_parts)
    else:
        el = read_net(path, part, num_parts)
    if dedup or os.environ.get("SHEEP_DDUP_GRAPH", "") == "1":
        el = dedup_edges(el)
    return el


def write_dat(path: str, tail: np.ndarray, head: np.ndarray) -> None:
    """XS1 records (weight 1.0), written atomically with a sidecar whose
    size is preflighted against the disk."""
    rec = np.empty(len(tail), dtype=_XS1_DTYPE)
    rec["tail"] = tail
    rec["head"] = head
    rec["weight"] = 1.0
    with checksummed_write(path, "wb", expect_bytes=rec.nbytes) as f:
        f.write(rec.tobytes())


def write_net(path: str, tail: np.ndarray, head: np.ndarray) -> None:
    """SNAP text, ``tail head`` per line; the preflight prices the uint32
    ceiling (two 10-digit vids, a separator and a newline)."""
    with checksummed_write(path, "w", expect_bytes=22 * len(tail)) as f:
        for x, y in zip(tail.tolist(), head.tolist()):
            f.write(f"{x} {y}\n")


def write_edges(path: str, tail: np.ndarray, head: np.ndarray) -> None:
    """Suffix-dispatching writer (``.dat`` binary, else SNAP text)."""
    if path.endswith(".dat"):
        write_dat(path, tail, head)
    else:
        write_net(path, tail, head)
