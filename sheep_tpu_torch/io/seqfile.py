"""Sequence (vertex elimination order) file I/O (port of
sheep_tpu/io/seqfile.py).

Text by default, one vid per line, as the reference's default
(USE_BIN_SEQUENCE off; lib/sequence.h:153-168); ``binary=True`` writes
``{uint64 size}{uint32 vid[size]}`` as lib/sequence.h:133-151 does.

Writes seal a ``.sum`` sidecar; reads verify it and sniff the on-disk
format, so a binary ``.seq`` opened as text (or the reverse) raises a
MalformedArtifact instead of parsing into a wrong order.
``binary="auto"`` trusts the sniff.  A file either package writes reads
back in the other, byte for byte.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..integrity.errors import MalformedArtifact
from ..integrity.sidecar import checksummed_write, resolve_policy, verify_bytes

#: the only bytes a well-formed TEXT sequence may contain
_TEXT_BYTES = frozenset(b"0123456789 \t\r\n")


def write_sequence(seq: np.ndarray, path: str, binary: bool = False) -> None:
    # crash-safe (io/atomic.py); the size estimate preflights the disk,
    # text rows priced at the uint32 ceiling of 11 bytes a line
    seq = np.asarray(seq, dtype=np.uint32)
    if binary:
        with checksummed_write(path, "wb",
                               expect_bytes=8 + 4 * len(seq)) as f:
            f.write(np.uint64(len(seq)).tobytes())
            f.write(seq.astype("<u4").tobytes())
    else:
        with checksummed_write(path, "w",
                               expect_bytes=11 * len(seq)) as f:
            f.write("\n".join(map(str, seq.tolist())))
            if len(seq):
                f.write("\n")


def _looks_text(data: bytes) -> bool:
    """True when every byte (sampled head + tail) is digit/whitespace."""
    sample = data[:4096] + data[-4096:] if len(data) > 8192 else data
    return all(b in _TEXT_BYTES for b in sample)


def _binary_consistent(data: bytes) -> bool:
    """True when the bytes parse exactly as {uint64 size}{uint32 vid[size]}."""
    if len(data) < 8:
        return False
    size = int(np.frombuffer(data[:8], dtype="<u8")[0])
    return 8 + 4 * size == len(data)


def read_sequence(path: str, binary: bool | str = False,
                  integrity: str | None = None) -> np.ndarray:
    """Read an elimination order.  ``binary``: False (text), True, or
    "auto" to sniff the on-disk format."""
    mode = resolve_policy(integrity)
    with open(path, "rb") as f:
        data = f.read()
    verify_bytes(path, data, mode)
    if binary == "auto":
        binary = not _looks_text(data) or (_binary_consistent(data)
                                           and len(data) >= 8)
    if binary:
        return _parse_binary(path, data, mode)
    return _parse_text(path, data, mode)


def _parse_binary(path: str, data: bytes, mode: str) -> np.ndarray:
    if len(data) < 8:
        raise MalformedArtifact(
            f"{path}: corrupt binary sequence — {len(data)} bytes is too "
            f"short for the uint64 size header")
    size = int(np.frombuffer(data[:8], dtype="<u8")[0])
    want = 8 + 4 * size
    if want != len(data):
        if _looks_text(data):
            raise MalformedArtifact(
                f"{path}: this is a TEXT sequence (digits/whitespace only) "
                f"opened as binary — pass binary=False")
        msg = (f"{path}: corrupt binary sequence — header claims {size} "
               f"vids ({want} bytes) but the file has {len(data)}")
        if mode != "repair":
            raise MalformedArtifact(msg)
        avail = (len(data) - 8) // 4
        if avail < size:  # truncated: keep the complete prefix
            warnings.warn(msg + f"; repair keeps the {avail} complete vids")
            size = avail
        else:  # oversized: the header is authoritative, ignore the tail
            warnings.warn(msg + "; repair ignores the trailing bytes")
    return np.frombuffer(data, dtype="<u4", count=size, offset=8).copy()


def _parse_text(path: str, data: bytes, mode: str) -> np.ndarray:
    if not data.strip():
        return np.empty(0, dtype=np.uint32)
    if not _looks_text(data):
        if _binary_consistent(data):
            raise MalformedArtifact(
                f"{path}: this is a BINARY sequence "
                f"({{uint64 size}}{{uint32 vid[]}}) opened as text — pass "
                f"binary=True")
        bad = next(i for i, b in enumerate(data) if b not in _TEXT_BYTES)
        raise MalformedArtifact(
            f"{path}: corrupt text sequence — non-digit byte "
            f"0x{data[bad]:02x} at offset {bad}")
    toks = data.split()
    try:
        vals = np.array(toks, dtype=np.int64)
    except (ValueError, OverflowError) as exc:
        raise MalformedArtifact(
            f"{path}: corrupt text sequence — unparseable token ({exc})")
    out_of_range = (vals < 0) | (vals > 0xFFFFFFFF)
    if out_of_range.any():
        j = int(np.flatnonzero(out_of_range)[0])
        raise MalformedArtifact(
            f"{path}: corrupt text sequence — token {toks[j].decode()!r} "
            f"is not a uint32 vid")
    return vals.astype(np.uint32)
