"""``.tre`` tree-file I/O (port of sheep_tpu/io/trefile.py).

Byte-compatible with the reference's JNodeTable persistence
(lib/jnode.cpp:164-168 save / :76-102 mmap-open): a little-endian ``uint32
end_id`` header followed by ``end_id`` records of ``{uint32 parent, uint32
pst_weight}``.  ``INVALID_JNID`` (0xFFFFFFFF) marks roots.

Writes seal a ``.sum`` sidecar (integrity.sidecar); reads verify it and
reject every way the bytes can lie (a short header, a torn record, an
``end_id`` past the payload, an out-of-range or non-monotone parent) with
a typed MalformedArtifact.  ``sig`` records the producing build's input
signature in the sidecar.  A file either package writes reads back in the
other, byte for byte.
"""

from __future__ import annotations

import warnings

import numpy as np

from .. import INVALID_JNID
from ..integrity.errors import MalformedArtifact
from ..integrity.sidecar import checksummed_write, resolve_policy, verify_bytes

_NODE_DTYPE = np.dtype([("parent", "<u4"), ("pst_weight", "<u4")])


def write_tree(path: str, parent: np.ndarray, pst_weight: np.ndarray,
               sig: str | None = None) -> None:
    if len(parent) != len(pst_weight):
        raise ValueError(f"parent and pst_weight lengths differ: "
                         f"{len(parent)} vs {len(pst_weight)}")
    rec = np.empty(len(parent), dtype=_NODE_DTYPE)
    rec["parent"] = parent
    rec["pst_weight"] = pst_weight
    # crash-safe (a consumer polling for the file never sees a torn
    # prefix), and the exact size preflights the disk
    extra = {"sig": sig} if sig else None
    with checksummed_write(path, "wb", extra=extra,
                           expect_bytes=4 + rec.nbytes) as f:
        f.write(np.uint32(len(parent)).tobytes())
        f.write(rec.tobytes())


def read_tree(path: str,
              integrity: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Returns (parent, pst_weight) uint32 arrays of length end_id.

    ``integrity``: strict (default) / repair / trust — see
    integrity.sidecar.  Structural corruption raises MalformedArtifact in
    every mode; only the checksum layer and best-effort salvage differ.
    """
    mode = resolve_policy(integrity)
    with open(path, "rb") as f:
        data = f.read()
    verify_bytes(path, data, mode)
    if len(data) < 4:
        raise MalformedArtifact(
            f"{path}: corrupt tree — {len(data)} bytes is too short for "
            f"the uint32 end_id header")
    end_id = int(np.frombuffer(data[:4], dtype="<u4")[0])
    body = data[4:]
    if len(body) % _NODE_DTYPE.itemsize:
        msg = (f"{path}: corrupt tree — record region of {len(body)} bytes "
               f"is not a multiple of {_NODE_DTYPE.itemsize} (torn record)")
        if mode != "repair":
            raise MalformedArtifact(msg)
        warnings.warn(msg + "; dropping the partial trailing record")
        body = body[: len(body) - len(body) % _NODE_DTYPE.itemsize]
    rec = np.frombuffer(body, dtype=_NODE_DTYPE)
    if end_id > len(rec):
        raise MalformedArtifact(
            f"{path}: corrupt tree — end_id {end_id} > {len(rec)} stored "
            f"nodes (header lies about the payload)")
    rec = rec[:end_id]
    parent = rec["parent"].copy()
    # Reject corrupt trees up front: every parent must be INVALID or a valid
    # LATER node id (elimination forests only ever link to strictly later
    # positions; the reference dies on such input via live asserts, and
    # downstream passes here index by parent and must never see an OOB or
    # cyclic value).
    linked = parent != INVALID_JNID
    bad = linked & (parent >= end_id)
    if bad.any():
        raise MalformedArtifact(
            f"{path}: corrupt tree — node {int(np.flatnonzero(bad)[0])} has "
            f"parent {int(parent[bad][0])} >= end_id {end_id}")
    ids = np.arange(end_id, dtype=np.uint32)
    non_mono = linked & (parent <= ids)
    if non_mono.any():
        j = int(np.flatnonzero(non_mono)[0])
        raise MalformedArtifact(
            f"{path}: corrupt tree — node {j} has parent {int(parent[j])} "
            f"<= itself (parents must be strictly later positions)")
    return parent, rec["pst_weight"].copy()
