"""Versioned sidecar checksums for every durable artifact.

Each artifact ``foo.tre`` gets a tiny text sidecar ``foo.tre.sum`` written
through the same crash-safe path as the artifact itself (io/atomic.py):

    sheep-sum 1
    algo crc32c
    size 1432
    sum 9a3c1f08
    sig 5f1d...        (optional: the producing build's input signature)

``algo`` is CRC32C (Castagnoli) when a native implementation is importable
(``google_crc32c`` or ``crc32c``), else zlib's CRC-32 — both are recorded,
so a reader verifies with whatever the writer used; a pure-python CRC32C
over multi-GB edge files would be slower than the disks it guards, so the
dependency is gated, not required.  ``sig`` ties an artifact to the build
input that produced it (runtime.snapshot.input_signature); merge_trees
refuses to zip trees whose signatures disagree.

Writer contract (hardened): the sidecar lands FIRST, then the
artifact — the same ordering as every other publish in the system
(scripts/lib.sh ``sheep_mv_artifact``, the supervisor's publish).  Both
renames are atomic and the sidecar rename happens via
``atomic_write``'s ``pre_publish`` seam, so ANY write failure — crash,
ENOSPC, injected fault (io/faultfs.py) — aborts with the previous
(artifact, sidecar) pair intact: a new artifact can never appear under
its final name without the checksum that vouches for it.  The remaining
crash window (new sidecar + old artifact) reads as a mismatch; "repair"
treats a mismatched pair as corrupt and a missing sidecar as unverified
— never as silently fine when a sidecar says otherwise.

Policy modes (env ``SHEEP_INTEGRITY``, default "strict"):

    strict   sidecar present + mismatch  -> ChecksumMismatch
             sidecar absent              -> accepted (foreign files have
                                            none); structural checks apply
    repair   mismatch -> warn, let the reader salvage what it can
    trust    skip checksum verification entirely (structural parse errors
             still raise)
"""

from __future__ import annotations

import contextlib
import os
import warnings
import zlib

from .errors import ChecksumMismatch, MalformedArtifact

# NOTE: io.atomic is imported lazily inside the writers.  A module-level
# import would cycle: integrity.sidecar -> io (package init) -> io.edges ->
# integrity.sidecar (mid-import).

SIDECAR_SUFFIX = ".sum"
SIDECAR_VERSION = 1

POLICIES = ("strict", "repair", "trust")

try:  # gated native CRC32C (the container may or may not ship one)
    import google_crc32c as _crc32c_mod

    def _crc32c(data: bytes, crc: int = 0) -> int:
        return _crc32c_mod.extend(crc, data)
except ImportError:
    try:
        import crc32c as _crc32c_mod2

        def _crc32c(data: bytes, crc: int = 0) -> int:
            return _crc32c_mod2.crc32c(data, crc)
    except ImportError:
        _crc32c = None

DEFAULT_ALGO = "crc32c" if _crc32c is not None else "crc32"


def resolve_policy(mode: str | None = None) -> str:
    """``mode`` if given, else SHEEP_INTEGRITY, else "strict"."""
    mode = mode or os.environ.get("SHEEP_INTEGRITY") or "strict"
    if mode not in POLICIES:
        raise ValueError(
            f"integrity mode {mode!r} must be one of {'/'.join(POLICIES)}")
    return mode


def crc_update(data: bytes, crc: int = 0, algo: str = DEFAULT_ALGO) -> int:
    if algo == "crc32":
        return zlib.crc32(data, crc)
    if algo == "crc32c":
        if _crc32c is None:
            raise MalformedArtifact(
                "sidecar uses crc32c but no crc32c implementation is "
                "available in this environment")
        return _crc32c(data, crc)
    raise MalformedArtifact(f"unknown sidecar checksum algo {algo!r}")


def sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def write_sidecar(path: str, crc: int | None = None, size: int | None = None,
                  algo: str = DEFAULT_ALGO,
                  extra: dict | None = None,
                  data_path: str | None = None) -> str:
    """Write ``path``'s sidecar.  With crc/size None the artifact is read
    back and summed (the npz writer seeks, so its bytes cannot be teed);
    ``data_path`` reads the bytes from a different file — the sealed
    temp, for writers that sum before publishing (:func:`sealed_write`)."""
    if crc is None or size is None:
        crc, size = 0, 0
        with open(data_path or path, "rb") as f:
            while True:
                block = f.read(1 << 24)
                if not block:
                    break
                crc = crc_update(block, crc, algo)
                size += len(block)
    from ..io.atomic import atomic_write
    sc = sidecar_path(path)
    with atomic_write(sc, "w") as f:
        f.write(f"sheep-sum {SIDECAR_VERSION}\n")
        f.write(f"algo {algo}\n")
        f.write(f"size {size}\n")
        f.write(f"sum {crc & 0xFFFFFFFF:08x}\n")
        for k, v in (extra or {}).items():
            f.write(f"{k} {v}\n")
    return sc


def read_sidecar(path: str) -> dict | None:
    """Parse ``path``'s sidecar; None when there is none.  An unparseable
    sidecar raises MalformedArtifact — a sidecar that cannot vouch for its
    artifact must never read as 'no sidecar, accept'."""
    sc = sidecar_path(path)
    try:
        with open(sc, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    try:
        text = raw.decode("ascii")
        lines = [ln for ln in text.splitlines() if ln.strip()]
        head = lines[0].split()
        if head[0] != "sheep-sum":
            raise ValueError("bad magic")
        out: dict = {"version": int(head[1])}
        for ln in lines[1:]:
            k, v = ln.split(None, 1)
            out[k] = v.strip()
        out["size"] = int(out["size"])
        out["sum"] = int(out["sum"], 16)
        if out["version"] > SIDECAR_VERSION:
            raise ValueError(f"sidecar version {out['version']} "
                             f"> supported {SIDECAR_VERSION}")
        if out["algo"] not in ("crc32", "crc32c"):
            raise ValueError(f"unknown algo {out['algo']!r}")
        return out
    except (ValueError, IndexError, KeyError, UnicodeDecodeError) as exc:
        raise MalformedArtifact(
            f"{sc}: corrupt sidecar ({exc}) — cannot vouch for {path}")


def verify_bytes(path: str, data: bytes, mode: str | None = None) -> str:
    """Check ``data`` (the artifact's full bytes) against ``path``'s
    sidecar under the policy.  Returns "ok" / "no-sidecar" / "trusted" /
    "repair-mismatch"; raises ChecksumMismatch in strict mode."""
    mode = resolve_policy(mode)
    if mode == "trust":
        return "trusted"
    try:
        sc = read_sidecar(path)
    except MalformedArtifact:
        if mode == "repair":
            warnings.warn(f"{path}: unreadable sidecar; proceeding on "
                          f"structural checks only")
            return "repair-mismatch"
        raise
    if sc is None:
        return "no-sidecar"
    problems = []
    if sc["size"] != len(data):
        problems.append(f"size {len(data)} != recorded {sc['size']}")
    else:
        got = crc_update(data, 0, sc["algo"]) & 0xFFFFFFFF
        if got != sc["sum"]:
            problems.append(f"{sc['algo']} {got:08x} != recorded "
                            f"{sc['sum']:08x}")
    if not problems:
        return "ok"
    msg = f"{path}: checksum mismatch ({'; '.join(problems)}) — " \
          f"the artifact was corrupted after it was written"
    if mode == "repair":
        warnings.warn(msg + "; repair mode salvaging what parses")
        return "repair-mismatch"
    raise ChecksumMismatch(msg)


def verify_file(path: str, mode: str | None = None) -> str:
    """:func:`verify_bytes` reading the artifact from disk (streamed)."""
    mode = resolve_policy(mode)
    if mode == "trust":
        return "trusted"
    try:
        sc = read_sidecar(path)
    except MalformedArtifact:
        if mode == "repair":
            warnings.warn(f"{path}: unreadable sidecar; proceeding on "
                          f"structural checks only")
            return "repair-mismatch"
        raise
    if sc is None:
        return "no-sidecar"
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 24)
            if not block:
                break
            crc = crc_update(block, crc, sc["algo"])
            size += len(block)
    if size == sc["size"] and (crc & 0xFFFFFFFF) == sc["sum"]:
        return "ok"
    msg = f"{path}: checksum mismatch (size {size} vs {sc['size']}, " \
          f"{sc['algo']} {crc & 0xFFFFFFFF:08x} vs {sc['sum']:08x})"
    if mode == "repair":
        warnings.warn(msg + "; repair mode salvaging what parses")
        return "repair-mismatch"
    raise ChecksumMismatch(msg)


class _CrcTee:
    """File-object proxy that checksums every byte written through it.
    Sequential writers only (the npz writer seeks; it uses read-back)."""

    def __init__(self, f, text: bool):
        self._f = f
        self._text = text
        self.crc = 0
        self.size = 0

    def write(self, data):
        b = data.encode("ascii") if self._text else data
        self.crc = crc_update(b, self.crc)
        self.size += len(b)
        return self._f.write(data)

    def flush(self):
        return self._f.flush()


@contextlib.contextmanager
def checksummed_write(path: str, mode: str = "wb",
                      extra: dict | None = None,
                      expect_bytes: int | None = None):
    """:func:`io.atomic.atomic_write` + a sidecar sealed sidecar-first.

    The sidecar lands first (via the ``pre_publish`` seam, after the
    artifact's bytes are durable at the temp name), the artifact second
    (module docstring).  On any exception — including mid-write
    ENOSPC/EIO, real or injected — neither appears and the previous
    (artifact, sidecar) pair is untouched.  ``expect_bytes`` enables the
    disk preflight (io/atomic.py).
    """
    from ..io.atomic import atomic_write
    tee_box: list = []

    def seal(tmp: str) -> None:
        tee = tee_box[0]
        write_sidecar(path, tee.crc, tee.size, extra=extra)

    with atomic_write(path, mode, expect_bytes=expect_bytes,
                      pre_publish=seal) as f:
        tee = _CrcTee(f, text=(mode == "w"))
        tee_box.append(tee)
        yield tee


@contextlib.contextmanager
def sealed_write(path: str, mode: str = "wb", extra: dict | None = None,
                 expect_bytes: int | None = None):
    """:func:`checksummed_write` for SEEKING writers (the npz snapshot):
    the bytes cannot be teed, so the fsync'd temp file is read back for
    the checksum — then the sidecar lands first and the artifact renames
    second, same invariant as every other writer."""
    from ..io.atomic import atomic_write

    def seal(tmp: str) -> None:
        write_sidecar(path, extra=extra, data_path=tmp)

    with atomic_write(path, mode, expect_bytes=expect_bytes,
                      pre_publish=seal) as f:
        yield f
