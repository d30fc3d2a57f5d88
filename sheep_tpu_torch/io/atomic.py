"""Crash-safe, exhaustion-aware file writes: preflight + temp file +
flush + fsync + atomic rename.

Every durable artifact this package writes (trees, sequences, partition
edge files, runtime checkpoints, supervisor manifests) goes through
:func:`atomic_write`, so a killed process can never leave a half-written
file under the final name — a reader either sees the old complete file or
the new complete one.  This is the file-level analog of the shell contract
in scripts/lib.sh ("producers write to a temp name and atomically mv into
place"), enforced at the library layer so Python callers cannot forget it.

The temp file lives in the SAME directory as the target (rename is only
atomic within a filesystem), and the directory entry is fsync'd after the
rename so the new name survives a power loss, not just a process kill.

Resource exhaustion extends the contract from "a kill never
publishes garbage" to "NOTHING ever publishes garbage":

  preflight   a writer that can estimate its size (``expect_bytes``)
              is refused up front when the filesystem cannot hold it
              with slack (resources/governor.py) — a typed
              :class:`~sheep_tpu_torch.resources.errors.DiskExhausted`, raised
              before any bytes land.
  typed fail  a REAL mid-write ENOSPC/EIO (and the injected kind —
              io/faultfs.py, ``SHEEP_IO_FAULT_PLAN``) unlinks the temp
              and re-raises as DiskExhausted/WriteFault, same errno, so
              recovery code has one exception surface for "the
              environment ran out", real or rehearsed.
  temp GC     a partial temp a kill DID strand (unlink never ran) is
              swept by `sheep_tpu_torch.resources.gc.gc_orphan_temps`
              at every resume entry point — orphaned debris never
              accumulates into its own disk-exhaustion cause.

Fault injection wraps the yielded file object (faultfs.wrap), so the
injected failure fires through the exact code path a real one would take:
writer -> OSError -> temp discarded -> typed re-raise -> nothing
published.
"""

from __future__ import annotations

import contextlib
import errno
import os
import tempfile

from ..resources.errors import DiskExhausted, WriteFault
from . import faultfs


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of the directory containing ``path`` (some
    filesystems/platforms disallow opening directories — not fatal)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _typed(exc: OSError, path: str) -> OSError:
    """The typed face of an environmental write failure; other OSErrors
    pass through unchanged."""
    if isinstance(exc, (DiskExhausted, WriteFault)):
        return exc
    if exc.errno == errno.ENOSPC:
        return DiskExhausted(f"{path}: write failed with ENOSPC "
                             f"({exc}); nothing was published")
    if exc.errno == errno.EIO:
        return WriteFault(f"{path}: write failed with EIO "
                          f"({exc}); nothing was published")
    return exc


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb",
                 expect_bytes: int | None = None,
                 pre_publish=None):
    """Context manager yielding a file object; on clean exit the data is
    flushed, fsync'd, and atomically renamed onto ``path``.  On an
    exception (or a kill) the target is untouched and the temp file is
    removed (or left as an orphaned dot-file a later resume sweeps —
    resources/gc.gc_orphan_temps).

    ``mode``: "wb" (default) or "w" for text.
    ``expect_bytes``: the writer's size estimate, enabling the disk
    preflight (a refusal raises DiskExhausted before any bytes land).
    ``pre_publish``: called with the (complete, fsync'd) temp path after
    the data is durable but BEFORE the rename — the sidecar-first seam
    (integrity/sidecar.py): a failure here aborts the publish with the
    target untouched, so an artifact can never appear under its final
    name ahead of (or without) the sidecar that vouches for it.
    """
    if mode not in ("wb", "w"):
        raise ValueError(f"atomic_write mode must be 'w' or 'wb', got {mode!r}")
    d = os.path.dirname(os.path.abspath(path)) or "."
    if expect_bytes is not None:
        from ..resources.governor import ResourceGovernor
        ResourceGovernor.from_env().preflight_write(d, expect_bytes)
    base = os.path.basename(path)
    fault = faultfs.arm(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{base}.", suffix=".tmp")
    f = os.fdopen(fd, mode)
    w = faultfs.wrap(f, fault, text=(mode == "w"))
    try:
        yield w
        f.flush()
        os.fsync(f.fileno())
        f.close()
        if pre_publish is not None:
            pre_publish(tmp)
        os.replace(tmp, path)
        _fsync_dir(path)
        # post-seal silent-corruption seam: a `rot@site:nth`
        # plan entry flips one published byte AFTER the rename — the
        # artifact lied to no writer, only a re-verification can see it
        faultfs.rot_after_seal(path)
    except BaseException as exc:
        try:
            f.close()
        except Exception:
            pass
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        if isinstance(exc, OSError):
            typed = _typed(exc, path)
            if typed is not exc:
                raise typed from exc
        raise
