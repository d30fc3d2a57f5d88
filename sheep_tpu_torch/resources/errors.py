"""The resource-exhaustion error taxonomy: refusals, not surprises.

All types subclass :class:`ResourceError`, which itself subclasses
``OSError`` — the environmental failure domain (full disk, exhausted
memory budget) surfaces to callers through the same channel the OS itself
would use, so every existing ``except OSError`` recovery path (the
supervisor's attempt failure handling, the CLI top-levels) already treats
a budget refusal exactly like the real fault it prevents.  The split from
:class:`~sheep_tpu_torch.integrity.errors.IntegrityError` matters operationally:

  IntegrityError   the bytes are WRONG — retrying the same write cannot
                   help; the artifact (or its producer) is sick.
  ResourceError    the bytes never landed — the environment is out of
                   room.  The artifact under the final name is untouched
                   (writers never publish on refusal) and the run is
                   RESUMABLE once space/memory is reclaimed.

:class:`DiskExhausted` carries ``errno == ENOSPC`` and
:class:`WriteFault` carries ``errno == EIO``, so code that branches on
``exc.errno`` (and the shell, via exit status) cannot tell an injected
fault (io/faultfs.py) from the real one — which is the whole point of
deterministic fault injection.
"""

from __future__ import annotations

import errno


class ResourceError(OSError):
    """Base of every resource-budget refusal in sheep_tpu_torch."""


class DiskExhausted(ResourceError):
    """No room to write: the filesystem is (or would be left) too full,
    or the ``SHEEP_DISK_BUDGET`` cap would be exceeded.  The failed write
    published nothing; a later run resumes from the last durable state."""

    def __init__(self, msg: str):
        super().__init__(errno.ENOSPC, msg)


class WriteFault(ResourceError):
    """An I/O error (EIO / short write) mid-write: the device lied or
    died.  The failed write published nothing."""

    def __init__(self, msg: str):
        super().__init__(errno.EIO, msg)


class MemoryBudgetExceeded(ResourceError):
    """An allocation the analytic model prices over ``SHEEP_MEM_BUDGET``
    headroom was refused BEFORE it could OOM the process.  The chunk
    drivers respond by shrinking (chunk rounds, lifting depth) or
    degrading to the spill rung — never by dying."""

    def __init__(self, msg: str):
        super().__init__(errno.ENOMEM, msg)
