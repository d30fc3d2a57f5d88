"""Deterministic I/O fault injection: every write site, hurtable on cue.

FATE/DESTINI-style lesson (PAPERS.md): recovery code that has never seen
its fault fire is broken until proven otherwise — and real ENOSPC/EIO
never fires on a healthy CI disk.  This module is the hook: every durable
writer in the package opens its file through :func:`arm`/:func:`wrap`
(io/atomic.py does it for all of them), and an installed
:class:`IoFaultPlan` hurts exactly the ``nth`` write at a named site.
Grammar — the I/O sibling of the supervisor's ``SHEEP_FAULT_PLAN``
(supervisor/chaos.py) and the runtime's ``SHEEP_FAULT_INJECT``::

    SHEEP_IO_FAULT_PLAN = entry[,entry...]
    entry               = kind @ site : nth
    kind                = enospc | eio | short | slow | rot
    site                = tre | seq | dat | net | sidecar | ckpt |
                          wal | snap | hist | manifest | other | *
    nth                 = 0-based index of the write at that site
                          (for ``rot``: of the SEAL at that site)

e.g. ``SHEEP_IO_FAULT_PLAN=enospc@ckpt:1,short@tre:0``.  Sites are
artifact CLASSES, derived from the target path (:func:`site_for`) with
the supervisor's ``.aN`` attempt suffix stripped, so the same plan names
the same logical write whether the artifact lands directly or via a
temp-name publish.  Each entry fires exactly once; per-site indices count
from :func:`reset_counters` (per build/test), so "hurt ckpt write 1"
means the same write on every run.

The kinds model the distinct environmental failure shapes, each driving a
DIFFERENT recovery path:

  enospc  the disk fills mid-write: OSError(ENOSPC) from write().
          Recovery: the atomic writer discards its temp, nothing
          publishes, the caller's typed DiskExhausted path (GC + retry,
          or abort-resumable) runs.
  eio     the device fails: OSError(EIO).  Recovery: same discard
          invariant; retry territory for the supervisor.
  short   a torn write: a PREFIX of the first write lands in the temp
          file, then ENOSPC.  This is the case that distinguishes
          "atomic publish" from "hopeful publish" — the torn bytes must
          never appear under a final name.
  slow    writes stall (default 50ms each, ``:nth`` still selects the
          open): the watchdog/heartbeat shape.  Never fails the write.
  rot     silent POST-SEAL corruption: the write itself
          succeeds, the sidecar vouches for the published bytes — and
          then one byte of the artifact flips under its final name, the
          way a rotting disk or a torn page the kernel never surfaced
          would.  No error is raised at injection time; ONLY a later
          re-verification (the scrubber, fsck, the anti-entropy stream)
          can notice.  Fires from :func:`rot_after_seal` (io/atomic.py
          calls it after every atomic publish) and counts SEALS per
          site in its own counter space, so ``rot@snap:0`` means "the
          first snapshot sealed", independent of how many write-opens
          the same site saw.

Faults are injected at the Python file layer, byte-for-byte deterministic
under every runner — no filesystem setup, no privileges, works in CI.
"""

from __future__ import annotations

import errno
import os
import re
import time
from dataclasses import dataclass, field

IO_FAULT_PLAN_ENV = "SHEEP_IO_FAULT_PLAN"

KINDS = ("enospc", "eio", "short", "slow", "rot")

#: the kinds that fire on a write-open (everything except ``rot``, which
#: has its own post-seal channel so write counters never consume it)
_WRITE_KINDS = ("enospc", "eio", "short", "slow")

#: suffix -> site class (checked in order; .sum first so a tree's sidecar
#: is "sidecar", not "tre").  ``wal``/``snap`` are the serve daemon's
#: durability sites: the write-ahead log appends and the serving
#: snapshot seals, so kill/ENOSPC-at-every-insert-boundary recovery is
#: injectable with the same grammar as every offline site.
_SITE_SUFFIXES = ((".sum", "sidecar"), (".tre", "tre"), (".seq", "seq"),
                  (".dat", "dat"), (".net", "net"), (".npz", "ckpt"),
                  (".wal", "wal"), (".snap", "snap"), (".hist", "hist"))

_ATTEMPT_RE = re.compile(r"\.a\d+$")

_SLOW_S = 0.05


def site_for(path: str) -> str:
    """The fault-site class of a write target.  The supervisor's
    ``<output>.aN`` attempt temps resolve to their final class, and
    ``manifest.json`` is its own site (the one artifact that is pure
    orchestration state)."""
    base = os.path.basename(path)
    if base.endswith(".sum"):
        # a sidecar names its artifact's class; strip any attempt suffix
        # hiding between the artifact name and .sum (<out>.tre.a2.sum)
        base = _ATTEMPT_RE.sub("", base[: -len(".sum")]) + ".sum"
    else:
        base = _ATTEMPT_RE.sub("", base)
    if base == "manifest.json":
        return "manifest"
    for suffix, site in _SITE_SUFFIXES:
        if base.endswith(suffix):
            return site
    return "other"


@dataclass
class IoFault:
    kind: str
    site: str
    nth: int

    def matches(self, site: str, index: int) -> bool:
        return (self.site == "*" or self.site == site) and index == self.nth


@dataclass
class IoFaultPlan:
    """Parsed plan; entries pop as they fire (recovery writes run clean)."""

    faults: list[IoFault] = field(default_factory=list)

    def take(self, site: str, index: int,
             kinds: tuple | None = None) -> str | None:
        """Pop-and-return the first entry matching ``(site, index)``;
        ``kinds`` restricts which entries are eligible (the write channel
        must never consume a ``rot`` entry and vice versa)."""
        for i, f in enumerate(self.faults):
            if kinds is not None and f.kind not in kinds:
                continue
            if f.matches(site, index):
                del self.faults[i]
                return f.kind
        return None


def parse_io_fault_plan(spec: str) -> IoFaultPlan:
    faults = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            kind, at = entry.split("@", 1)
            site, nth = at.split(":", 1)
        except ValueError:
            raise ValueError(
                f"{IO_FAULT_PLAN_ENV} entry {entry!r}: want kind@site:nth "
                f"(e.g. enospc@ckpt:1)")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"{IO_FAULT_PLAN_ENV} entry {entry!r}: kind {kind!r} must "
                f"be one of {'/'.join(KINDS)}")
        faults.append(IoFault(kind=kind, site=site.strip(), nth=int(nth)))
    return IoFaultPlan(faults=faults)


_plan: IoFaultPlan | None = None
_env_spec: str | None = None
_counters: dict[str, int] = {}
_rot_counters: dict[str, int] = {}


def install_plan(plan: IoFaultPlan | None) -> None:
    """Install (or with None, clear) the active plan and reset counters."""
    global _plan, _env_spec
    _plan = plan
    _env_spec = None
    _counters.clear()
    _rot_counters.clear()


def clear_plan() -> None:
    install_plan(None)


def reset_counters() -> None:
    _counters.clear()
    _rot_counters.clear()


def _active_plan() -> IoFaultPlan | None:
    """The installed plan, else the env plan — parsed ONCE per spec value
    so per-site counters and already-fired entries survive across writes
    within the process."""
    global _plan, _env_spec
    if _plan is not None:
        return _plan
    spec = os.environ.get(IO_FAULT_PLAN_ENV, "")
    if not spec:
        return None
    if spec != _env_spec:
        _plan = parse_io_fault_plan(spec)
        _env_spec = spec
        return _plan
    return None


def arm(path: str) -> str | None:
    """Record one write-open of ``path``'s site and return the fault kind
    armed for it (None = healthy).  Called once per atomic_write."""
    site = site_for(path)
    index = _counters.get(site, 0)
    _counters[site] = index + 1
    plan = _active_plan()
    if plan is None:
        return None
    kind = plan.take(site, index, kinds=_WRITE_KINDS)
    if kind is not None:
        from ..obs import trace as _obs
        _obs.event("io.fault", site=site, index=index, kind=kind)
    return kind


def rot_after_seal(path: str) -> bool:
    """``rot@site:nth`` — flip one byte of the PUBLISHED artifact at
    ``path``, leaving its sidecar untouched (module docstring).  Called by
    io/atomic.py after every atomic publish and by the serve tier's WAL
    archiver; counts seals per site in its own counter space.  Returns
    True when a byte flipped."""
    site = site_for(path)
    index = _rot_counters.get(site, 0)
    _rot_counters[site] = index + 1
    plan = _active_plan()
    if plan is None:
        return False
    if plan.take(site, index, kinds=("rot",)) is None:
        return False
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size == 0:
        return False
    off = size // 2
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0x01]))
        f.flush()
        os.fsync(f.fileno())
    from ..obs import trace as _obs
    _obs.event("io.fault", site=site, index=index, kind="rot")
    return True


def hurt_read(path: str) -> None:
    """Arm-and-fire for READ sites: the streaming ``.dat``
    block reader calls this once per block, so ``kind@dat:nth`` hurts the
    nth BLOCK READ of an out-of-core stream exactly like it hurts the nth
    write of an offline run — one grammar, one counter space per site
    (reads and writes at the same site share indices; a build that does
    both is told so by its plan, not surprised).  Writers go through
    :func:`arm`/:func:`wrap` because their fault must tear the file;
    readers just need the typed OSError at the right moment: eio/enospc
    raise (ENOSPC models a reader whose backing filesystem went sick
    mid-stream — same errno the retry logic classifies), ``short`` maps
    to EIO (a torn read IS an I/O error to the consumer), ``slow`` stalls
    like the write kind."""
    kind = arm(path)
    if kind is None:
        return
    if kind == "slow":
        time.sleep(_SLOW_S)
        return
    if kind == "enospc":
        raise OSError(errno.ENOSPC,
                      "injected ENOSPC (SHEEP_IO_FAULT_PLAN) reading "
                      + path)
    raise OSError(errno.EIO,
                  f"injected {kind} (SHEEP_IO_FAULT_PLAN) reading {path}")


class FaultyFile:
    """File proxy that hurts writes per the armed kind.  Only the write
    path is proxied — flush/fileno/close pass through, so io/atomic.py's
    fsync/rename discipline sees the real file object underneath."""

    def __init__(self, f, kind: str, text: bool):
        self._f = f
        self._kind = kind
        self._text = text
        self._wrote = False

    def write(self, data):
        if self._f.closed:
            # a GC'd zipfile flushing its directory after the writer
            # already aborted and cleaned up: nothing durable can land
            # (the temp is gone) — swallow instead of raising from __del__
            return len(data)
        k = self._kind
        if k == "slow":
            time.sleep(_SLOW_S)
            return self._f.write(data)
        if k == "eio":
            raise OSError(errno.EIO, "injected EIO (SHEEP_IO_FAULT_PLAN)")
        if k == "enospc":
            raise OSError(errno.ENOSPC,
                          "injected ENOSPC (SHEEP_IO_FAULT_PLAN)")
        if k == "short":
            if not self._wrote:
                self._wrote = True
                half = data[: max(1, len(data) // 2)]
                self._f.write(half)
                self._f.flush()
            raise OSError(errno.ENOSPC,
                          "injected short write (SHEEP_IO_FAULT_PLAN): "
                          "a torn prefix landed in the temp file")
        raise AssertionError(f"unknown fault kind {k!r}")

    def flush(self):
        if self._f.closed:
            return None  # see write(): post-abort __del__ tolerance
        return self._f.flush()

    def fileno(self):
        return self._f.fileno()

    def close(self):
        return self._f.close()

    def seek(self, *args, **kwargs):
        if self._f.closed:
            return 0  # see write(): post-abort __del__ tolerance
        return self._f.seek(*args, **kwargs)

    def tell(self):
        if self._f.closed:
            return 0  # see write(): post-abort __del__ tolerance
        return self._f.tell()

    def __getattr__(self, name):
        # seeking writers (the npz zipfile layer) need read/seek/tell/
        # mode/...; everything but write() passes through untouched
        return getattr(self._f, name)


def wrap(f, kind: str | None, text: bool):
    """The file the writer should use: the real one when healthy, the
    fault proxy when a plan entry armed this open."""
    if kind is None:
        return f
    return FaultyFile(f, kind, text)
