"""Retention-policy GC for managed artifact directories.

When the disk budget (or the filesystem itself) runs short, the owners of
a managed directory — the checkpoint dir (runtime/snapshot.Checkpointer)
and the supervisor state dir (supervisor/supervise) — reclaim space HERE,
under one policy with two invariants:

  keep-resumable   nothing a resume needs is ever deleted: the caller
                   names the protected set explicitly (the live snapshot
                   + sidecar, the manifest, every artifact a pending leg
                   still consumes, the final tree).  Protection is by
                   real path, so a candidate reached through a different
                   spelling cannot dodge it.
  keep-last-k      of the UNPROTECTED candidates, the k newest (mtime)
                   survive — an operator poking at yesterday's artifacts
                   gets a grace window; k=0 reclaims everything
                   unprotected.

Candidates are reclaimed oldest-first until the requested bytes are free
(or the candidates run out).  Sidecars travel with their artifacts in
BOTH directions: deleting ``foo.tre`` deletes ``foo.tre.sum`` (a sidecar
with no artifact vouches for nothing), and a sidecar is never deleted
while its artifact survives.  Orphaned atomic-write temps
(``.{name}.*.tmp`` — a killed writer's debris, io/atomic.py) are always
candidates regardless of age: no resume ever reads one.
"""

from __future__ import annotations

import os
import re

from ..integrity.sidecar import SIDECAR_SUFFIX

#: the io/atomic.py temp naming: .{basename}.{random}.tmp
_TMP_RE = re.compile(r"^\..*\.tmp$")


def is_orphan_temp(name: str) -> bool:
    return bool(_TMP_RE.match(name))


def is_live_temp(name: str, live_bases) -> bool:
    """Is this dot-temp a LIVE writer's in-flight file?  ``live_bases``
    are the final basenames concurrent writers are currently producing
    (io/atomic.py names their temps ``.{base}.{random}.tmp``).  The
    "orphan temps are debris" assumption only holds when nothing is
    writing — a mid-run sweep (the supervisor's ENOSPC recovery, with
    sibling attempts still in flight IN PROCESS) must leave these alone
    or it unlinks a healthy attempt's rename source out from under it."""
    if not _TMP_RE.match(name):
        return False
    return any(name.startswith(f".{b}.") for b in live_bases)


def _candidates(directory: str, protect: set[str]) -> list[tuple]:
    """(mtime, size, path, is_temp) of every reclaimable file directly
    under ``directory`` (non-recursive: managed dirs are flat; a
    recursive sweep could eat a nested state dir someone pointed inside).
    Sidecars are folded into their artifact's entry."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    have = set(names)
    for name in names:
        if name.endswith(SIDECAR_SUFFIX) \
                and name[: -len(SIDECAR_SUFFIX)] in have:
            continue  # travels with its artifact
        path = os.path.join(directory, name)
        real = os.path.realpath(path)
        if real in protect or not os.path.isfile(path):
            continue
        try:
            st = os.lstat(path)
        except OSError:
            continue
        size = st.st_size
        sc = path + SIDECAR_SUFFIX
        if os.path.exists(sc):
            try:
                size += os.lstat(sc).st_size
            except OSError:
                pass
        out.append((st.st_mtime, size, path, is_orphan_temp(name)))
    return out


def gc_orphan_temps(directory: str, live_bases=()) -> list[str]:
    """Remove orphaned atomic-write temps under ``directory``.  A temp
    under the dot-name is unpublished debris from a killed or faulted
    writer — no reader ever opens one — EXCEPT the in-flight temps of
    writers that are still running: mid-run callers (the supervisor's
    leg-failure sweep, with sibling attempts live in process) pass the
    final basenames those writers are producing as ``live_bases`` so
    their rename sources survive (:func:`is_live_temp`).  Resume entry
    points have no concurrent writers and pass nothing."""
    removed = []
    try:
        names = os.listdir(directory)
    except OSError:
        return removed
    for name in names:
        if is_orphan_temp(name) and not is_live_temp(name, live_bases):
            path = os.path.join(directory, name)
            try:
                os.unlink(path)
                removed.append(path)
            except OSError:
                pass
    return removed


def retention_gc(directory: str, protect=(), keep_last: int = 1,
                 need: int = 0, live_bases=()) -> tuple[int, list[str]]:
    """Reclaim at least ``need`` bytes from ``directory`` (0 = reclaim
    every eligible candidate) under the module-docstring policy.

    ``protect``: paths a resume still needs — never touched.
    ``keep_last``: newest unprotected non-temp survivors.
    ``live_bases``: final basenames of writes currently in flight —
    their dot-temps are rename sources, not debris (:func:`is_live_temp`).

    Returns (bytes_freed, removed_paths).  Best-effort: an unlinkable
    candidate is skipped, not fatal (the caller's budget re-check decides
    whether enough was reclaimed).
    """
    protect_real = {os.path.realpath(p) for p in protect}
    cands = sorted(c for c in _candidates(directory, protect_real)
                   if not is_live_temp(os.path.basename(c[2]),
                                       live_bases))
    # keep-last-k applies to real artifacts only; orphan temps are
    # always reclaimable
    non_temp = [c for c in cands if not c[3]]
    keep = {c[2] for c in non_temp[len(non_temp) - keep_last:]} \
        if keep_last > 0 else set()
    freed = 0
    removed: list[str] = []
    for _, size, path, _ in cands:
        if need and freed >= need:
            break
        if path in keep:
            continue
        ok = True
        for p in (path, path + SIDECAR_SUFFIX):
            try:
                os.unlink(p)
                removed.append(p)
            except FileNotFoundError:
                pass
            except OSError:
                ok = False
        if ok:
            freed += size
    return freed, removed
