"""``sheep fsck`` core: verify any artifact, or a whole trial directory
(port of sheep_tpu/integrity/fsck.py).

One function per artifact class; each returns a human-readable summary on
success and raises IntegrityError (or OSError) on any corruption.  The
checks are layered: the sidecar checksum first (when one exists), then
the format's structural invariants, then cheap semantic invariants.

Artifacts of modules the port has not ported yet are found and reported
as failures naming the ROADMAP.md queue item they wait for, never passed
and never skipped: the serve daemon's ``.wal`` logs and ``.snap``
snapshots and its reseq, scrub and quarantine chains (``serve/``), and
the distext ``.hist`` histograms and the supervisor's ``manifest.json``
(``ops/distext.py``, ``supervisor/``).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from .. import INVALID_JNID, unported
from ..io.edges import read_dat, read_net
from ..io.seqfile import read_sequence
from ..io.trefile import read_tree
from ..obs.trace import is_rotated_segment, read_trace
from ..runtime.snapshot import load_snapshot
from .errors import IntegrityError, MalformedArtifact
from .sidecar import read_sidecar, resolve_policy, verify_file, write_sidecar

#: suffixes fsck finds (``.npz`` = runtime snapshots, ``.trace`` = span
#: logs; ``.wal``/``.snap``/``.hist`` belong to unported modules)
ARTIFACT_SUFFIXES = (".tre", ".seq", ".dat", ".net", ".npz",
                     ".wal", ".snap", ".trace", ".hist")


class UnportedArtifact(IntegrityError):
    """An artifact whose checker needs a module the port has not ported:
    a failure, so fsck never vouches for bytes it cannot check."""


def _fsck_tre(path: str, mode: str) -> str:
    parent, pst = read_tree(path, integrity=mode)
    linked = parent != INVALID_JNID
    return (f"n={len(parent)} links={int(linked.sum())} "
            f"pst_total={int(pst.sum())}")


def _fsck_seq(path: str, mode: str) -> str:
    seq = read_sequence(path, binary="auto", integrity=mode)
    if len(seq) and len(np.unique(seq)) != len(seq):
        raise MalformedArtifact(
            f"{path}: corrupt sequence — duplicate vids (an elimination "
            f"order visits each vertex once)")
    return f"m={len(seq)}"


def _fsck_dat(path: str, mode: str) -> str:
    el = read_dat(path, integrity=mode)
    return f"records={el.num_edges}"


def _fsck_net(path: str, mode: str) -> str:
    el = read_net(path, integrity=mode)
    return f"records={el.num_edges}"


def _fsck_npz(path: str, mode: str) -> str:
    snap = load_snapshot(path, integrity=mode)
    return (f"n={snap.n} links={len(snap.lo)} rounds={snap.rounds} "
            f"rung={snap.rung}")


def _fsck_trace(path: str, mode: str) -> str:
    """Verify a span log (obs/trace.py): every line parses as a JSON trace
    record; a torn trailing line (the kill -9 shape) is refused strict and
    reported truncatable in repair; an unparseable line with intact
    records after it is mid-file rot, refused in every mode.  A rotated
    segment had its tail sealed at rotation, so it is read strictly even
    under repair (trust still trusts)."""
    rotated = is_rotated_segment(path)
    if rotated and mode != "trust":
        mode = "strict"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the tear shows in the detail
        records, _, torn = read_trace(path, mode)
    spans = sum(1 for r in records if r.get("k") == "span")
    events = sum(1 for r in records if r.get("k") == "ev")
    segments = sum(1 for r in records if r.get("k") == "meta")
    detail = (f"records={len(records)} spans={spans} events={events} "
              f"segments={segments}")
    if rotated:
        detail += " segment=rotated"
    if torn:
        detail += " torn_tail=truncatable"
    return detail


def _unported_checker(what: str, *keys: str):
    def check(path: str, mode: str) -> str:
        raise UnportedArtifact(f"{path}: checking {what} "
                               f"{unported(*keys)}")
    return check


_CHECKERS = {
    ".tre": _fsck_tre,
    ".seq": _fsck_seq,
    ".dat": _fsck_dat,
    ".net": _fsck_net,
    ".npz": _fsck_npz,
    ".wal": _unported_checker("a serve write-ahead log", "serve"),
    ".snap": _unported_checker("a serve snapshot", "serve"),
    ".trace": _fsck_trace,
    ".hist": _unported_checker("a distext degree histogram", "distext",
                               "supervisor"),
}


def fsck_file(path: str, mode: str | None = None) -> str:
    """Verify one artifact; returns a summary string or raises."""
    mode = resolve_policy(mode)
    for suffix, checker in _CHECKERS.items():
        if path.endswith(suffix):
            detail = checker(path, mode)
            status = "sum=" + _sidecar_state(path, mode)
            return f"{detail} {status}"
    # unknown suffix: the sidecar (if any) is still checkable
    state = verify_file(path, mode)
    if state == "no-sidecar":
        raise MalformedArtifact(
            f"{path}: not a sheep artifact (want one of "
            f"{'/'.join(_CHECKERS)}) and no sidecar to verify")
    return f"opaque bytes sum={state}"


def _sidecar_state(path: str, mode: str) -> str:
    if mode == "trust":
        return "trusted"
    try:
        return "absent" if read_sidecar(path) is None else "verified"
    except MalformedArtifact:
        return "unreadable"


def collect_artifacts(root: str) -> list[str]:
    """Every checkable artifact under ``root`` (a file is itself)."""
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name.endswith(ARTIFACT_SUFFIXES):
                out.append(os.path.join(dirpath, name))
    return out


def repair_sidecar(path: str) -> str:
    """Reseal ``path``'s ``.sum`` sidecar after verifying the artifact
    STRUCTURALLY (``fsck --repair-sidecar``): a sidecar that was lost or
    is wrong for bytes that still parse.  Every format and semantic check
    still runs, only the checksum layer is skipped, so garbage is refused.
    The old sidecar's ``sig`` is dropped: bytes that no longer match their
    sidecar cannot prove their tie to a build input.  Returns the check
    summary; raises IntegrityError when the artifact does not verify."""
    for suffix, checker in _CHECKERS.items():
        if path.endswith(suffix):
            detail = checker(path, "trust")
            break
    else:
        raise MalformedArtifact(
            f"{path}: not a sheep artifact (want one of "
            f"{'/'.join(_CHECKERS)}) — nothing to reseal")
    write_sidecar(path)
    return detail


#: state-dir chains of unported modules: (file or marker name, what it
#: is, the queue items its check waits for)
_UNPORTED_CHAINS = (
    ("manifest.json", "the supervisor's manifest and the distext shard map",
     ("supervisor", "distext")),
    ("reseq.json", "the serve re-sequence generation chain", ("serve",)),
    ("scrub.json", "the serve scrub history chain", ("serve",)),
    ("quarantine.json", "the serve quarantine marker", ("serve",)),
)
_QUAR_SUFFIX = ".quarantined"


def _unported_chain_results(root: str) -> list:
    """A failure line for each chain of an unported module found in a
    state dir, and for each quarantined artifact under it."""
    if not os.path.isdir(root):
        return []
    out = []
    for name, what, keys in _UNPORTED_CHAINS:
        path = os.path.join(root, name)
        if os.path.exists(path):
            out.append((path, False, f"checking {what} {unported(*keys)}"))
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name.endswith(_QUAR_SUFFIX):
                out.append((os.path.join(dirpath, name), False,
                            f"checking an artifact the serve scrubber "
                            f"quarantined {unported('serve')}"))
    return out


def fsck_paths(paths, mode: str | None = None):
    """Verify every artifact reachable from ``paths``.

    Returns (results, failures): ``results`` is a list of
    (path, ok, detail) in check order; ``failures`` the failing subset.
    """
    mode = resolve_policy(mode)
    results = []
    for root in paths:
        targets = collect_artifacts(root)
        chains = _unported_chain_results(root)
        if not targets and not chains:
            results.append((root, False, "no artifacts found"))
            continue
        for path in targets:
            try:
                detail = fsck_file(path, mode)
                results.append((path, True, detail))
            except (IntegrityError, OSError) as exc:
                results.append((path, False, str(exc)))
        results.extend(chains)
    failures = [r for r in results if not r[1]]
    return results, failures
