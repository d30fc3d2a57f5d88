"""``sheep fsck`` core: verify any artifact, or a whole trial directory
(port of sheep_tpu/integrity/fsck.py).

One function per artifact class; each returns a human-readable summary on
success and raises IntegrityError (or OSError) on any corruption.  The
checks are layered: the sidecar checksum first (when one exists), then
the format's structural invariants, then cheap semantic invariants.

A state dir's distext ``manifest.json`` is checked as a chain: the
manifest verifies, its shard map covers the graph's records, and every
published ``.hist`` covers its leg's shard.

Artifacts of modules the port has not ported yet are found and reported
as failures naming the ROADMAP.md queue item they wait for, never passed
and never skipped: the serve daemon's ``.wal`` logs and ``.snap``
snapshots and its reseq, scrub and quarantine chains (``serve/``).
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
#: logs, ``.hist`` = the distext legs' per-range degree histograms;
#: ``.wal``/``.snap`` belong to the unported serving tier)
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


def _fsck_hist(path: str, mode: str) -> str:
    """Verify a distext per-range histogram: sidecar
    checksum, magic/length/int64 dtype, nonnegativity, and the range
    invariants (records == slice length, degree total == 2 x records,
    the max vid really appears).  The cross-artifact half — a histogram
    whose range disagrees with the distext manifest's shard map — is
    checked by :func:`fsck_distext_manifest` when fsck walks a state
    dir."""
    from ..ops.distext import read_histogram

    h = read_histogram(path, integrity=mode)
    return (f"n={len(h['deg'])} records={h['records']} "
            f"range=[{h['start']}:{h['end']}) max_vid={h['max_vid']}")


def fsck_distext_manifest(state_dir: str,
                          mode: str | None = None) -> str | None:
    """Verify a distext state dir's shard-map chain: the
    manifest loads + verifies, its shards are a contiguous edge-disjoint
    cover of the graph's record count, and every published ``.hist``
    artifact's recorded range matches its leg's shard — a histogram
    whose coverage disagrees with the manifest is REFUSED here, because
    summing it would produce a plausible-looking but wrong sequence.

    Returns the summary line, or None when the directory's manifest is
    a plain (non-distext) tournament; raises on any corruption."""
    from ..ops.distext import read_histogram
    from ..supervisor.manifest import load_manifest

    mode = resolve_policy(mode)
    manifest = load_manifest(state_dir, mode)
    if manifest.shards is None:
        return None
    shards = [(int(a), int(b)) for a, b in manifest.shards]
    at = 0
    for i, (a, b) in enumerate(shards):
        if a != at or b < a:
            raise MalformedArtifact(
                f"{state_dir}: shard map is not a contiguous cover — "
                f"shard {i} is [{a}:{b}) but the previous one ends at "
                f"{at}")
        at = b
    if manifest.graph.endswith(".dat") and manifest.graph_bytes >= 0 \
            and at != manifest.graph_bytes // 12:
        raise MalformedArtifact(
            f"{state_dir}: shard map covers {at} records but the "
            f"manifest's graph has {manifest.graph_bytes // 12}")
    checked = 0
    for leg in manifest.legs:
        if leg.kind != "hist" or not os.path.exists(leg.output):
            continue
        h = read_histogram(leg.output, integrity=mode)
        a, b = shards[leg.index]
        if (h["start"], h["end"]) != (a, b):
            raise MalformedArtifact(
                f"{leg.output}: histogram covers "
                f"[{h['start']}:{h['end']}) but the manifest's shard "
                f"map assigns leg {leg.index} [{a}:{b}) — refusing a "
                f"histogram that disagrees with the manifest")
        checked += 1
    return (f"distext legs={len(shards)} records={at} "
            f"hists={checked}/{len(shards)} shard-map-ok")


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
    ".hist": _fsck_hist,
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
        chain = _manifest_chain_result(root, mode)
        chains = _unported_chain_results(root)
        if not targets and chain is None and not chains:
            results.append((root, False, "no artifacts found"))
            continue
        for path in targets:
            try:
                detail = fsck_file(path, mode)
                results.append((path, True, detail))
            except (IntegrityError, OSError) as exc:
                results.append((path, False, str(exc)))
        if chain is not None:
            results.append(chain)
        results.extend(chains)
    failures = [r for r in results if not r[1]]
    return results, failures


def _manifest_chain_result(root: str, mode: str):
    """The distext shard-map chain line for a state-dir root,
    or None when the root is a file / has no manifest / holds a plain
    tournament."""
    if not os.path.isdir(root) \
            or not os.path.exists(os.path.join(root, "manifest.json")):
        return None
    mpath = os.path.join(root, "manifest.json")
    try:
        detail = fsck_distext_manifest(root, mode)
    except (IntegrityError, OSError) as exc:
        return (mpath, False, str(exc))
    if detail is None:
        return None
    return (mpath, True, detail)
