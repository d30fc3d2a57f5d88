"""``sheep fsck`` core: verify any artifact, or a whole trial directory
(port of sheep_tpu/integrity/fsck.py).

One function per artifact class; each returns a human-readable summary on
success and raises IntegrityError (or OSError) on any corruption.  The
checks are layered: the sidecar checksum first (when one exists), then
the format's structural invariants, then cheap semantic invariants.

A state dir's distext ``manifest.json`` is checked as a chain: the
manifest verifies, its shard map covers the graph's records, and every
published ``.hist`` covers its leg's shard.  A serve state dir's ``.wal``
logs are checked against their sibling snapshots and logs (one build
input, disjoint epochs), its ``reseq.json`` as the re-sequence
generation chain that must sanction the newest snapshot's generation,
its ``scrub.json`` as the hash-chained scrub history, and its quarantine
marker and ``*.quarantined`` artifacts are reported, never loaded.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from .. import INVALID_JNID
from ..io.edges import read_dat, read_net
from ..io.seqfile import read_sequence
from ..io.trefile import read_tree
from ..obs.trace import is_rotated_segment, read_trace
from ..runtime.snapshot import load_snapshot
from .errors import IntegrityError, MalformedArtifact
from .sidecar import read_sidecar, resolve_policy, verify_file, write_sidecar

#: suffixes fsck finds (``.npz`` = runtime snapshots, ``.trace`` = span
#: logs, ``.hist`` = the distext legs' per-range degree histograms,
#: ``.wal``/``.snap`` = the serve store's log and snapshots)
ARTIFACT_SUFFIXES = (".tre", ".seq", ".dat", ".net", ".npz",
                     ".wal", ".snap", ".trace", ".hist")


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


def _fsck_wal(path: str, mode: str) -> str:
    """Verify the serve WAL chain: header magic/version/epoch,
    per-record crc32, strictly monotone sequence numbers, and the
    cross-artifact chain — the log and its sibling
    snapshot must name the same build input, a log whose epoch differs
    from the snapshot's must respect the promotion boundary (an
    earlier-epoch log may never reach PAST the later epoch's sealed
    seqno: that is a fenced ex-leader's divergent tail), and two sibling
    logs of different epochs must cover disjoint seqno ranges.  Strict
    refuses a torn tail; repair reports the salvageable prefix."""
    from ..serve.wal import read_wal

    sig, epoch, records, _, torn = read_wal(path, mode)
    last = records[-1][0] if records else 0
    first = records[0][0] if records else 0
    detail = f"records={len(records)} last_seqno={last} epoch={epoch}"
    if torn:
        detail += " torn_tail=truncatable"
    here = os.path.dirname(path) or "."
    # chain check against the newest loadable sibling snapshot — by
    # epoch first: a promotion crash window can leave the later term
    # under a lower applied-seqno filename (serve/state.py open)
    from ..serve.state import load_serve_snapshot, snap_paths
    best = None
    for snap_path in snap_paths(here):
        try:
            snap = load_serve_snapshot(snap_path, integrity="trust")
        except (IntegrityError, OSError):
            continue
        if best is None or ((snap.epoch, snap.applied_seqno)
                            > (best[1].epoch, best[1].applied_seqno)):
            best = (snap_path, snap)
    if best is not None:
        snap_path, snap = best
        if snap.sig != sig:
            # a sig mismatch is corruption UNLESS the reseq manifest
            # sanctions it: the crash window between the
            # re-sequence seal and the WAL swap leaves the old-sig log
            # beside the new-generation snapshot, and ServeCore.open
            # heals exactly that — provided no log record lies past the
            # snapshot boundary.  Records past it are the torn mid-swap
            # state: refused strict, reported truncatable in repair.
            from ..serve.reseq import sanctions_sig_change
            if not sanctions_sig_change(here, sig, snap.sig):
                raise MalformedArtifact(
                    f"{path}: WAL signature {sig[:12]}... does not match "
                    f"snapshot {os.path.basename(snap_path)} "
                    f"({snap.sig[:12]}...) — log and snapshot are not one "
                    f"recovery chain")
            beyond = sum(1 for s, _ in records
                         if s > snap.applied_seqno)
            if beyond:
                if mode != "repair":
                    raise MalformedArtifact(
                        f"{path}: torn mid-re-sequence swap — the "
                        f"old-generation log holds {beyond} record(s) "
                        f"past the re-sequenced snapshot boundary "
                        f"{snap.applied_seqno} "
                        f"({os.path.basename(snap_path)}); they were "
                        f"applied to a tree that no longer exists and "
                        f"can only be truncated (repair mode)")
                detail += (f" reseq_heal=pending "
                           f"torn_records={beyond} truncatable")
            else:
                detail += " reseq_heal=pending"
        if epoch < snap.epoch and records and last > snap.applied_seqno:
            raise MalformedArtifact(
                f"{path}: cross-epoch seqno overlap — the epoch-{epoch} "
                f"log reaches seqno {last}, past the epoch-{snap.epoch} "
                f"snapshot boundary {snap.applied_seqno} "
                f"({os.path.basename(snap_path)}); a fenced log may "
                f"never extend a later epoch's history")
        if epoch > snap.epoch:
            raise MalformedArtifact(
                f"{path}: WAL epoch {epoch} is ahead of every readable "
                f"snapshot (newest is epoch {snap.epoch}, "
                f"{os.path.basename(snap_path)}) — the promotion that "
                f"sealed epoch {epoch} left no loadable snapshot; the "
                f"chain cannot replay across that boundary")
        detail += f" chain={os.path.basename(snap_path)}"
    # sibling logs: different epochs must cover DISJOINT seqno ranges
    # (the archived pre-promotion log vs the live one)
    from ..serve.wal import archived_wal_paths, wal_path
    siblings = set(archived_wal_paths(here))
    live = wal_path(here)
    if os.path.exists(live):
        siblings.add(live)
    siblings.discard(os.path.abspath(path))
    siblings.discard(path)
    for other in sorted(siblings):
        try:
            o_sig, o_epoch, o_records, _, _ = read_wal(other, "repair")
        except (IntegrityError, OSError):
            continue  # the sibling fails on its own fsck line
        if o_sig != sig:
            # sibling logs across a sanctioned re-sequence (an archived
            # pre-reseq log beside the new-generation live one) are one
            # history in two generations, not two histories
            from ..serve.reseq import sanctions_sig_change
            if not (sanctions_sig_change(here, o_sig, sig)
                    or sanctions_sig_change(here, sig, o_sig)):
                raise MalformedArtifact(
                    f"{path}: sibling log {os.path.basename(other)} "
                    f"names a different build input ({o_sig[:12]}... vs "
                    f"{sig[:12]}...) — one state dir, two histories")
        if o_epoch == epoch or not records or not o_records:
            continue
        o_first, o_last = o_records[0][0], o_records[-1][0]
        lo_last, hi_first = ((last, o_first) if epoch < o_epoch
                             else (o_last, first))
        if hi_first <= lo_last:
            raise MalformedArtifact(
                f"{path}: cross-epoch seqno overlap with "
                f"{os.path.basename(other)} — epoch {min(epoch, o_epoch)}"
                f" ends at seqno {lo_last} but epoch "
                f"{max(epoch, o_epoch)} starts at {hi_first}; epochs "
                f"must hand off disjoint seqno ranges")
    return detail


def _fsck_snap(path: str, mode: str) -> str:
    from ..serve.state import load_serve_snapshot

    snap = load_serve_snapshot(path, integrity=mode)
    links = int((snap.parent != INVALID_JNID).sum())
    detail = (f"n={len(snap.seq)} links={links} "
              f"applied={snap.applied_seqno} epoch={snap.epoch} "
              f"inserted={len(snap.ins_tail)} parts={snap.num_parts}")
    if snap.seq_gen:
        detail += f" seq_gen={snap.seq_gen}"
    return detail


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


_CHECKERS = {
    ".tre": _fsck_tre,
    ".seq": _fsck_seq,
    ".dat": _fsck_dat,
    ".net": _fsck_net,
    ".npz": _fsck_npz,
    ".wal": _fsck_wal,
    ".snap": _fsck_snap,
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
        reseq_chain = _reseq_chain_result(root, mode)
        scrub_chain = _scrub_chain_result(root, mode)
        quarantined = _quarantined_results(root, mode)
        if not targets and chain is None and reseq_chain is None \
                and scrub_chain is None and not quarantined:
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
        if reseq_chain is not None:
            results.append(reseq_chain)
        if scrub_chain is not None:
            results.append(scrub_chain)
        results.extend(quarantined)
    failures = [r for r in results if not r[1]]
    return results, failures


def _scrub_chain_result(root: str, mode: str):
    """The anti-entropy scrub-history line for a state dir,
    or None when the root is a file / was never scrubbed.  The scrub
    manifest is hash-chained (serve/scrub.py), so an edited or dropped
    run record is a failure, not a shrug."""
    from ..serve import scrub as scrub_mod
    if not os.path.isdir(root):
        return None
    mpath = scrub_mod.scrub_manifest_path(root)
    if not os.path.exists(mpath):
        return None
    try:
        return (mpath, True, scrub_mod.verify_scrub_chain(root))
    except (IntegrityError, OSError) as exc:
        return (mpath, False, str(exc))


def _quarantined_results(root: str, mode: str):
    """The quarantine convention: ``*.quarantined`` artifacts
    are REPORTED, never loaded, and never counted as failures — the
    scrubber already did the failing; the rename IS the containment.
    Repair mode re-verifies each one and reclaims (renames back) those
    whose bytes now check out — the transient-rot case; anything still
    corrupt stays quarantined.  A dir-level quarantine marker
    (divergence, not rot) is reported the same way."""
    from ..serve import scrub as scrub_mod
    out = []
    if not os.path.isdir(root):
        return out
    marker = scrub_mod.read_quarantine(root) \
        if os.path.exists(scrub_mod.quarantine_path(root)) else None
    if marker is not None:
        out.append((scrub_mod.quarantine_path(root), True,
                    f"dir quarantined: phase={marker.get('phase', '?')} "
                    f"reason={marker.get('reason', '?')} — reads "
                    f"refused until the re-sync clears it"))
    for qpath in scrub_mod.quarantined_paths(root):
        if mode == "repair":
            try:
                detail = scrub_mod.reclaim_quarantined(qpath)
                out.append((qpath, True, f"reclaimed: {detail}"))
                continue
            except (IntegrityError, OSError) as exc:
                out.append((qpath, True,
                            f"quarantined, still corrupt — kept "
                            f"({exc})"))
                continue
        out.append((qpath, True,
                    "quarantined by the scrubber; never loaded "
                    "(repair mode re-verifies and reclaims)"))
    return out


def _reseq_chain_result(root: str, mode: str):
    """The re-sequence generation-chain line for a serve state dir,
    or None when the root is a file / never re-sequenced
    AND its snapshots are all generation 0.

    What it refuses: a snapshot claiming a sequence generation its
    reseq manifest never sanctioned (silent tampering or a foreign
    snapshot dropped into the dir), an unparseable manifest, and — in
    strict mode — an in-flight manifest whose durable inputs are gone
    (phase ``swap`` with neither a pending artifact nor fold
    checkpoints, on a dir whose snapshot is still the OLD generation:
    resumable only by a full refold, which repair-mode reports and
    strict refuses to vouch for)."""
    from ..serve import reseq as reseq_mod
    from ..serve.state import load_serve_snapshot, snap_paths
    if not os.path.isdir(root):
        return None
    mpath = reseq_mod.manifest_path(root)
    has_manifest = os.path.exists(mpath)
    # newest loadable snapshot's (gen, sig) is what the chain must vouch
    best = None
    for snap_path in snap_paths(root):
        try:
            snap = load_serve_snapshot(snap_path, integrity="trust")
        except (IntegrityError, OSError):
            continue
        if best is None or ((snap.epoch, snap.applied_seqno)
                            > (best[1].epoch, best[1].applied_seqno)):
            best = (snap_path, snap)
    if not has_manifest:
        if best is not None and best[1].seq_gen:
            return (mpath, False,
                    f"{os.path.basename(best[0])} claims sequence "
                    f"generation {best[1].seq_gen} but no reseq manifest "
                    f"exists to sanction it — not one recovery chain")
        return None
    try:
        man = reseq_mod.load_manifest(root)
    except (IntegrityError, OSError) as exc:
        return (mpath, False, str(exc))
    phase = man.get("phase", "?")
    chain = [(int(c.get("gen", -1)), c.get("sig", ""))
             for c in man.get("chain", []) if isinstance(c, dict)]
    detail = f"phase={phase} generations={len(chain)}"
    if best is not None:
        snap_path, snap = best
        sanctioned = dict(chain)
        if phase in ("swap", "adopt", "done"):
            sanctioned.setdefault(int(man.get("new_gen", -1)),
                                  man.get("new_sig", ""))
        if sanctioned.get(snap.seq_gen) != snap.sig:
            return (mpath, False,
                    f"{os.path.basename(snap_path)} serves sequence "
                    f"generation {snap.seq_gen} (sig "
                    f"{snap.sig[:12]}...) which the reseq manifest "
                    f"chain never sanctioned — torn or foreign swap")
        detail += f" snap_gen={snap.seq_gen} chain-ok"
    if phase not in reseq_mod.DONE_PHASES:
        resumable = (os.path.exists(reseq_mod.pending_path(root))
                     or os.path.isdir(reseq_mod.ckpt_dir(root)))
        if phase == "swap" and not resumable \
                and best is not None \
                and best[1].seq_gen < int(man.get("new_gen", 0)):
            if mode != "repair":
                return (mpath, False,
                        f"in-flight re-sequence at phase=swap lost its "
                        f"pending artifact and checkpoints — resumable "
                        f"only by a full refold (repair mode reports, "
                        f"strict refuses)")
            detail += " in_flight=refold-required"
        else:
            detail += " in_flight=resumable"
    return (mpath, True, detail)


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
