"""Anti-entropy for the serving fleet: divergence markers,
the artifact scrubber, and the quarantine convention they share.

Replication (PRs 7/16) makes a follower a byte-for-byte function of the
leader's stream — but only at apply time.  Two failure shapes escape
that proof and silently rot afterwards:

  in-memory divergence   a follower whose applied STATE drifts from the
                         leader's (cosmic bit-flip, a heisenbug in one
                         build, torn memory) keeps ACKing appends
                         forever; every read it serves is a lie.
  at-rest rot            a sealed artifact (.snap, archived epoch WAL,
                         .tre/.seq/.hist) whose bytes decay after the
                         sidecar vouched for them.  Nothing re-reads a
                         sealed file until the worst moment: restart,
                         failover, bootstrap.

Both get the same answer: CONTINUOUS re-verification, a DURABLE
quarantine that refuses to serve suspect data across kill -9, and
self-healing from a replica that still proves clean.

Stream anti-entropy
  The leader stamps ``REPL VERIFY epoch= seqno= crc=`` frames into the
  replication stream every ``SHEEP_SCRUB_VERIFY_N`` records (the crc is
  :meth:`ServeCore.state_crc` captured inside the apply critical
  section, so it names exactly one state).  A follower compares its own
  state_crc at the same applied seqno; a mismatch lands the durable
  quarantine marker (phase "diverged") BEFORE the stream tears, then
  replicate._heal_quarantine walks the marker through resync -> verify
  -> clear.  kill -9 at any boundary restarts into the recorded phase;
  the daemon refuses reads (``ERR diverged``) the whole way.

The quarantine marker (``quarantine.json``)
  One JSON object, landed tmp+fsync+rename (tenants.write_moved_marker
  discipline) so it fully exists or does not.  ``phase`` walks
  diverged -> resync -> verify; :func:`clear_quarantine` unlinks it.
  The marker is the single source of truth: daemon startup sweeps it
  into ``core.quarantined``, the replicator heals off it, STATS/METRICS
  export it, and the router excludes marked members from read spread.

The artifact scrubber
  :func:`run_scrub` walks a state dir's SEALED artifacts (snapshots,
  epoch-archived WALs, worker leg outputs) re-running the exact fsck
  checkers.  A failure is renamed to ``*.quarantined`` (sidecar rides
  along as ``*.quarantined.sum``) so no loader can ever pick it up,
  then repaired: snapshots reseal from the live core or fetch
  crc-verified from the leader over the replication wire; leg artifacts
  re-derive from surviving inputs (.dat -> .seq -> .tre, the sidecar's
  recorded range -> .hist); archived WALs retire when a clean
  later-epoch snapshot already covers their records.  Every run appends
  a hash-chained record to ``scrub.json`` — fsck validates the chain,
  so a tampered-with scrub history is itself detectable.

Rehearsal: ``SHEEP_IO_FAULT_PLAN``'s post-seal ``rot@site:nth`` kind
(io/faultfs.py) flips one published byte deterministically, and the
serve fault sites quar-*/scrub-* (serve/faults.py) kill at every phase
boundary.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time

from ..integrity.errors import IntegrityError, MalformedArtifact

# -- knobs -------------------------------------------------------------------

VERIFY_N_ENV = "SHEEP_SCRUB_VERIFY_N"
INTERVAL_ENV = "SHEEP_SCRUB_INTERVAL_S"
PACE_ENV = "SHEEP_SCRUB_PACE_S"
#: gates the CORRUPT verb (serve/daemon.py) — the bench/test-only
#: live-divergence injector a production daemon must refuse
ALLOW_CORRUPT_ENV = "SHEEP_SCRUB_ALLOW_CORRUPT"

DEFAULT_VERIFY_N = 256


def verify_cadence() -> int:
    """VERIFY-frame cadence in applied records (0 disables stamping).
    Cost scales as state_crc/N per insert on the leader — see
    PERF_NOTES.md before tightening it."""
    try:
        return max(0, int(os.environ.get(VERIFY_N_ENV, DEFAULT_VERIFY_N)))
    except ValueError:
        return DEFAULT_VERIFY_N


def scrub_interval_s() -> float:
    """Background scrub period in seconds (0 = background scrubbing
    off; ``sheep serve-ctl SCRUB`` still runs one inline)."""
    try:
        return max(0.0, float(os.environ.get(INTERVAL_ENV, "0")))
    except ValueError:
        return 0.0


def scrub_pace_s() -> float:
    """Sleep between artifacts inside one scrub pass — the pacing that
    keeps a big state dir's re-read from starving foreground I/O."""
    try:
        return max(0.0, float(os.environ.get(PACE_ENV, "0")))
    except ValueError:
        return 0.0


# -- the durable quarantine marker -------------------------------------------

QUARANTINE_NAME = "quarantine.json"

PHASE_DIVERGED = "diverged"
PHASE_RESYNC = "resync"
PHASE_VERIFY = "verify"
PHASES = (PHASE_DIVERGED, PHASE_RESYNC, PHASE_VERIFY)


def quarantine_path(state_dir: str) -> str:
    return os.path.join(state_dir, QUARANTINE_NAME)


def _land_json(path: str, rec: dict) -> None:
    """tmp + fsync + atomic rename: the marker fully exists or does not
    (a torn marker is no marker — tenants.write_moved_marker)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_quarantine(state_dir: str) -> dict | None:
    """The dir's quarantine marker, or None when it serves clean.  An
    unreadable marker is treated as QUARANTINED with an unknown phase:
    when the evidence of divergence is itself damaged, refusing reads
    is the only honest answer."""
    path = quarantine_path(state_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            rec = json.load(f)
        if not isinstance(rec, dict) or "phase" not in rec:
            raise ValueError("missing phase")
    except (OSError, ValueError):
        return {"phase": PHASE_DIVERGED, "reason": "unreadable-marker"}
    return rec


def enter_quarantine(state_dir: str, reason: str, seqno: int = 0,
                     epoch: int = 0, expect_crc: int = 0,
                     got_crc: int = 0) -> dict:
    """Durably mark ``state_dir`` diverged (phase "diverged").  Called
    BEFORE the stream tears / the caller fires its fault site, so a
    kill -9 one instruction later restarts already-quarantined.
    Idempotent: an existing marker is kept (the first divergence wins;
    re-entering must not rewind a marker already at resync/verify)."""
    existing = None
    if os.path.exists(quarantine_path(state_dir)):
        existing = read_quarantine(state_dir)
    if existing is not None and existing.get("phase") in PHASES:
        return existing
    rec = {"phase": PHASE_DIVERGED, "reason": reason,
           "seqno": int(seqno), "epoch": int(epoch),
           "expect_crc": int(expect_crc), "got_crc": int(got_crc),
           "at": time.time()}
    _land_json(quarantine_path(state_dir), rec)
    from ..obs import trace as obs
    obs.event("serve.diverged", reason=reason, seqno=int(seqno),
              expect_crc=int(expect_crc), got_crc=int(got_crc))
    return rec


def mark_phase(state_dir: str, phase: str, **fields) -> dict:
    """Advance the marker to ``phase`` (durable before the caller fires
    the matching fault site).  Extra ``fields`` (rejoin crc/seqno at
    phase "verify") land in the marker for the post-mortem trail."""
    if phase not in PHASES:
        raise ValueError(f"unknown quarantine phase {phase!r} "
                         f"(want one of {'/'.join(PHASES)})")
    rec = read_quarantine(state_dir) or {"reason": "direct"}
    rec["phase"] = phase
    rec["phase_at"] = time.time()
    for k, v in fields.items():
        rec[k] = v
    _land_json(quarantine_path(state_dir), rec)
    return rec


def clear_quarantine(state_dir: str) -> None:
    """Durably re-admit the dir (unlink is atomic; the fsync'd parent
    is the caller's restart path's problem, and a resurrected marker
    after power loss only re-runs an idempotent heal)."""
    try:
        os.unlink(quarantine_path(state_dir))
    except OSError:
        pass


# -- the quarantine naming convention ----------------------------------------

QUAR_SUFFIX = ".quarantined"

_ARCHIVE_RE = re.compile(r"^serve-e(\d{6})\.wal$")


def quarantined_paths(root: str) -> list[str]:
    """Every ``*.quarantined`` artifact under ``root`` (sidecars ride
    along as ``*.quarantined.sum`` and are not listed separately)."""
    out = []
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name.endswith(QUAR_SUFFIX):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def quarantine_artifact(path: str) -> str:
    """Rename ``path`` (and its sidecar) out of every loader's sight:
    ``x.tre`` -> ``x.tre.quarantined``, ``x.tre.sum`` ->
    ``x.tre.quarantined.sum``.  The sidecar keeps pairing with the
    renamed artifact, so fsck can still say exactly HOW the bytes lie
    and a reclaim (``sheep fsck --repair``) can verify + rename back.
    Returns the quarantined name."""
    from ..integrity.sidecar import sidecar_path
    qpath = path + QUAR_SUFFIX
    side = sidecar_path(path)
    if os.path.exists(side):
        os.replace(side, sidecar_path(qpath))
    os.replace(path, qpath)
    from ..io.atomic import _fsync_dir
    _fsync_dir(path)
    return qpath


def reclaim_quarantined(qpath: str) -> str:
    """``sheep fsck --repair``'s reclaim: a quarantined artifact whose
    bytes NOW verify (the rot was transient — a flaky controller, a
    restored volume) is renamed back under its real name.  Verification
    runs on the quarantined name first; anything still corrupt raises
    and stays quarantined."""
    from ..integrity.fsck import fsck_file
    from ..integrity.sidecar import sidecar_path
    if not qpath.endswith(QUAR_SUFFIX):
        raise ValueError(f"{qpath}: not a *{QUAR_SUFFIX} artifact")
    path = qpath[:-len(QUAR_SUFFIX)]
    if os.path.exists(path):
        raise IntegrityError(
            f"{qpath}: {os.path.basename(path)} already exists — the "
            f"repair that replaced it won; refusing to clobber")
    detail = fsck_file(qpath, "strict")  # raises if still corrupt
    qside = sidecar_path(qpath)
    if os.path.exists(qside):
        os.replace(qside, sidecar_path(path))
    os.replace(qpath, path)
    from ..io.atomic import _fsync_dir
    _fsync_dir(path)
    return detail


# -- the hash-chained scrub manifest -----------------------------------------

SCRUB_MANIFEST = "scrub.json"
SCRUB_CHAIN_KEEP = 64


def scrub_manifest_path(state_dir: str) -> str:
    return os.path.join(state_dir, SCRUB_MANIFEST)


def _record_hash(rec: dict) -> str:
    body = {k: v for k, v in rec.items() if k != "hash"}
    blob = json.dumps(body, sort_keys=True).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


def load_scrub_manifest(state_dir: str) -> list[dict]:
    """The dir's scrub run history, oldest first (empty when never
    scrubbed).  Unparseable raises — the landing is atomic, so garbage
    is tampering or rot, never a crash."""
    path = scrub_manifest_path(state_dir)
    if not os.path.exists(path):
        return []
    try:
        with open(path, encoding="utf-8") as f:
            runs = json.load(f)
    except (OSError, ValueError) as exc:
        raise MalformedArtifact(f"{path}: unreadable scrub manifest "
                                f"({exc})")
    if not isinstance(runs, list):
        raise MalformedArtifact(f"{path}: scrub manifest is not a list")
    return runs


def append_scrub_record(state_dir: str, rec: dict) -> dict:
    """Chain + land one run record: ``prev`` is the last record's hash
    (\"\" for the first), ``hash`` covers the whole record, and the list
    is trimmed to SCRUB_CHAIN_KEEP with the trimmed prefix's hash kept
    as the anchor, so the retained chain still verifies."""
    runs = load_scrub_manifest(state_dir)
    rec = dict(rec)
    rec["prev"] = runs[-1]["hash"] if runs else ""
    rec["hash"] = _record_hash(rec)
    runs.append(rec)
    if len(runs) > SCRUB_CHAIN_KEEP:
        runs = runs[-SCRUB_CHAIN_KEEP:]
    _land_json(scrub_manifest_path(state_dir), runs)
    return rec


def verify_scrub_chain(state_dir: str) -> str:
    """fsck's scrub-history check: every retained record's hash must
    cover its body, and every link's ``prev`` must equal its
    predecessor's hash.  Returns a detail string; raises on a broken
    chain.  (The oldest retained record's ``prev`` is unverifiable
    after trimming — that anchor is accepted as-is, like a git shallow
    clone's boundary.)"""
    runs = load_scrub_manifest(state_dir)
    prev = None
    for i, rec in enumerate(runs):
        if not isinstance(rec, dict) or "hash" not in rec:
            raise MalformedArtifact(
                f"{scrub_manifest_path(state_dir)}: run {i} is not a "
                f"hashed record")
        if _record_hash(rec) != rec["hash"]:
            raise MalformedArtifact(
                f"{scrub_manifest_path(state_dir)}: run {i} hash does "
                f"not cover its body — edited after landing")
        if prev is not None and rec.get("prev") != prev:
            raise MalformedArtifact(
                f"{scrub_manifest_path(state_dir)}: run {i} does not "
                f"chain to run {i - 1} — a record was dropped or forged")
        prev = rec["hash"]
    return f"scrub-chain runs={len(runs)} chain-ok"


# -- the scrubber ------------------------------------------------------------

#: sealed artifact kinds one scrub pass re-verifies (the live WAL is
#: mid-append and belongs to crash recovery, not anti-entropy)
SEALED_SUFFIXES = (".snap", ".tre", ".seq", ".hist")


def sealed_artifacts(state_dir: str) -> list[str]:
    """The dir's sealed artifacts: snapshots + worker leg outputs by
    suffix, plus epoch-archived WALs (the LIVE WAL is excluded — it is
    legitimately mid-append)."""
    from .wal import archived_wal_paths
    out = []
    try:
        names = sorted(os.listdir(state_dir))
    except OSError:
        return []
    for name in names:
        if name.endswith(SEALED_SUFFIXES):
            out.append(os.path.join(state_dir, name))
    out.extend(archived_wal_paths(state_dir))
    return sorted(set(out))


def _sibling(path: str, suffix: str) -> str | None:
    """The input artifact a re-derivation needs: same stem first
    (``x.seq`` -> ``x.dat``), else the dir's UNIQUE file of that suffix
    (a state dir with one graph), else None (ambiguity is not repair)."""
    stem = os.path.splitext(path)[0] + suffix
    if os.path.exists(stem):
        return stem
    d = os.path.dirname(path) or "."
    hits = [os.path.join(d, n) for n in sorted(os.listdir(d))
            if n.endswith(suffix) and not n.endswith(QUAR_SUFFIX)]
    return hits[0] if len(hits) == 1 else None


def _repair_snap(path: str, core=None, leader=None,
                 tenant: str | None = None) -> str:
    """A rotted snapshot generation: the STATE is fine (it lives in
    memory / the WAL), only this sealed copy lies.  A live core reseals
    a fresh generation; otherwise fetch the leader's crc-verified blob
    over the replication wire (the bootstrap shape)."""
    if core is not None:
        core.seal_snapshot()
        return "resealed-from-live-core"
    if leader is None:
        raise IntegrityError(f"{path}: no live core and no leader to "
                             f"repair a snapshot from")
    from ..integrity.sidecar import write_sidecar
    from .replicate import fetch_snapshot
    from .state import load_serve_snapshot, snap_name
    host, port = leader
    blob, seqno, epoch, sig = fetch_snapshot(host, port, tenant=tenant)
    out = os.path.join(os.path.dirname(path), snap_name(seqno))
    tmp = out + ".fetch"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    snap = load_serve_snapshot(tmp, integrity="trust")
    snap.validate()
    if sig and snap.sig != sig:
        os.unlink(tmp)
        raise IntegrityError(
            f"repair snapshot sig {snap.sig[:12]}... does not match the "
            f"advertised {sig[:12]}...")
    os.replace(tmp, out)
    write_sidecar(out)
    return f"fetched-from-leader seqno={seqno}"


def _repair_wal_archive(qpath: str) -> str:
    """An epoch-archived WAL exists only to prove the seqno hand-off
    across its promotion boundary; any clean LATER-epoch snapshot
    covers every record it held by construction.  Repair is therefore
    coverage retirement: find that snapshot, leave the rotted archive
    quarantined."""
    from .state import load_serve_snapshot, snap_paths
    m = _ARCHIVE_RE.match(os.path.basename(qpath[:-len(QUAR_SUFFIX)]))
    epoch = int(m.group(1)) if m else -1
    root = os.path.dirname(qpath)
    for snap_path in snap_paths(root):
        try:
            snap = load_serve_snapshot(snap_path, integrity="strict")
        except (IntegrityError, OSError):
            continue
        if snap.epoch > epoch:
            return (f"retired-by-snapshot "
                    f"{os.path.basename(snap_path)} epoch={snap.epoch}")
    raise IntegrityError(
        f"{qpath}: no clean later-epoch snapshot covers archived epoch "
        f"{epoch} — the archive's records are not provably redundant")


def _repair_seq(path: str) -> str:
    from ..core.sequence import degree_sequence
    from ..io.edges import load_edges
    from ..io.seqfile import write_sequence
    dat = _sibling(path, ".dat")
    if dat is None:
        raise IntegrityError(f"{path}: no sibling .dat to re-derive the "
                             f"sequence from")
    edges = load_edges(dat)
    seq = degree_sequence(edges.tail, edges.head)
    write_sequence(seq, path)
    return f"re-derived-from {os.path.basename(dat)}"


def _repair_tre(path: str) -> str:
    from ..cli.graph2tree import _tree_sig
    from ..io.seqfile import read_sequence
    from ..io.trefile import write_tree
    from ..ops.extmem import build_forest_extmem
    dat = _sibling(path, ".dat")
    seq_path = _sibling(path, ".seq")
    if dat is None or seq_path is None:
        raise IntegrityError(f"{path}: need sibling .dat + .seq to "
                             f"rebuild the tree")
    seq = read_sequence(seq_path, binary="auto")
    seq, forest = build_forest_extmem(dat, seq=seq)
    write_tree(path, forest.parent, forest.pst_weight, sig=_tree_sig(seq))
    return (f"rebuilt-from {os.path.basename(dat)}+"
            f"{os.path.basename(seq_path)}")


def _repair_hist(path: str, qpath: str) -> str:
    """The surviving sidecar (renamed along with the artifact) records
    the leg's TRUE range — re-run pass 1 over exactly that slice."""
    from ..integrity.sidecar import read_sidecar
    from ..ops.distext import write_histogram
    from ..ops.extmem import range_degree_histogram
    side = read_sidecar(qpath)
    rng = (side or {}).get("range", "")
    try:
        a, b = (int(x) for x in rng.split(":"))
    except ValueError:
        raise IntegrityError(
            f"{path}: quarantined sidecar records no range — cannot "
            f"name the slice to re-derive")
    dat = _sibling(path, ".dat")
    if dat is None:
        raise IntegrityError(f"{path}: no sibling .dat to re-derive the "
                             f"histogram from")
    # a worker's slice file holds records [a, b) at LOCAL offsets
    # [0, b-a) (worker._run_leg); a whole-graph .dat needs the true range
    lo, hi = (0, b - a) if ".slice." in os.path.basename(dat) else (a, b)
    deg, max_vid, records = range_degree_histogram(
        dat, start_edge=lo, end_edge=hi)
    write_histogram(path, deg, records, max_vid, a, b)
    return f"re-derived-from {os.path.basename(dat)} range={a}:{b}"


def repair_artifact(qpath: str, core=None, leader=None,
                    tenant: str | None = None) -> str:
    """Repair one quarantined artifact back under its real name (the
    quarantined copy STAYS — it is the evidence).  Raises IntegrityError
    when no repair input survives; the artifact then remains quarantined
    and reported, never silently dropped."""
    path = qpath[:-len(QUAR_SUFFIX)]
    if path.endswith(".snap"):
        detail = _repair_snap(path, core=core, leader=leader,
                              tenant=tenant)
    elif path.endswith(".wal"):
        detail = _repair_wal_archive(qpath)
    elif path.endswith(".seq"):
        detail = _repair_seq(path)
    elif path.endswith(".tre"):
        detail = _repair_tre(path)
    elif path.endswith(".hist"):
        detail = _repair_hist(path, qpath)
    else:
        raise IntegrityError(f"{qpath}: no repair recipe for this "
                             f"artifact kind")
    if os.path.exists(path):
        from ..integrity.fsck import fsck_file
        fsck_file(path, "strict")  # a repair that does not verify raises
    return detail


def run_scrub(state_dir: str, core=None, leader=None,
              tenant: str | None = None, pace_s: float | None = None,
              fire_faults: bool = True) -> dict:
    """One scrub pass over ``state_dir``: re-verify every sealed
    artifact, quarantine + repair failures, chain the run record.

    ``core``: the live ServeCore over this dir (enables snapshot
    resealing).  ``leader``: (host, port) of a replica to fetch
    snapshots from when there is no live core.  ``pace_s``: sleep
    between artifacts (None: the SHEEP_SCRUB_PACE_S knob).

    Returns counts: checked/failed/quarantined/repaired/unrepaired,
    plus per-artifact ``events`` [(path, verdict, detail)].
    """
    from ..integrity.fsck import fsck_file
    from ..obs import trace as obs
    from . import faults as serve_faults
    if pace_s is None:
        pace_s = scrub_pace_s()
    counts = {"checked": 0, "failed": 0, "quarantined": 0,
              "repaired": 0, "unrepaired": 0, "events": []}
    with obs.span("serve.scrub", dir=os.path.basename(state_dir)):
        # resume first: a kill between quarantine and repair on a
        # previous pass left a *.quarantined with NO real-name artifact
        # — it no longer matches the sealed walk below, so it must be
        # swept explicitly or it stays unrepaired forever
        for qpath in quarantined_paths(state_dir):
            path = qpath[:-len(QUAR_SUFFIX)]
            if os.path.exists(path):
                continue  # repaired already, or a fresh scrub's work
            if path.endswith(".wal"):
                # archive "repair" is coverage retirement: it restores
                # no real-name artifact, so re-sweeping it would
                # re-prove (and re-count) the same retirement forever.
                # The rename already IS the containment.
                continue
            if path.endswith(".snap"):
                # snapshot repair may reseal under a DIFFERENT seqno
                # filename; any surviving real-name snapshot in the dir
                # already supersedes the quarantined generation
                from .state import snap_paths
                if snap_paths(os.path.dirname(qpath) or "."):
                    continue
            try:
                detail = repair_artifact(qpath, core=core, leader=leader,
                                         tenant=tenant)
            except (IntegrityError, OSError) as exc:
                counts["unrepaired"] += 1
                counts["events"].append((path, "unrepaired", str(exc)))
                continue
            counts["repaired"] += 1
            counts["events"].append((path, "repaired",
                                     f"resumed: {detail}"))
            obs.event("scrub.repair", path=os.path.basename(path))
            if fire_faults:
                serve_faults.fire("scrub-repair")
        for path in sealed_artifacts(state_dir):
            if pace_s:
                time.sleep(pace_s)
            counts["checked"] += 1
            try:
                fsck_file(path, "strict")
                continue
            except (IntegrityError, OSError) as exc:
                counts["failed"] += 1
                verdict = str(exc)
            obs.event("scrub.rot", path=os.path.basename(path))
            qpath = quarantine_artifact(path)
            counts["quarantined"] += 1
            if fire_faults:
                serve_faults.fire("scrub-quar")
            try:
                detail = repair_artifact(qpath, core=core, leader=leader,
                                         tenant=tenant)
            except (IntegrityError, OSError) as exc:
                counts["unrepaired"] += 1
                counts["events"].append(
                    (path, "unrepaired", f"{verdict}; {exc}"))
                continue
            counts["repaired"] += 1
            counts["events"].append((path, "repaired", detail))
            obs.event("scrub.repair", path=os.path.basename(path))
            if fire_faults:
                serve_faults.fire("scrub-repair")
        append_scrub_record(state_dir, {
            "at": time.time(),
            "checked": counts["checked"],
            "failed": counts["failed"],
            "repaired": counts["repaired"],
            "unrepaired": counts["unrepaired"],
            "detail": [(os.path.basename(p), v, d)
                       for p, v, d in counts["events"]],
        })
    return counts
