"""``supervise --status``: the manifest as an operator table (port of
sheep_tpu/supervisor/status.py).

A crashed or long-running supervised tournament is a directory of state
(manifest.json, per-leg artifacts, heartbeat files, logs) that only the
supervisor itself could interpret.  This module renders it for a human:
per-leg state / dispatch counts / artifact presence / heartbeat age, plus
the resource headroom the budgets track (disk usage vs
``SHEEP_DISK_BUDGET`` and free space, RSS vs ``SHEEP_MEM_BUDGET``).

SERVE state dirs report too: pointed at a directory holding serve
snapshots instead of a manifest, ``--status`` asks the live daemon over
the wire (``STATS`` — role, epoch, applied seqno, per-follower
replication lag) and falls back to the daemon's persisted
``serve.status.json`` plus heartbeat age when the process is down — so
an outside monitor can alert on a dead, lagging, or fenced replica with
one command either way.

Read-only by design: --status never mutates the state dir (no GC, no
debris sweep, no manifest rewrite), so an operator can inspect a LIVE
run another supervisor owns without racing it.
"""

from __future__ import annotations

import glob
import os
import re
import time

from ..resources.governor import (ResourceGovernor, dir_usage, disk_free,
                                  rss_bytes)
from .manifest import DONE, Manifest, load_manifest, manifest_path


def _fmt_bytes(n: int | None) -> str:
    if n is None:
        return "-"
    for unit, shift in (("G", 30), ("M", 20), ("K", 10)):
        if abs(n) >= (1 << shift):
            return f"{n / (1 << shift):.1f}{unit}"
    return f"{n}B"


def _fmt_age(s: float | None) -> str:
    if s is None:
        return "-"
    if s < 120:
        return f"{s:.0f}s"
    if s < 7200:
        return f"{s / 60:.0f}m"
    return f"{s / 3600:.1f}h"


def _newest_heartbeat_age(output: str, now: float) -> float | None:
    """Age of the freshest beat among this leg's attempt heartbeats
    (``<output>.aN.hb``) — None when no attempt ever beat.  Stale files
    from dead attempts age honestly: a huge number reads as 'dead'."""
    newest = None
    for hb in glob.glob(glob.escape(output) + ".a*.hb"):
        try:
            m = os.path.getmtime(hb)
        except OSError:
            continue
        newest = m if newest is None else max(newest, m)
    return None if newest is None else max(0.0, now - newest)


def newest_trace_rollup(state_dir: str) -> dict | None:
    """Phase rollup of the newest ``*.trace`` flight-recorder file in
    the state dir, or None when there is none.  Read in
    repair mode — the trace of a KILLED run is exactly what an operator
    inspecting a state dir wants to see — torn tails reported, never
    fatal to the status view."""
    import warnings
    newest, newest_m = None, None
    try:
        for name in os.listdir(state_dir):
            if not name.endswith(".trace"):
                continue
            path = os.path.join(state_dir, name)
            try:
                m = os.path.getmtime(path)
            except OSError:
                continue
            if newest_m is None or m > newest_m:
                newest, newest_m = path, m
    except OSError:
        return None
    if newest is None:
        return None
    from ..obs.trace import read_trace, rollup
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            records, _, torn = read_trace(newest, "repair")
    except Exception:
        return {"path": newest, "error": "unreadable"}
    return {"path": newest, "torn": torn,
            "age_s": round(max(0.0, time.time() - newest_m), 3),
            "phases": rollup(records)}


def _trace_lines(state_dir: str) -> list[str]:
    """The human face of :func:`newest_trace_rollup` (top phases by
    total time), empty when the dir holds no trace."""
    roll = newest_trace_rollup(state_dir)
    if roll is None:
        return []
    lines = [f"trace: {os.path.basename(roll['path'])}"
             + (" [torn tail]" if roll.get("torn") else "")
             + (f"  ({_fmt_age(roll.get('age_s'))} old)"
                if roll.get("age_s") is not None else "")]
    phases = dict(roll.get("phases") or {})
    phases.pop("_events", None)
    top = sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])[:6]
    for name, p in top:
        lines.append(f"      {name:<26} x{p['count']:<5} "
                     f"{p['total_s']:.3f}s")
    return lines


#: the block size a leg's ext checkpoint was written at, recoverable
#: from its input_sig (ops/extmem: ``...|ext:b{block}|range:{a}:{b}``)
_SIG_BLOCK_RE = re.compile(r"\|ext:b(\d+)\b")


def _ext_progress(manifest: Manifest, leg, state_dir: str | None):
    """(blocks_done, blocks_total) of a distmap leg, read from the leg's
    own block-boundary checkpoint — None when the leg never
    checkpointed (not yet dispatched, or already finished and cleared)
    or the dir is unknown.  Read in trust mode: a status view reports, a
    resume verifies."""
    if leg.kind != "distmap" or state_dir is None \
            or manifest.shards is None:
        return None
    from ..ops.distext import leg_checkpoint_dir
    from ..runtime.snapshot import SNAPSHOT_NAME, load_snapshot
    path = os.path.join(leg_checkpoint_dir(state_dir, leg.key),
                        SNAPSHOT_NAME)
    try:
        snap = load_snapshot(path, integrity="trust")
    except Exception:
        return None
    m = _SIG_BLOCK_RE.search(snap.input_sig)
    if m is None:
        return None
    block = int(m.group(1))
    a, b = manifest.shards[leg.index]
    total = -(-max(0, int(b) - int(a)) // block) if block else 0
    return snap.rounds, total


def _wire_provenance(leg, state_dir: str | None) -> dict | None:
    """A remote leg's dispatch provenance (supervisor/remote.py writes
    ``wire-<artifact>.json`` per dispatch) — None for local legs.
    The wire-beat age is NOT here: BEAT frames touch the attempt's .hb
    file, so ``heartbeat_age_s`` already tells that story for remote
    legs."""
    from .remote import wire_status_path
    if state_dir is None:
        return None
    try:
        import json
        with open(wire_status_path(state_dir, leg.output)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def status_rows(manifest: Manifest, now: float | None = None,
                state_dir: str | None = None) -> list[dict]:
    """One dict per leg: key/kind/round/state/dispatches/artifact bytes
    (None = absent)/heartbeat age seconds (None = never beat).  distmap
    legs (the distributed out-of-core build) additionally
    report ``ext_blocks_done``/``ext_blocks_total`` from their own
    block-boundary checkpoint when ``state_dir`` is given — mid-leg
    progress an operator can read next to the heartbeat age.  Legs
    dispatched over the worker wire gain ``worker`` (the
    remote address), ``wire_dispatches``, and ``speculations`` from the
    dispatch provenance RemoteRunner records; their ``heartbeat_age_s``
    is the last WIRE beat's age (BEAT frames feed the same .hb file)."""
    now = time.time() if now is None else now
    rows = []
    for leg in manifest.legs:
        try:
            size = os.path.getsize(leg.output)
        except OSError:
            size = None
        row = dict(
            key=leg.key, kind=leg.kind, round=leg.round, state=leg.state,
            dispatches=leg.dispatches, artifact_bytes=size,
            heartbeat_age_s=_newest_heartbeat_age(leg.output, now))
        prog = _ext_progress(manifest, leg, state_dir)
        if prog is not None:
            row["ext_blocks_done"], row["ext_blocks_total"] = prog
        wire = _wire_provenance(leg, state_dir)
        if wire is not None:
            row["worker"] = wire.get("worker")
            row["wire_dispatches"] = wire.get("dispatches")
            row["speculations"] = wire.get("speculations")
        rows.append(row)
    return rows


def status_json(state_dir: str, integrity: str | None = None,
                governor: ResourceGovernor | None = None,
                now: float | None = None) -> dict:
    """The operator report as one JSON-safe dict (``--status --json``):
    what the table renders, minus the formatting — so the serve daemon's
    liveness probe and outside monitors consume leg states, heartbeat
    ages, and budget headroom without scraping the human table.  Same
    read-only contract as :func:`render_status`."""
    manifest = load_manifest(state_dir, integrity)
    gov = governor if governor is not None else ResourceGovernor.from_env()
    now = time.time() if now is None else now
    rows = status_rows(manifest, now, state_dir)
    usage = dir_usage(state_dir)
    rss = rss_bytes()
    out = {
        "graph": manifest.graph,
        "state_dir": state_dir,
        "workers": manifest.workers,
        "reduction": manifest.reduction,
        "done": manifest.done(),
        "legs_done": sum(1 for r in rows if r["state"] == DONE),
        "legs_total": len(rows),
        "dispatches": sum(r["dispatches"] for r in rows),
        "legs": rows,
        "disk": {
            "state_dir_bytes": usage,
            "free_bytes": disk_free(state_dir),
            "budget_bytes": gov.disk_budget,
            "headroom_bytes": (gov.disk_budget - usage
                               if gov.disk_budget is not None else None),
        },
        "mem": {
            "rss_bytes": rss,
            "budget_bytes": gov.mem_budget,
            "headroom_bytes": (gov.mem_budget - rss
                               if gov.mem_budget is not None else None),
        },
        # the newest flight-recorder file's phase rollup —
        # what the run was DOING, next to the heartbeat ages that say
        # whether it still is
        "trace": newest_trace_rollup(state_dir),
    }
    return out


def render_status(state_dir: str, integrity: str | None = None,
                  governor: ResourceGovernor | None = None,
                  now: float | None = None) -> str:
    """The full operator report for one state dir.  Raises
    IntegrityError/OSError when the manifest is missing or corrupt —
    a status view must never invent a healthier story than fsck would."""
    manifest = load_manifest(state_dir, integrity)
    gov = governor if governor is not None else ResourceGovernor.from_env()
    now = time.time() if now is None else now
    rows = status_rows(manifest, now, state_dir)
    done = sum(1 for r in rows if r["state"] == DONE)
    dispatches = sum(r["dispatches"] for r in rows)

    # the remote columns appear only when some leg actually went over
    # the worker wire — a purely local run's table is
    # byte-stable across this feature
    remote = any("worker" in r for r in rows)
    head = f"{'LEG':<8} {'KIND':<7} {'STATE':<8} {'DISP':>4} " \
           f"{'ARTIFACT':>9} {'HEARTBEAT':>9} {'PROGRESS':>9}"
    if remote:
        head += f" {'WORKER':<21} {'WDISP':>5} {'SPEC':>4}"
    lines = [
        f"supervised tournament: {manifest.graph}",
        f"state dir: {state_dir}",
        f"workers {manifest.workers}  reduction {manifest.reduction}  "
        f"legs {done}/{len(rows)} done  dispatches {dispatches}",
        "",
        head,
        "-" * len(head),
    ]
    for r in rows:
        # distmap legs show blocks-done/total from their own checkpoint
        # mid-leg progress next to the liveness signal
        prog = "-"
        if "ext_blocks_done" in r:
            prog = f"{r['ext_blocks_done']}/{r['ext_blocks_total']}blk"
        line = (
            f"{r['key']:<8} {r['kind']:<7} {r['state']:<8} "
            f"{r['dispatches']:>4} "
            f"{_fmt_bytes(r['artifact_bytes']):>9} "
            f"{_fmt_age(r['heartbeat_age_s']):>9} {prog:>9}")
        if remote:
            spec = r.get("speculations")
            line += (f" {r.get('worker') or '-':<21} "
                     f"{r.get('wire_dispatches') or '-':>5} "
                     f"{spec if spec is not None else '-':>4}")
        lines.append(line)

    usage = dir_usage(state_dir)
    free = disk_free(state_dir)
    lines += ["", f"disk: state dir {_fmt_bytes(usage)} used, "
                  f"{_fmt_bytes(free)} free on filesystem"]
    if gov.disk_budget is not None:
        lines.append(f"      budget {_fmt_bytes(gov.disk_budget)} "
                     f"(headroom {_fmt_bytes(gov.disk_budget - usage)})")
    rss = rss_bytes()
    mem = f"mem:  rss {_fmt_bytes(rss)}"
    if gov.mem_budget is not None:
        mem += f", budget {_fmt_bytes(gov.mem_budget)} " \
               f"(headroom {_fmt_bytes(gov.mem_budget - rss)})"
    lines.append(mem)
    lines += _trace_lines(state_dir)
    if not manifest.done():
        lines.append("resume: rerun `sheep supervise <graph> -d "
                     + state_dir + "` to fsck survivors and finish")
    return "\n".join(lines) + "\n"


def is_serve_dir(state_dir: str) -> bool:
    """Does this directory hold serve-daemon state (snapshots / WAL /
    status file) rather than a tournament manifest?"""
    from ..serve.state import snap_paths
    if snap_paths(state_dir):
        return True
    return any(os.path.exists(os.path.join(state_dir, name))
               for name in ("serve.wal", "serve.status.json"))


def serve_status_json(state_dir: str) -> dict:
    """One serve node's operator report: role / epoch / applied seqno /
    replication lag, live over the wire when the daemon answers, else
    from its persisted status file — plus heartbeat age and the newest
    snapshot, so "down" and "fenced" are both visible."""
    from ..serve.daemon import HEARTBEAT_FILE, STATUS_FILE
    out: dict = {"state_dir": state_dir, "kind": "serve", "alive": False}
    hb = os.path.join(state_dir, HEARTBEAT_FILE)
    try:
        out["heartbeat_age_s"] = round(
            max(0.0, time.time() - os.path.getmtime(hb)), 3)
    except OSError:
        out["heartbeat_age_s"] = None
    addr_file = os.path.join(state_dir, "serve.addr")
    try:
        host, port = open(addr_file).read().split()
        out["addr"] = f"{host}:{port}"
    except (OSError, ValueError):
        host = None
    if host is not None:
        try:
            from ..serve.protocol import ServeClient
            with ServeClient(host, int(port), timeout_s=2.0) as c:
                out["stats"] = c.kv("STATS")
                out["alive"] = True
                for key in ("role", "epoch", "applied_seqno", "repl_lag",
                            "followers", "node", "leader", "moved_dest",
                            "mig_phase", "mig_lag", "migrating",
                            "seq_drift", "reseqs", "seq_gen",
                            "diverged", "scrub_runs",
                            "scrub_quarantined", "scrub_repaired",
                            "quarantine_heals"):
                    if key in out["stats"]:
                        out[key] = out["stats"][key]
        except Exception:
            pass
    if not out["alive"]:
        # the daemon's last persisted self-report (daemon.status_dict)
        try:
            import json
            with open(os.path.join(state_dir, STATUS_FILE)) as f:
                last = json.load(f)
            out["last_status"] = last
            for key in ("role", "epoch", "applied_seqno", "node",
                        "leader"):
                if key in last:
                    out[key] = last[key]
        except (OSError, ValueError):
            pass
        from ..serve.state import load_serve_snapshot, snap_paths
        snaps = snap_paths(state_dir)
        if snaps:
            out["newest_snapshot"] = os.path.basename(snaps[-1])
            if "epoch" not in out:
                try:
                    snap = load_serve_snapshot(snaps[-1],
                                               integrity="trust")
                    out["epoch"] = snap.epoch
                    out["applied_seqno"] = snap.applied_seqno
                except Exception:
                    pass
    # an in-flight re-sequence manifest is visible whether or
    # not the daemon answers — a down node mid-rebuild is exactly when
    # the operator needs to see it
    try:
        from ..serve import reseq as reseq_mod
        man = reseq_mod.load_manifest(state_dir)
        if man is not None and man.get("phase") not in reseq_mod.DONE_PHASES:
            out["reseq_phase"] = man.get("phase")
    except Exception:
        pass
    # a durable quarantine marker is likewise visible with
    # the daemon down — the operator must know this replica's state is
    # divergent BEFORE deciding to restart or promote it
    try:
        from ..serve import scrub as scrub_mod
        quar = scrub_mod.read_quarantine(state_dir)
        if quar is not None:
            out["quarantine_phase"] = quar.get("phase")
            out["diverged"] = 1
    except Exception:
        pass
    out["trace"] = newest_trace_rollup(state_dir)
    return out


def render_serve_status(state_dir: str) -> str:
    rec = serve_status_json(state_dir)
    lines = [f"serve node: {state_dir}",
             f"alive: {'yes' if rec['alive'] else 'NO (daemon down)'}"
             f"  heartbeat {_fmt_age(rec.get('heartbeat_age_s'))}"]
    for key in ("node", "role", "epoch", "applied_seqno", "leader",
                "repl_lag", "followers", "addr", "newest_snapshot",
                "moved_dest", "mig_phase", "mig_lag", "migrating",
                "seq_drift", "reseqs", "seq_gen", "reseq_phase",
                "diverged", "scrub_runs", "scrub_quarantined",
                "scrub_repaired", "quarantine_heals",
                "quarantine_phase"):
        if key in rec and rec[key] is not None:
            lines.append(f"{key}: {rec[key]}")
    st = rec.get("stats", {})
    lags = {k[4:]: v for k, v in st.items() if k.startswith("lag_")}
    if lags:
        lines.append("follower lag (records):")
        for node, lag in sorted(lags.items()):
            lines.append(f"  {node}: {lag}")
    lines += _trace_lines(state_dir)
    return "\n".join(lines) + "\n"


def main_status(state_dir: str, integrity: str | None = None,
                as_json: bool = False) -> int:
    """The CLI face: print the report (human table, or one JSON object
    with ``--json``); exit 0 when the manifest loads (even mid-run), 1
    when the state dir has no readable manifest.  Serve state dirs get
    the replication report instead (role/epoch/applied/lag)."""
    import sys
    if not os.path.exists(manifest_path(state_dir)):
        if os.path.isdir(state_dir) and is_serve_dir(state_dir):
            if as_json:
                import json
                json.dump(serve_status_json(state_dir), sys.stdout,
                          indent=2, sort_keys=True)
                sys.stdout.write("\n")
            else:
                sys.stdout.write(render_serve_status(state_dir))
            return 0
        print(f"supervise: no manifest in {state_dir}", file=sys.stderr)
        return 1
    try:
        if as_json:
            import json
            json.dump(status_json(state_dir, integrity), sys.stdout,
                      indent=2, sort_keys=True)
            sys.stdout.write("\n")
        else:
            sys.stdout.write(render_status(state_dir, integrity))
    except (ValueError, OSError) as exc:
        print(f"supervise: {exc}", file=sys.stderr)
        return 1
    return 0
