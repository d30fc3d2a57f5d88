"""sheep trace: render a flight-recorder file for a human.

The port of sheep_tpu/cli/trace.py: the operational face of the
observability layer (sheep_tpu_torch/obs), and the precursor of the planner's
``plan --explain``: it answers "where did this build spend its time,
which ladder rung ran, and why" from the one trace file a run leaves
behind::

    python -m sheep_tpu_torch.cli.trace run.trace            # rollup + rungs + timeline
    python -m sheep_tpu_torch.cli.trace --json run.trace     # the same, as one JSON object
    python -m sheep_tpu_torch.cli.trace -m strict run.trace  # refuse a torn trace

Sections:

  rollup     per-phase span totals (count / total / max / % of wall)
  ladder     the rung-decision explanation: governor-priced peak vs the
             measured headroom per rung, which rung actually ran, every
             degrade hop, and the measured wall/RSS of the winner
  timeline   top spans in time order, indented by nesting, with a text
             duration bar (the poor terminal's flame graph)

``--merge`` switches to the FLEET view: the arguments become
dirs / globs / files naming many processes' traces, and the output is
one timeline per rid stitched across them — router retry, the dead
leader's final spans, the promoted leader's first fsync, one rid.
Clock alignment is per-file (obs/merge.py): rid-paired containment when
files share rids (offset reported with an honest ±bound), wall-clock
meta otherwise (bound reported unknown).  ``--rid <hex>`` picks one
request; ``-n`` caps how many rids render.

Default read policy is ``repair``: a kill -9 mid-run leaves a torn
trailing line by design (obs/trace.py), and the whole point of a flight
recorder is reading the wreckage; ``-m strict`` refuses the tear for
pipelines that must only consume sealed traces.  Exit codes: 0 rendered,
1 unreadable/corrupt, 2 usage error.
"""

from __future__ import annotations

import getopt
import json
import sys

from ..integrity.errors import IntegrityError
from ..integrity.sidecar import POLICIES
from ..obs.trace import read_trace, rollup

USAGE = ("USAGE: trace [-m strict|repair|trust] [--json] [-n N] "
         "file.trace\n"
         "       trace --merge [--rid RID] [--json] [-n N] "
         "<dir|glob|file>...")

#: timeline rows beyond this are elided (traces can carry one span per
#: chunk round; the timeline is for orientation, the rollup for totals)
DEFAULT_ROWS = 60


def _fmt_s(s: float) -> str:
    if s >= 100:
        return f"{s:.0f}s"
    if s >= 1:
        return f"{s:.2f}s"
    return f"{s * 1000:.1f}ms"


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit, shift in (("G", 30), ("M", 20), ("K", 10)):
        if abs(n) >= (1 << shift):
            return f"{n / (1 << shift):.1f}{unit}"
    return f"{int(n)}B"


def wall_seconds(records: list[dict]) -> float:
    """The trace's wall: last span/event end minus first start."""
    t_min, t_max = None, 0.0
    for r in records:
        if r.get("k") not in ("span", "ev"):
            continue
        t = float(r.get("t", 0.0))
        end = t + float(r.get("dur", 0.0))
        t_min = t if t_min is None else min(t_min, t)
        t_max = max(t_max, end)
    return max(0.0, t_max - (t_min or 0.0))


def ladder_explanation(records: list[dict]) -> list[str]:
    """The rung-decision story: plan (price vs headroom per rung),
    degrades, and the rung that finished with its measured cost."""
    lines: list[str] = []
    rung_spans = {}
    for r in records:
        if r.get("k") == "span" and r.get("name") == "rung":
            rung_spans[r.get("a", {}).get("rung", "?")] = r
    for r in records:
        if r.get("k") != "ev":
            continue
        a = r.get("a", {})
        name = r.get("name")
        if name == "ladder.plan":
            planned = a.get("rungs", [])
            lines.append(f"ladder plan: {' -> '.join(planned) or '-'}"
                         + (f"  (headroom {_fmt_bytes(a.get('headroom_bytes'))},"
                            f" rss {_fmt_bytes(a.get('rss_bytes'))},"
                            f" budget {_fmt_bytes(a.get('budget_bytes'))})"
                            if a.get("budget_bytes") is not None else
                            "  (unbudgeted: no rung priced out)"))
            for p in a.get("priced", []):
                verdict = p.get("verdict", "?")
                lines.append(
                    f"  {p.get('rung', '?'):<7} governor price "
                    f"{_fmt_bytes(p.get('est_bytes')):>8}"
                    + (f" (history x-> {_fmt_bytes(p['corrected_bytes'])}"
                       f" via {p.get('prior', '?')})"
                       if p.get("corrected_bytes") is not None else "")
                    + f" -> {verdict}")
            # planner decisions: surface the overridden /
            # history-corrected knobs — the full story is `sheep plan`
            for d in a.get("decisions", []):
                if d.get("provenance") in ("forced", "learned"):
                    lines.append(
                        f"  knob {d.get('name')} = {d.get('value')} "
                        f"[{d.get('provenance')}]"
                        + (f" (analytic said {d['analytic']})"
                           if d.get("analytic") is not None else ""))
        elif name == "rung.degrade":
            lines.append(f"degrade: {a.get('rung')} -> {a.get('next')} "
                         f"({a.get('why', '?')})")
        elif name == "rung.resume":
            lines.append(f"resume: rung {a.get('rung')} at boundary "
                         f"{a.get('boundary')} ({a.get('rounds')} rounds in)")
        elif name == "rung.ok":
            rung = a.get("rung", "?")
            sp = rung_spans.get(rung, {})
            lines.append(
                f"ran: rung '{rung}' in "
                f"{_fmt_s(float(sp.get('dur', a.get('wall_s', 0.0) or 0.0)))}"
                f" (measured rss {_fmt_bytes(a.get('rss_bytes'))}"
                + (f", priced {_fmt_bytes(a.get('est_bytes'))}"
                   if a.get("est_bytes") is not None else "") + ")")
    if not lines and rung_spans:
        for rung, sp in rung_spans.items():
            lines.append(f"ran: rung '{rung}' in "
                         f"{_fmt_s(float(sp.get('dur', 0.0)))}")
    return lines


def timeline_rows(records: list[dict], max_rows: int = DEFAULT_ROWS):
    """(depth, name, t, dur, attrs) per span in start order, nesting from
    the id/par links (spans land at exit, so file order is exit order)."""
    spans = [r for r in records if r.get("k") == "span"]
    spans.sort(key=lambda r: float(r.get("t", 0.0)))
    depth_of: dict = {}
    rows = []
    for r in spans:
        par = r.get("par")
        depth = depth_of.get(par, -1) + 1 if par is not None else 0
        depth_of[r.get("id")] = depth
        rows.append((depth, r.get("name", "?"), float(r.get("t", 0.0)),
                     float(r.get("dur", 0.0)), r.get("a", {})))
    elided = max(0, len(rows) - max_rows)
    if elided:
        # keep the longest spans plus every top-level one, in time order
        keep = sorted(rows, key=lambda x: (-(x[0] == 0), -x[3]))[:max_rows]
        rows = sorted(keep, key=lambda x: x[2])
    return rows, elided


def render(records: list[dict], torn: bool, path: str,
           max_rows: int = DEFAULT_ROWS) -> str:
    wall = wall_seconds(records)
    roll = rollup(records)
    events = roll.pop("_events", {})
    lines = [f"trace: {path}"
             + ("  [TORN TAIL: partial trace from a killed run]"
                if torn else ""),
             f"wall: {_fmt_s(wall)}   spans: "
             f"{sum(p['count'] for p in roll.values())}   events: "
             f"{sum(events.values())}", ""]

    head = f"{'PHASE':<28} {'COUNT':>6} {'TOTAL':>9} {'MAX':>9} {'%WALL':>6}"
    lines += ["phase rollup", head, "-" * len(head)]
    for name, p in sorted(roll.items(), key=lambda kv: -kv[1]["total_s"]):
        pct = 100.0 * p["total_s"] / wall if wall > 0 else 0.0
        lines.append(f"{name:<28} {p['count']:>6} "
                     f"{_fmt_s(p['total_s']):>9} {_fmt_s(p['max_s']):>9} "
                     f"{pct:>5.1f}%")
    # reconciliation: top-level span coverage of the wall (the acceptance
    # check — phase sums must explain the clock, not hand-wave at it)
    top = [r for r in records
           if r.get("k") == "span" and r.get("par") is None]
    top_sum = sum(float(r.get("dur", 0.0)) for r in top)
    if wall > 0:
        lines.append(f"{'':<28} top-level spans cover "
                     f"{100.0 * min(top_sum, wall) / wall:.1f}% of wall")

    expl = ladder_explanation(records)
    if expl:
        lines += ["", "ladder decisions"] + ["  " + e for e in expl]
    if events:
        lines += ["", "events: " + "  ".join(
            f"{k}={v}" for k, v in sorted(events.items()))]

    rows, elided = timeline_rows(records, max_rows)
    if rows:
        lines += ["", "timeline"]
        for depth, name, t, dur, attrs in rows:
            bar = "#" * max(1, min(30, int(30 * dur / wall))) \
                if wall > 0 else "#"
            extra = " ".join(f"{k}={v}" for k, v in list(attrs.items())[:3])
            lines.append(f"  {t:>9.4f}s {'  ' * depth}{name:<24} "
                         f"{_fmt_s(dur):>9}  {bar}"
                         + (f"  [{extra}]" if extra else ""))
        if elided:
            lines.append(f"  ... {elided} shorter span(s) elided "
                         f"(rollup above counts them)")
    return "\n".join(lines) + "\n"


def summary_json(records: list[dict], torn: bool, path: str) -> dict:
    roll = rollup(records)
    events = roll.pop("_events", {})
    wall = wall_seconds(records)
    top = [r for r in records
           if r.get("k") == "span" and r.get("par") is None]
    return {
        "path": path,
        "torn": torn,
        "wall_s": round(wall, 6),
        "phases": roll,
        "events": events,
        "top_level_span_s": round(
            sum(float(r.get("dur", 0.0)) for r in top), 6),
        "ladder": ladder_explanation(records),
    }


def merge_main(args: list[str], mode: str, as_json: bool,
               only_rid: str | None, max_rids: int) -> int:
    """The ``--merge`` mode: stitch many processes' traces by rid."""
    from ..obs.merge import (collect_trace_paths, estimate_offsets,
                             load_sources, merge_by_rid, merged_json,
                             render_merged)
    paths = collect_trace_paths(args)
    if not paths:
        print(f"trace: no .trace files under {' '.join(args)!r}",
              file=sys.stderr)
        return 1
    import warnings
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # tears show in the render
            sources = load_sources(paths, mode)
    except (IntegrityError, OSError) as exc:
        print(f"trace: {exc}", file=sys.stderr)
        return 1
    estimate_offsets(sources)
    rids = merge_by_rid(sources)
    if only_rid is not None and only_rid not in rids:
        print(f"trace: rid {only_rid!r} appears in none of "
              f"{len(paths)} file(s)", file=sys.stderr)
        return 1
    if as_json:
        json.dump(merged_json(sources, rids, only_rid), sys.stdout,
                  indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_merged(sources, rids, only_rid,
                                       max_rids))
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "m:n:",
                                       ["json", "merge", "rid="])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2
    mode = "repair"  # a killed run's torn tail is the expected customer
    as_json = False
    max_rows = DEFAULT_ROWS
    merge = False
    only_rid = None
    for o, a in opts:
        if o == "-m":
            if a not in POLICIES:
                print(f"trace: -m {a!r} must be one of "
                      f"{'/'.join(POLICIES)}")
                return 2
            mode = a
        elif o == "--json":
            as_json = True
        elif o == "--merge":
            merge = True
        elif o == "--rid":
            only_rid = a
        elif o == "-n":
            max_rows = int(a)
    if merge:
        if not args:
            print(USAGE)
            return 2
        return merge_main(args, mode, as_json, only_rid,
                          max_rows if max_rows != DEFAULT_ROWS else 20)
    if len(args) != 1:
        print(USAGE)
        return 2
    path = args[0]
    import warnings
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the tear shows in the render
            records, _, torn = read_trace(path, mode)
    except (IntegrityError, OSError) as exc:
        print(f"trace: {exc}", file=sys.stderr)
        return 1
    if as_json:
        json.dump(summary_json(records, torn, path), sys.stdout,
                  indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render(records, torn, path, max_rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
