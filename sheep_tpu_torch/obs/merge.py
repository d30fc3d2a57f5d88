"""Merged fleet timelines: stitch N processes' traces by rid.

A routed request crosses 3+ processes (router -> leader -> follower WAL
fsync) and leaves one ``.trace`` file per process.  Each file's spans
carry the request's ``rid`` (obs/trace.py :func:`~sheep_tpu_torch.obs.trace.
rid_scope`), so the rid is the join key — but each file's timestamps are
offsets on its OWN monotonic clock.  Merging needs a per-file clock
offset, and this module estimates it two ways, honestly labeled:

  wall    every meta line records the wall clock at recorder open
          (``t0``), so ``t0 + t`` is a wall-clock estimate.  Wall clocks
          on one host agree to well under a millisecond, but across
          hosts (or under NTP steps) the error is unbounded — the method
          is recorded and the bound reported as unknown.
  rid     when two files share rids, causality bounds the offset: the
          requesting side's span CONTAINS the serving side's work in
          real time, so each shared rid yields an interval the offset
          must lie in; intersecting them gives a midpoint estimate AND
          an honest ``±bound`` (half the surviving interval's width).
          This is the per-connection handshake estimate: every routed
          request is a handshake sample.

The flagship rendering is the failover story: router retry, the dead
leader's final spans, the promoted leader's first fsync — one rid, one
tree, three files.  ``sheep trace --merge`` (cli/trace.py) is the CLI.
"""

from __future__ import annotations

import glob as _glob
import os

from .trace import TRACE_SUFFIX, read_trace


class TraceSource:
    """One trace file, read and wall-aligned: records with ``_abs``
    (meta-t0 + t) stamped, plus the offset correction the estimator
    fills in (seconds to ADD to ``_abs`` to land on the reference
    clock)."""

    __slots__ = ("path", "label", "records", "offset", "bound", "method")

    def __init__(self, path: str, label: str, records: list[dict]):
        self.path = path
        self.label = label
        self.records = records
        self.offset = 0.0
        self.bound: float | None = None
        self.method = "wall"

    def rid_spans(self) -> dict[str, list[dict]]:
        out: dict[str, list[dict]] = {}
        for r in self.records:
            rid = r.get("rid")
            if rid is not None and r.get("k") == "span":
                out.setdefault(rid, []).append(r)
        return out


def collect_trace_paths(specs) -> list[str]:
    """Dirs (walked for ``*.trace`` incl. rotated segments), globs, and
    literal files -> a deduped path list."""
    out: list[str] = []
    for spec in specs:
        if os.path.isdir(spec):
            for dirpath, _, names in os.walk(spec):
                for nm in sorted(names):
                    if nm.endswith(TRACE_SUFFIX):
                        out.append(os.path.join(dirpath, nm))
        elif os.path.isfile(spec):
            out.append(spec)
        else:
            out.extend(sorted(_glob.glob(spec)))
    seen: set = set()
    res = []
    for p in out:
        ap = os.path.abspath(p)
        if ap not in seen:
            seen.add(ap)
            res.append(p)
    return res


def _short_labels(paths: list[str]) -> list[str]:
    """Distinct short labels: basename minus .trace, parent-dir
    qualified on collision."""
    bases = []
    for p in paths:
        b = os.path.basename(p)
        if b.endswith(TRACE_SUFFIX):
            b = b[:-len(TRACE_SUFFIX)]
        bases.append(b)
    labels = []
    for p, b in zip(paths, bases):
        if bases.count(b) > 1:
            b = os.path.basename(os.path.dirname(os.path.abspath(p))) \
                + "/" + b
        labels.append(b)
    return labels


def load_sources(paths: list[str],
                 mode: str = "repair") -> list["TraceSource"]:
    """Read every file (repair mode by default: merged timelines exist
    to read the wreckage of killed runs) and wall-align its records:
    each record gets ``_abs`` = its governing meta segment's wall t0
    plus its monotonic offset."""
    sources = []
    for path, label in zip(paths, _short_labels(paths)):
        records, _, _ = read_trace(path, mode)
        cur_t0 = 0.0
        out = []
        for r in records:
            k = r.get("k")
            if k == "meta":
                cur_t0 = float(r.get("t0", 0.0))
            elif k in ("span", "ev"):
                rr = dict(r)
                rr["_abs"] = cur_t0 + float(r.get("t", 0.0))
                out.append(rr)
        sources.append(TraceSource(path, label, out))
    return sources


def _span_window(spans: list[dict]) -> tuple[float, float]:
    """The [start, end] envelope of one file's spans for one rid."""
    starts = [s["_abs"] for s in spans]
    ends = [s["_abs"] + float(s.get("dur", 0.0)) for s in spans]
    return min(starts), max(ends)


def estimate_offsets(sources: list["TraceSource"]) -> None:
    """Fill each source's (offset, bound, method) relative to the
    reference — the file with the most rid-bearing spans (the router,
    in a fleet).  For every file sharing rids with the reference, each
    shared rid's containment (the longer side's span envelope brackets
    the shorter's in real time) yields an offset interval; their
    intersection gives the estimate and the honest ±bound.  Files with
    no shared rid (or an empty intersection — clocks too strange to
    bracket) stay wall-aligned with bound None."""
    if not sources:
        return

    def _ref_key(s: "TraceSource"):
        spans = s.rid_spans()
        total_dur = sum(float(sp.get("dur", 0.0))
                        for recs in spans.values() for sp in recs)
        # most distinct rids wins; ties break toward the longest total
        # rid-span duration (the CONTAINING side — the router's spans
        # bracket everyone else's, making it the natural reference)
        return (len(spans), total_dur)

    ref = max(sources, key=_ref_key)
    ref.offset, ref.bound, ref.method = 0.0, 0.0, "reference"
    ref_rids = ref.rid_spans()
    for src in sources:
        if src is ref:
            continue
        lo, hi = float("-inf"), float("inf")
        paired = 0
        mine = src.rid_spans()
        for rid, spans in mine.items():
            other = ref_rids.get(rid)
            if not other:
                continue
            a0, a1 = _span_window(other)   # reference side
            b0, b1 = _span_window(spans)   # this file's side
            # correction c satisfies containment of the shorter window
            # inside the longer: c in [a0-b0, a1-b1] (sorted — either
            # side may be the container)
            c0, c1 = a0 - b0, a1 - b1
            if c0 > c1:
                c0, c1 = c1, c0
            lo, hi = max(lo, c0), min(hi, c1)
            paired += 1
        if paired and lo <= hi:
            src.offset = (lo + hi) / 2
            src.bound = (hi - lo) / 2
            src.method = f"rid({paired})"
        # else: wall alignment stands, bound honestly unknown (None)


def merge_by_rid(sources: list["TraceSource"]) -> dict[str, list[dict]]:
    """rid -> time-ordered records across every source, each stamped
    with ``_src`` (the source label) and ``_t`` (reference-clock
    seconds)."""
    rids: dict[str, list[dict]] = {}
    for s in sources:
        for r in s.records:
            rid = r.get("rid")
            if rid is None:
                continue
            rr = dict(r)
            rr["_src"] = s.label
            rr["_t"] = r["_abs"] + s.offset
            rids.setdefault(rid, []).append(rr)
    for recs in rids.values():
        recs.sort(key=lambda r: r["_t"])
    return rids


def _fmt_s(s: float) -> str:
    if s >= 1:
        return f"{s:.3f}s"
    return f"{s * 1000:.2f}ms"


def _fmt_off(s: float) -> str:
    return f"{'+' if s >= 0 else ''}{s * 1000:.3f}ms"


def render_merged(sources: list["TraceSource"],
                  rids: dict[str, list[dict]],
                  only_rid: str | None = None,
                  max_rids: int = 20) -> str:
    lines = [f"merged timeline: {len(sources)} file(s), "
             f"{len(rids)} rid(s)"]
    width = max((len(s.label) for s in sources), default=8)
    for s in sources:
        if s.method == "reference":
            tag = "reference clock"
        elif s.bound is not None:
            tag = (f"offset {_fmt_off(s.offset)} "
                   f"±{s.bound * 1000:.3f}ms ({s.method}-aligned)")
        else:
            tag = ("wall-clock aligned (no shared rid; "
                   "offset bound UNKNOWN)")
        lines.append(f"  {s.label:<{width}}  {tag}")
    lines.append("")
    show = [only_rid] if only_rid else \
        sorted(rids, key=lambda r: rids[r][0]["_t"])
    elided = max(0, len(show) - max_rids)
    for rid in show[:max_rids]:
        recs = rids.get(rid)
        if not recs:
            lines.append(f"rid {rid}: no records")
            continue
        t0 = recs[0]["_t"]
        srcs = sorted({r["_src"] for r in recs})
        lines.append(f"rid {rid}  ({len(recs)} record(s) across "
                     f"{'/'.join(srcs)})")
        for r in recs:
            rel = r["_t"] - t0
            name = r.get("name", "?")
            if r.get("k") == "span":
                tail = _fmt_s(float(r.get("dur", 0.0)))
            else:
                tail = "ev"
            extra = " ".join(f"{k}={v}" for k, v in
                             list(r.get("a", {}).items())[:4])
            lines.append(f"  {_fmt_off(rel):>12}  {r['_src']:<{width}} "
                         f"{name:<18} {tail:>9}"
                         + (f"  [{extra}]" if extra else ""))
        lines.append("")
    if elided:
        lines.append(f"... {elided} more rid(s) elided (-n raises the "
                     f"cap, --rid picks one)")
    return "\n".join(lines) + "\n"


def merged_json(sources: list["TraceSource"],
                rids: dict[str, list[dict]],
                only_rid: str | None = None) -> dict:
    out_rids = {}
    for rid, recs in rids.items():
        if only_rid and rid != only_rid:
            continue
        t0 = recs[0]["_t"]
        out_rids[rid] = [{
            "src": r["_src"],
            "k": r.get("k"),
            "name": r.get("name"),
            "t_s": round(r["_t"] - t0, 6),
            "dur_s": round(float(r.get("dur", 0.0)), 6)
            if r.get("k") == "span" else None,
            "a": r.get("a", {}),
        } for r in recs]
    return {
        "files": [{
            "path": s.path,
            "label": s.label,
            "offset_s": round(s.offset, 6),
            "offset_bound_s": round(s.bound, 6)
            if s.bound is not None else None,
            "method": s.method,
        } for s in sources],
        "rids": out_rids,
    }
