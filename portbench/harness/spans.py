"""The program's spans against the profiler's device events: each layer's
device seconds, the device's idle time that no layer explains, and the
idle gaps labelled by the layer spans open through them.

The program keeps its spans in memory inside ``obs.trace.capture()``,
and while ``torch.profiler`` records, each span on the thread that
entered the profiler also opens ``record_function(<span name>)``.  A
device event (kernel, copy, set) correlates to the runtime call that
launched it (same id), and the call names its thread
(``device_resource_id``).  A call on the thread that entered the
profiler sits inside the profiler's ranges of the spans open there and
belongs to each of them.  The profiler records no range on another
thread (on one H100, torch 2.11: the prefetch and fetch threads' spans
never reach it), and nests that thread's calls under the first thread's
ranges by time alone; so a call on another thread belongs to the
innermost captured span of that thread open at its time, with that
span's parents, put on the profiler's clock by the offset of the
builds' starts (the harness's sampler uses the same).  A span's device
seconds include those of its nested spans.

The ranges also show as annotations on the device's rows; they are
not device work, and :func:`device_only` drops them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .trace import BUILD_SPAN

#: each layer metric's spans (disjoint: a device event counts once a
#: layer however many of its spans hold it)
LAYER_DEVICE = {
    "prep_device_s": ("build.prep",),
    "loop_device_s": ("build.loop", "stream.loop"),
    "handoff_device_s": ("handoff.sort", "handoff.slice"),
    "block_links_device_s": ("stream.links",),
}

#: the spans at the build path's layer boundaries: idle time with none
#: of them open on any thread is unexplained (``forest.k1`` is a kernel,
#: not a layer, and lies inside ``build.loop`` or ``stream.loop``)
LAYER_SPANS = frozenset({
    "build.prep", "build.prefetch", "build.prefetch.seq",
    "build.prefetch.pst", "build.loop", "handoff.tail", "handoff.sort",
    "handoff.pst_wait", "handoff.slice", "handoff.unpack", "handoff.fold",
    "stream.pad", "stream.upload", "stream.links", "stream.loop",
})

#: how many of the longest idle gaps are labelled
GAPS = 10

_LOW32 = 0xFFFFFFFF

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _is_runtime(ev) -> bool:
    """A CUDA runtime or driver call on the host (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...)."""
    return ev.device_type == CPU and ev.name.startswith("cu")


def device_only(events, names) -> list:
    """``events`` less the program's ranges on the device's rows (user
    annotations, or events named as a program span)."""
    return [ev for ev in events
            if not (ev.device_type == CUDA
                    and (getattr(ev, "is_user_annotation", False)
                         or ev.name in names))]


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


@dataclass
class SpanReading:
    """What one traced window reads.  Seconds are totals over its
    builds; ``builds`` divides them into per-build means."""

    builds: int = 0
    busy_s: float = 0.0
    idle_s: float = 0.0
    idle_unattributed_s: float = 0.0
    #: device seconds by span name (nested spans' included)
    span_device_s: dict = field(default_factory=dict)
    #: device seconds by layer metric (:data:`LAYER_DEVICE`)
    layer_device_s: dict = field(default_factory=dict)
    #: device seconds launched inside no program span, and by why
    unattributed_device_s: float = 0.0
    unattributed_why: dict = field(default_factory=dict)
    #: host seconds by span name, of the spans that began in a build
    span_host_s: dict = field(default_factory=dict)
    #: span names that reached the profiler as ranges, and the others
    profiled: set = field(default_factory=set)
    not_profiled: set = field(default_factory=set)
    #: (seconds, label) of the :data:`GAPS` longest idle gaps
    gaps: list = field(default_factory=list)
    #: the idle pieces in which no layer span was open, and the
    #: profiler's clock less ``perf_counter``'s, in seconds
    unexplained: list = field(default_factory=list)
    offset: float = 0.0

    def per_build(self, seconds: float) -> float | None:
        return seconds / self.builds if self.builds else None

    def idle_unattributed_pct(self) -> float | None:
        if self.idle_s <= 0:
            return None
        return 100.0 * self.idle_unattributed_s / self.idle_s

    def top_gaps(self) -> list:
        return [[label, secs] for secs, label in self.gaps]


def read_spans(events, spans, build_starts, main_tid: int,
               main_native: int) -> SpanReading:
    """Reduce the profiler's ``events`` (``prof.events()``) and the
    captured ``spans`` (``obs.trace.CapturedSpan``) of one window.
    ``build_starts``: the builds' ``perf_counter`` starts; ``main_tid``
    and ``main_native``: ``threading.get_ident()`` and
    ``get_native_id()`` of the thread that entered the profiler."""
    names = {sp.name for sp in spans}
    rd = SpanReading(builds=len(build_starts))
    builds = sorted((ev.time_range.start / 1e6, ev.time_range.end / 1e6)
                    for ev in events
                    if ev.name == BUILD_SPAN and ev.device_type == CPU)
    if not builds or not build_starts:
        return rd
    rd.offset = offset = builds[0][0] - min(build_starts)

    def in_build(t: float) -> bool:
        return any(s0 <= t <= e0 for s0, e0 in builds)

    # captured spans on the profiler's clock, kept where they overlap a build
    mapped = [(sp, sp.start + offset, sp.end + offset) for sp in spans]
    mapped = [m for m in mapped
              if any(_overlap(m[1], m[2], s0, e0) > 0 for s0, e0 in builds)]
    by_id = {sp.id: sp for sp in spans}
    for sp, s, _ in mapped:
        if in_build(s):
            rd.span_host_s[sp.name] = rd.span_host_s.get(sp.name, 0.0) \
                + sp.dur
    rd.profiled = {ev.name for ev in events
                   if ev.device_type == CPU and ev.name in names}
    rd.not_profiled = names - rd.profiled

    # the launching thread of a runtime call: the profiler names a
    # thread it knows (the one that entered it) by its native id, another
    # by the low 32 bits of its ident, as a signed int
    threads = {main_native: main_tid, main_tid & _LOW32: main_tid}
    off_main: dict = {}
    for sp, s, e in mapped:
        if sp.tid != main_tid:
            threads.setdefault(sp.native, sp.tid)
            threads.setdefault(sp.tid & _LOW32, sp.tid)
            off_main.setdefault(sp.tid, []).append((sp, s, e))

    def owners(call) -> tuple:
        """The span names holding ``call``, or why none does."""
        rid = getattr(call, "device_resource_id", None)
        tid = threads.get(rid & _LOW32) if isinstance(rid, int) else None
        got: set = set()
        if tid == main_tid:
            parent = call.cpu_parent
            while parent is not None:
                if parent.name in names:
                    got.add(parent.name)
                parent = parent.cpu_parent
            return got, "launched on the profiling thread in no span"
        if tid is None:
            return got, f"launched on thread {rid}, which has no span"
        t = call.time_range.start / 1e6
        open_ = [(e - s, sp) for sp, s, e in off_main[tid] if s <= t <= e]
        sp = min(open_, key=lambda x: x[0])[1] if open_ else None
        while sp is not None:
            got.add(sp.name)
            sp = by_id.get(sp.par)
        return got, "launched on another thread between its spans"

    runtime = {ev.id: ev for ev in events if _is_runtime(ev)}
    busy = []
    for ev in device_only(events, names):
        if ev.device_type != CUDA:
            continue
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if not in_build(s):
            continue
        busy.append((s, e))
        secs = e - s
        call = runtime.get(ev.id)
        held, why = owners(call) if call is not None \
            else (set(), "no launching call")
        if not held:
            rd.unattributed_device_s += secs
            rd.unattributed_why[why] = rd.unattributed_why.get(why, 0.0) \
                + secs
        for name in held:
            rd.span_device_s[name] = rd.span_device_s.get(name, 0.0) + secs
        for metric, layer in LAYER_DEVICE.items():
            if held.intersection(layer):
                rd.layer_device_s[metric] = \
                    rd.layer_device_s.get(metric, 0.0) + secs

    layer_spans = [(sp, s, e) for sp, s, e in mapped
                   if sp.name in LAYER_SPANS]
    idle = []
    for s0, e0 in builds:
        inside = _merge([(max(s, s0), min(e, e0)) for s, e in busy
                         if e > s0 and s < e0])
        rd.busy_s += sum(e - s for s, e in inside)
        edges = [s0] + [x for iv in inside for x in iv] + [e0]
        idle += [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    rd.idle_s = sum(b - a for a, b in idle)
    rd.unexplained = _uncovered(
        idle, _merge([(s, e) for _, s, e in layer_spans]))
    rd.idle_unattributed_s = sum(b - a for a, b in rd.unexplained)
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:GAPS]
    rd.gaps = [(b - a, _gap_label(layer_spans, a, b)) for a, b in longest]
    return rd


def _uncovered(intervals: list, cover: list) -> list:
    """The pieces of sorted disjoint ``intervals`` that sorted disjoint
    ``cover`` leaves out."""
    got, j = [], 0
    for a, b in intervals:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while a < b:
            if k == len(cover) or cover[k][0] >= b:
                got.append((a, b))
                break
            if cover[k][0] > a:
                got.append((a, cover[k][0]))
            a = max(a, cover[k][1])
            k += 1
    return got


def _gap_label(layer_spans: list, a: float, b: float) -> str:
    """The innermost layer span open through [a, b] on each thread: of
    the spans covering at least half as much of it as the widest does,
    the shortest."""
    per_thread: dict = {}
    for sp, s, e in layer_spans:
        ov = _overlap(a, b, s, e)
        if ov > 0:
            per_thread.setdefault(sp.tid, []).append((ov, e - s, sp.name))
    labels = set()
    for got in per_thread.values():
        widest = max(ov for ov, _, _ in got)
        labels.add(min((d, name) for ov, d, name in got
                       if ov >= widest / 2)[1])
    return " + ".join(sorted(labels)) or "no layer span"
