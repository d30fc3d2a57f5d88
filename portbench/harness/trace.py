"""The traced run: ``torch.profiler`` over the window's builds, a
recorder of kernel K1's descents, and a sampler of what the host runs.

Each build runs inside a ``portbench.build`` span.  From the profiler's
device events (kernels, copies, sets) the reduction takes, within those
spans, the seconds in which the device ran anything, the idle gaps
between, and the device time by operation.  The recorder wraps the
program's descent seam (``ops.forest._lift_descend``) while it is
entered, as ``chip_smoke.K1Recorder`` does: each descent's links, table
levels and width.  The sampler
reads, every few milliseconds, the innermost function of the program
that each of the process's threads is in; an idle gap is labelled by
what the samples inside it say most often.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from dataclasses import dataclass, field

import torch

BUILD_SPAN = "portbench.build"
K1_KERNEL = "fused_jump_kernel"


class K1Recorder:
    """Every K1 descent made on the card while entered: ``descents``
    holds (links, levels, width) per descent."""

    def __init__(self):
        self.descents: list = []

    def __enter__(self):
        from sheep_tpu_torch.ops import forest

        self._saved = descend = forest._lift_descend

        def recorded_descend(lo, hi, n, levels, f, sorted_links=False):
            if lo.device.type == "cuda":
                self.descents.append((int(lo.shape[0]), max(1, levels),
                                      int(f.shape[0])))
            return descend(lo, hi, n, levels, f, sorted_links)

        forest._lift_descend = recorded_descend
        return self

    def __exit__(self, *exc):
        from sheep_tpu_torch.ops import forest

        forest._lift_descend = self._saved
        return False


PROGRAM_DIR = os.sep + "sheep_tpu_torch" + os.sep


def _program_frame(frame) -> str | None:
    """``module/file.py:function`` of the innermost program frame."""
    while frame is not None:
        path = frame.f_code.co_filename
        at = path.rfind(PROGRAM_DIR)
        if at >= 0:
            return f"{path[at + len(PROGRAM_DIR):]}:{frame.f_code.co_name}"
        frame = frame.f_back
    return None


class HostSampler:
    """Samples (perf_counter time, what the threads run) every
    ``period`` seconds on a thread of its own while entered."""

    def __init__(self, period: float = 0.01):
        self.period = period
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.period):
            doing = {_program_frame(f) for tid, f in
                     sys._current_frames().items() if tid != me}
            doing.discard(None)
            self.samples.append((time.perf_counter(),
                                 " + ".join(sorted(doing))))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False

    def label(self, start: float, end: float) -> str:
        """What the samples in [start, end] (perf_counter) say most."""
        said = collections.Counter(d for t, d in self.samples
                                   if start <= t <= end)
        if not said:
            return "not sampled"
        return said.most_common(1)[0][0] or "outside the program"


@dataclass
class Timeline:
    """The reduced trace.  Times in seconds."""

    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: dict = field(default_factory=dict)  # name -> seconds
    gaps: list = field(default_factory=list)  # (seconds, label)

    def top_ops(self, k: int = 10) -> list:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:k]
        return [[name, secs] for name, secs in ops]

    def top_gaps(self, k: int = 10) -> list:
        return [[label, secs] for secs, label in
                sorted(self.gaps, key=lambda g: -g[0])[:k]]


def _short(name: str, width: int = 96) -> str:
    name = " ".join(name.split())
    return name if len(name) <= width else name[:width - 3] + "..."


def _merge(intervals: list) -> list:
    out: list = []
    for s, e, name in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
                out[-1][3] = name
        else:
            out.append([s, e, name, name])  # start, end, first, last op
    return out


def reduce_events(events, build_starts: list | None = None,
                  sampler: HostSampler | None = None) -> Timeline:
    """A Timeline from profiler events (``prof.events()``): the build
    spans' total length, the device's busy time inside them, its device
    time by operation name, and each idle gap labelled by the device
    operations around it and by what the host ran through it
    (``sampler``; ``build_starts``, the builds' perf_counter starts, put
    the profiler's clock on the sampler's)."""
    spans, device = [], []
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.name == BUILD_SPAN:
            # the span also shows as an annotation on the device's rows
            if ev.device_type == torch.autograd.DeviceType.CPU:
                spans.append((s, e))
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            device.append((s, e, ev.name))
    spans.sort()
    offset = None
    if spans and build_starts:
        offset = spans[0][0] / 1e6 - build_starts[0]
    tl = Timeline()
    for s, e, name in device:
        tl.device_ops[_short(name)] = tl.device_ops.get(_short(name), 0.0) \
            + (e - s) / 1e6
    for s0, e0 in spans:
        tl.window_s += (e0 - s0) / 1e6
        inside = [(max(s, s0), min(e, e0), n) for s, e, n in device
                  if e > s0 and s < e0]
        merged = _merge(inside)
        tl.busy_s += sum(e - s for s, e, _, _ in merged) / 1e6
        prev_end, prev_name = s0, "build start"
        for s, e, first, last in merged + [[e0, e0, "build end", None]]:
            if s > prev_end:
                host = "not sampled"
                if sampler is not None and offset is not None:
                    host = sampler.label(prev_end / 1e6 - offset,
                                         s / 1e6 - offset)
                tl.gaps.append(((s - prev_end) / 1e6, _short(
                    f"{host} | {_short(prev_name, 40)} -> "
                    f"{_short(first, 40)}", 200)))
            prev_end, prev_name = max(prev_end, e), last
    return tl
