"""One run of one cell: set-up, the measured window, the metrics, the
check against the reference.

Set-up makes the cell's graph on the device from the seed, copies it to
host memory, prepares the traffic's entry and runs one warm-up build of
the cell's own shapes; the first run in a checkout also builds the
program's native libraries there.  The window is a closed loop with one
caller: whole builds back to back until ``seconds`` have passed, the
build in flight finishing and counting.  Once it has closed, the
metrics are read, the program's state is freed, and every build's
answer is compared with the reference's, which works them out again
from the same records.  The window keeps each distinct answer once
(builds of one graph give equal arrays), so the answers it holds do not
grow with the builds.  Beside each build's time the run prints what the
host did meanwhile: the process's CPU seconds and its resident memory.
A build that burns more CPU seconds for the same work ran on slower
cores; one that burns fewer than its wall time waited.
"""

from __future__ import annotations

import contextlib
import gc
import os
import resource
import subprocess
import sys
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check
from .graph import Graph, make_graph
from .spec import Cell, Spec
from .trace import (BUILD_SPAN, K1_KERNEL, HostSampler, K1Recorder, Timeline,
                    reduce_events)

#: top-level module names that no run may load (compared whole: the
#: program's own name, sheep_tpu_torch, begins with the last of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "sheep_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class Build:
    start: float
    end: float
    peak_bytes: int | None
    perf: dict | None
    host: dict | None = None


def host_counters() -> dict:
    """The process's CPU seconds and, where the host gives it, its
    resident bytes."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    got = {"cpu_s": ru.ru_utime + ru.ru_stime}
    try:
        with open("/proc/self/statm") as fh:
            got["rss"] = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    return got


def _host_delta(before: dict, after: dict) -> dict:
    """The CPU seconds between two readings, and the resident bytes at
    the second."""
    got = {"cpu_s": after["cpu_s"] - before["cpu_s"]}
    if "rss" in after:
        got["rss"] = after["rss"]
    return got


@dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``)."""

    cell: Cell
    graph: Graph
    setup_s: float
    builds: list = field(default_factory=list)
    failed: int = 0
    #: each distinct answer of the window's builds, once
    outputs: list = field(default_factory=list)
    timeline: Timeline | None = None
    k1: K1Recorder | None = None

    @property
    def records(self) -> int:
        return self.graph.records

    def keep(self, out: dict) -> None:
        """Keeps ``out`` unless an equal answer is kept already."""
        for kept in self.outputs:
            if kept.keys() == out.keys() and all(
                    np.array_equal(kept[k], out[k]) for k in out):
                return
        self.outputs.append(out)

    def perf_mean(self, key: str):
        """A program timer's mean over the traced builds, or None."""
        vals = [b.perf[key] for b in self.builds
                if b.perf is not None and key in b.perf]
        return sum(vals) / len(vals) if vals else None

    def k1_device_s(self) -> float:
        """K1's device seconds in the traced builds: its kernels in the
        profiler's trace."""
        if self.timeline is None:
            return 0.0
        return sum(s for name, s in self.timeline.device_ops.items()
                   if K1_KERNEL in name)


class _Window:
    def __init__(self, device, trace: bool):
        self.cuda = device.type == "cuda"
        self.trace = trace
        self.k1 = None
        self.prof = None
        self.sampler = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                self.k1 = self._stack.enter_context(K1Recorder())
                acts.append(ProfilerActivity.CUDA)
            self.prof = self._stack.enter_context(profile(activities=acts))
            self.sampler = self._stack.enter_context(HostSampler())
        return self

    def __exit__(self, *exc):
        with warnings.catch_warnings():  # the profiler's notes on cycles
            warnings.simplefilter("ignore", UserWarning)
            self._stack.close()
        return False

    def span(self):
        if self.trace:
            from torch.profiler import record_function
            return record_function(BUILD_SPAN)
        return contextlib.nullcontext()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(entry, seconds: float, device, trace: bool, run: Run) -> None:
    cuda = device.type == "cuda"
    with _Window(device, trace) as win:
        deadline = time.perf_counter() + seconds
        while True:
            perf = {} if trace else None
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            host = host_counters()
            start = time.perf_counter()
            try:
                with win.span():
                    out = entry.build(perf)
            except Exception as exc:  # a failed build is a wrong answer
                print(f"build failed: {type(exc).__name__}: {exc}",
                      file=sys.stderr)
                run.failed += 1
                out = None
            end = time.perf_counter()
            peak = torch.cuda.max_memory_allocated(device) if cuda else None
            if out is not None:
                run.builds.append(Build(start, end, peak, perf,
                                        _host_delta(host, host_counters())))
                run.keep(out)
            if end >= deadline:
                break
    run.k1 = win.k1
    if win.prof is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            events = win.prof.events()
        run.timeline = reduce_events(events, [b.start for b in run.builds],
                                     win.sampler)


def _read(spec: Spec, metrics: list, run: Run) -> dict:
    got = {}
    for m in metrics:
        value = spec.reader(m["name"])(run)
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def device_info(device, run: Run) -> dict:
    peaks = [b.peak_bytes for b in run.builds if b.peak_bytes is not None]
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": max(peaks) if peaks else 0}
    if run.timeline is not None:
        info["busy_s"] = run.timeline.busy_s
        info["window_s"] = run.timeline.window_s
    if device.type == "cuda":
        info["power_limit"] = power_limit()
    return info


def power_limit() -> str:
    """The card's power limit as nvidia-smi gives it (a share of a peak
    is stated beside it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({type(exc).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_process: float,
             entry_hook=None) -> tuple[dict, list]:
    """One run.  Returns (the result object, the check's lines).
    ``entry_hook(entry)`` may put something in the entry's place (the
    tests' faults, the control)."""
    cell = spec.cell(cell_name)
    kind = spec.entry(cell.traffic["entry"])
    graph = make_graph(cell.config["graph"], seed, device)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    entry = kind.make(graph, cell.traffic, device)
    if entry_hook is not None:
        entry = entry_hook(entry)
    entry.build(None)  # warm-up: the cell's own shapes
    _sync(device)
    run = Run(cell, graph, time.perf_counter() - t_process)
    run_window(entry, seconds, device, trace, run)
    metrics = _read(spec, cell.per_layer if trace else cell.end_to_end, run)
    info = device_info(device, run)
    breakdown = None
    if run.timeline is not None:
        breakdown = {"device_ops": run.timeline.top_ops(),
                     "idle_gaps": run.timeline.top_gaps()}
    # the program's state goes before the reference runs on the device
    del entry
    run.k1 = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = kind.expected(graph, cell.traffic, device)
    numbers = check.compare(run.outputs, run.failed, want, kind.LIMITS)
    check_s = time.perf_counter() - t0
    result = {"correct": check.passes(numbers, len(run.builds)),
              "attempted": len(run.builds) + run.failed,
              "failed": run.failed,
              "metrics": metrics,
              "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    lines = [f"build seconds: "
             f"{[round(b.end - b.start, 3) for b in run.builds]}",
             *host_lines(run.builds),
             *([f"vertices of nonzero degree (the reference's sequence): "
                f"{len(want['seq'])} of {graph.vid_slots} vid slots"]
               if "seq" in want else []),
             f"reference and comparison took {check_s:.3f} s over "
             f"{len(run.builds)} builds ({len(run.outputs)} distinct "
             f"answers)"]
    lines += [f"check {k}: {v} (limit {lim})" for k, (v, lim)
              in numbers.items()]
    return result, lines


def host_lines(builds: list) -> list:
    """What the host did during each build, one line a counter."""
    got = []
    for key, what, scale, digits in (
            ("cpu_s", "process CPU seconds per build", 1, 2),
            ("rss", "resident GiB after each build", 2**-30, 3)):
        vals = [round(b.host[key] * scale, digits) for b in builds
                if b.host and key in b.host]
        if vals:
            got.append(f"{what}: {vals}")
    return got


def cache_dirs(root: str) -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(root, ".portbench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}
