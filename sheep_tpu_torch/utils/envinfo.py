"""Environment capture for benchmark records (port of
sheep_tpu/utils/envinfo.py).

Every record that embeds this capture can be attributed from the
artifact alone: host load at measurement time, core count and the
process's actual affinity mask (thread pins), the cgroup cpu quota (a
container limited to 4 cpu-seconds/second reports every host core in
nproc/affinity, and the native fold's thread plan sizes itself off the
EFFECTIVE count), cpu model, thread-count env pins, the native
library's OpenMP view (when it is already loaded), and the CUDA card
(name, count) when torch has already initialised CUDA.

Deliberately import-light: a capture never initialises CUDA (the card is
reported only when something else already did), /proc and /sys reads
are best-effort, and any failure degrades to omitting the field, never
to raising.
"""

from __future__ import annotations

import math
import os
import sys


def cpu_quota_cores(root: str = "/sys/fs/cgroup") -> float | None:
    """The cgroup cpu quota as fractional cores, or None when unlimited
    or undetectable.  Reads v2 ``cpu.max`` ("<quota> <period>" in µs,
    "max" = unlimited) and falls back to v1 ``cpu/cpu.cfs_quota_us`` /
    ``cpu.cfs_period_us`` (-1 = unlimited)."""
    try:
        with open(os.path.join(root, "cpu.max")) as f:
            quota_s, period_s = (f.read().split() + ["100000"])[:2]
        if quota_s != "max":
            period = int(period_s)
            if period > 0:
                return int(quota_s) / period
            return None
        return None
    except (OSError, ValueError):
        pass
    try:
        with open(os.path.join(root, "cpu", "cpu.cfs_quota_us")) as f:
            quota = int(f.read().strip())
        if quota <= 0:  # -1 = unlimited
            return None
        with open(os.path.join(root, "cpu", "cpu.cfs_period_us")) as f:
            period = int(f.read().strip())
        return quota / period if period > 0 else None
    except (OSError, ValueError):
        return None


def effective_cores(root: str = "/sys/fs/cgroup") -> int:
    """Cores this process can actually burn concurrently: the minimum of
    the affinity mask (else nproc) and the cgroup quota, floor 1 — the
    governor's input for sizing thread counts and leg counts (a quota'd
    container that reports 16 affinity cores must not spawn 16 threads
    to time-share 4 cpu-seconds/second)."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    quota = cpu_quota_cores(root)
    if quota is not None:
        cores = min(cores, max(1, math.ceil(quota)))
    return max(1, cores)


def env_capture(platform: str | None = None) -> dict:
    """One dict of host/environment facts for embedding in a record."""
    rec: dict = {"nproc": os.cpu_count()}
    try:
        rec["loadavg_1m_5m_15m"] = [round(x, 2) for x in os.getloadavg()]
    except OSError:
        pass
    try:
        rec["affinity_cores"] = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        pass
    quota = cpu_quota_cores()
    if quota is not None:
        rec["cpu_quota_cores"] = round(quota, 2)
    rec["effective_cores"] = effective_cores()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    rec["cpu_model"] = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    pins = {k: v for k, v in os.environ.items()
            if k in ("OMP_NUM_THREADS", "TASKSET", "GOMP_CPU_AFFINITY",
                     "CUDA_VISIBLE_DEVICES", "SHEEP_NATIVE_THREADS",
                     "SHEEP_LEG_CORES")}
    if pins:
        rec["thread_env"] = pins
    # the native library's OpenMP view, only when something else already
    # paid for loading it (this capture never triggers a build)
    native = sys.modules.get("sheep_tpu_torch.native")
    if native is not None and getattr(native, "_lib", None) is not None:
        try:
            rec["omp_compiled"] = native.omp_compiled()
            rec["omp_max_threads"] = native.omp_max_threads()
        except Exception:
            pass
    if platform is not None:
        rec["backend"] = platform
    else:
        torch = sys.modules.get("torch")
        # never initialise CUDA just to report it
        if torch is not None and torch.cuda.is_initialized():
            try:
                rec["backend"] = "cuda"
                rec["device_name"] = torch.cuda.get_device_name(0)
                rec["device_count"] = torch.cuda.device_count()
            except Exception:
                pass
    return rec
