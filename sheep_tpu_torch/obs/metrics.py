"""Counters, gauges, fixed-bucket histograms and the process's own
accounting (port of sheep_tpu/obs/metrics.py) — no dependencies.

The registry renders as Prometheus text exposition format, and
``parse_prometheus``/``relabel`` are its read side; the serving tier
that exports it is not ported yet (ROADMAP.md §1).  ``proc_status`` is
what the distext legs self-report (cli/distext.py ``--perf-out``):
VmRSS/VmHWM as ``/proc`` gives them (a host whose ``/proc`` has no
VmHWM gives no ``vmhwm`` key), threads, fds and the affinity mask.

Deliberately tiny: fixed bucket boundaries (quantiles are bucket
upper-bound estimates, which is what Prometheus itself gives you),
label support limited to one flat label set per child, a single lock
per registry.
"""

from __future__ import annotations

import os
import threading
import time

#: request-latency bucket upper bounds in seconds (powers-of-~2.5 from
#: 100us to 10s; +Inf is implicit)
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: sliding-window view: a ring of per-slot bucket snapshots —
#: WINDOW_SLOTS slots of WINDOW_SLOT_S seconds each (~30s of history) so
#: ``sheep top`` shows CURRENT latency while the lifetime series stays
#: cumulative for scrapers
WINDOW_SLOTS = 15
WINDOW_SLOT_S = 2.0


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotone counter; ``labels(**kv)`` returns the child for one
    label set (created on first use)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", _lock=None):
        self.name = name
        self.help = help
        self._lock = _lock or threading.Lock()
        self.value = 0.0
        self._children: dict[tuple, Counter] = {}

    def labels(self, **kv) -> "Counter":
        key = tuple(sorted(kv.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Counter(self.name, self.help, _lock=self._lock)
                self._children[key] = child
        return child

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def _render(self, out: list) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        if self._children:
            for key, child in sorted(self._children.items()):
                out.append(f"{self.name}{_label_str(dict(key))} "
                           f"{_num(child.value)}")
        else:
            out.append(f"{self.name} {_num(self.value)}")

    def snapshot(self) -> dict:
        """{label-tuple-or-(): value} for STATS derivation."""
        with self._lock:
            if self._children:
                return {k: c.value for k, c in self._children.items()}
            return {(): self.value}

    def children(self) -> dict:
        """{label-tuple: child} — how STATS walks the per-verb series."""
        with self._lock:
            return dict(self._children)


class Gauge(Counter):
    kind = "gauge"

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def labels(self, **kv) -> "Gauge":
        key = tuple(sorted(kv.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Gauge(self.name, self.help, _lock=self._lock)
                self._children[key] = child
        return child


class Histogram:
    """Fixed-bucket latency histogram.  ``observe(seconds)``;
    ``quantile(q)`` returns the upper bound of the bucket holding the
    q-th observation (the standard bucket-estimate; exact enough for
    p50/p99 alerting, cheap enough for the request path)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS, _lock=None,
                 clock=None):
        self.name = name
        self.help = help
        self.buckets = tuple(buckets)
        self._lock = _lock or threading.Lock()
        self._clock = clock or time.monotonic
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
        self.sum = 0.0
        self.count = 0
        # the sliding-window ring: per-slot bucket counts + the slot
        # index each position last served (stale positions re-zero lazily
        # on the next observe that lands in them)
        self._w_counts = [[0] * (len(self.buckets) + 1)
                          for _ in range(WINDOW_SLOTS)]
        self._w_stamp = [-1] * WINDOW_SLOTS
        self._children: dict[tuple, Histogram] = {}

    def labels(self, **kv) -> "Histogram":
        key = tuple(sorted(kv.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Histogram(self.name, self.help, self.buckets,
                                  _lock=self._lock, clock=self._clock)
                self._children[key] = child
        return child

    def children(self) -> dict:
        """{label-tuple: child} — how STATS walks the per-verb series."""
        with self._lock:
            return dict(self._children)

    def observe(self, v: float) -> None:
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                break
        else:
            i = len(self.buckets)
        slot = int(self._clock() / WINDOW_SLOT_S)
        pos = slot % WINDOW_SLOTS
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if self._w_stamp[pos] != slot:
                self._w_stamp[pos] = slot
                wc = self._w_counts[pos]
                for j in range(len(wc)):
                    wc[j] = 0
            self._w_counts[pos][i] += 1

    # -- the sliding-window view -------------------------------------------

    def window_counts(self) -> list[int]:
        """Bucket counts over the last ~WINDOW_SLOTS*WINDOW_SLOT_S
        seconds (slots whose stamp is inside the window)."""
        now_slot = int(self._clock() / WINDOW_SLOT_S)
        lo = now_slot - WINDOW_SLOTS + 1
        out = [0] * (len(self.buckets) + 1)
        with self._lock:
            for stamp, wc in zip(self._w_stamp, self._w_counts):
                if lo <= stamp <= now_slot:
                    for j, c in enumerate(wc):
                        out[j] += c
        return out

    def window_count(self) -> int:
        return sum(self.window_counts())

    def window_quantile(self, q: float) -> float:
        """The bucket-upper-bound q-quantile over the sliding window —
        what ``sheep top`` renders as CURRENT latency (0.0 when the
        window is empty; the lifetime :meth:`quantile` is untouched)."""
        counts = self.window_counts()
        total = sum(counts)
        if total == 0:
            return 0.0
        want = max(1, int(q * total + 0.999999))
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= want:
                return self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
        return self.buckets[-1]

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile in seconds (0.0 when
        empty; the last finite bucket bound when q lands in +Inf)."""
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            want = max(1, int(q * total + 0.999999))
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= want:
                    return self.buckets[i] if i < len(self.buckets) \
                        else self.buckets[-1]
        return self.buckets[-1]

    def _render_one(self, out: list, labels: dict) -> None:
        cum = 0
        for ub, c in zip(self.buckets, self.counts):
            cum += c
            lb = dict(labels)
            lb["le"] = _num(ub)
            out.append(f"{self.name}_bucket{_label_str(lb)} {cum}")
        lb = dict(labels)
        lb["le"] = "+Inf"
        out.append(f"{self.name}_bucket{_label_str(lb)} {self.count}")
        out.append(f"{self.name}_sum{_label_str(labels)} "
                   f"{_num(round(self.sum, 9))}")
        out.append(f"{self.name}_count{_label_str(labels)} {self.count}")

    def _render(self, out: list) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        if self._children:
            for key, child in sorted(self._children.items()):
                child._render_one(out, dict(key))
        else:
            self._render_one(out, {})


def _num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Registry:
    """Named metrics, one namespace; ``render()`` is the scrape body."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._get(name, lambda: Counter(name, help))
        assert isinstance(m, Counter) and m.kind == "counter", name
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._get(name, lambda: Gauge(name, help))
        assert isinstance(m, Gauge), name
        return m

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        m = self._get(name, lambda: Histogram(name, help, buckets))
        assert isinstance(m, Histogram), name
        return m

    def render(self) -> str:
        """Prometheus text exposition format; always newline-terminated
        (the METRICS verb's ``bytes=`` count includes it)."""
        out: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for _, m in metrics:
            m._render(out)  # type: ignore[attr-defined]
        return "\n".join(out) + "\n"


# -- scrape plumbing (the fleet fan-in) -------------------------------------


def parse_prometheus(body: str) -> list[tuple[str, dict, float]]:
    """Parse text exposition format into ``(name, labels, value)``
    samples — the read half the fleet aggregator and ``sheep top`` share.
    Unparseable lines are skipped (a scrape is advisory input, never a
    crash)."""
    out: list[tuple[str, dict, float]] = []
    for ln in body.splitlines():
        if not ln or ln.startswith("#"):
            continue
        head, sep, val = ln.rpartition(" ")
        if not sep:
            continue
        try:
            fval = float(val)
        except ValueError:
            continue
        name, labels = head, {}
        if head.endswith("}") and "{" in head:
            name, _, inner = head.partition("{")
            for part in inner[:-1].split(","):
                if not part:
                    continue
                k, _, v = part.partition("=")
                labels[k] = v.strip('"')
        out.append((name, labels, fval))
    return out


def relabel(body: str, extra: dict,
            seen_headers: set | None = None) -> str:
    """Merge ``extra`` labels into every sample line of a scrape body —
    how the router's fleet scrape stamps ``instance``/``cluster`` onto
    each member's series.  A label the sample ALREADY carries wins over
    ``extra`` (a fleet-derived gauge's own ``cluster=`` must not be
    clobbered by the stamping pass).  ``seen_headers`` (when given)
    dedupes ``# HELP``/``# TYPE`` lines across members sharing metric
    names."""
    out: list[str] = []
    for ln in body.splitlines():
        if not ln:
            continue
        if ln.startswith("#"):
            if seen_headers is not None:
                if ln in seen_headers:
                    continue
                seen_headers.add(ln)
            out.append(ln)
            continue
        head, sep, val = ln.rpartition(" ")
        if not sep:
            out.append(ln)
            continue
        name, labels = head, {}
        if head.endswith("}") and "{" in head:
            name, _, inner = head.partition("{")
            for part in inner[:-1].split(","):
                if not part:
                    continue
                k, _, v = part.partition("=")
                labels[k] = v.strip('"')
        for k, v in extra.items():
            labels.setdefault(k, str(v))
        out.append(f"{name}{_label_str(labels)} {val}")
    return "\n".join(out) + ("\n" if out else "")


# -- standard process self-accounting ---------------------------------------
#
# Every METRICS payload self-reports VmRSS/VmHWM/threads/fds/uptime/pid,
# refreshed on scrape.


def proc_status(pid: int | None = None) -> dict:
    """Per-process accounting from ``/proc/<pid>/status`` (this process
    by default): pid, vmrss/vmhwm (raw kB strings), threads,
    cpus_allowed_list, open fd count, and sched affinity."""
    pid = os.getpid() if pid is None else pid
    rec: dict = {"pid": pid}
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in ("VmRSS", "VmHWM", "Threads",
                           "Cpus_allowed_list"):
                    rec[key.lower()] = rest.strip()
    except OSError as exc:
        rec["error"] = str(exc)
    try:
        rec["fds"] = len(os.listdir(f"/proc/{pid}/fd"))
    except OSError:
        pass
    try:
        rec["affinity_cores"] = sorted(os.sched_getaffinity(pid))
    except (AttributeError, OSError):
        pass
    return rec


def _kb_bytes(s) -> int | None:
    try:
        return int(str(s).split()[0]) * 1024
    except (ValueError, IndexError, AttributeError):
        return None


def set_process_gauges(registry: "Registry",
                       started_at: float | None = None) -> None:
    """Refresh the standard ``sheep_process_*`` gauges from /proc —
    called at scrape time so the payload self-reports current
    accounting (``started_at`` is a ``time.monotonic`` origin for the
    uptime gauge)."""
    st = proc_status()
    g = registry.gauge
    g("sheep_process_pid", "process id").set(st["pid"])
    rss = _kb_bytes(st.get("vmrss"))
    if rss is not None:
        g("sheep_process_vmrss_bytes", "resident set size").set(rss)
    hwm = _kb_bytes(st.get("vmhwm"))
    if hwm is not None:
        g("sheep_process_vmhwm_bytes",
          "resident set high-water mark").set(hwm)
    try:
        g("sheep_process_threads", "thread count").set(
            int(st.get("threads", 0)))
    except (TypeError, ValueError):
        pass
    if "fds" in st:
        g("sheep_process_open_fds", "open file descriptors").set(
            st["fds"])
    if started_at is not None:
        g("sheep_process_uptime_seconds", "process uptime").set(
            round(time.monotonic() - started_at, 3))
