"""Span tracing, the flight recorder's write side (port of
sheep_tpu/obs/trace.py).

``SHEEP_TRACE=<path>`` turns every :func:`span`/:func:`event` call into
one JSON line appended to ``<path>``; unset, both are near-free —
:func:`span` returns a shared no-op singleton (no recorder, no file, no
per-call allocation beyond the caller's own kwargs), so the
instrumentation can live permanently in the hot paths.

File format: JSON Lines, one record per line, append-only::

    {"k":"meta","v":1,"pid":...,"t0":<unix>, "argv":[...]}
    {"k":"span","name":"fold","id":7,"par":3,"tid":2,"t":0.0123,
     "dur":0.456,"a":{"block":4}}
    {"k":"ev","name":"fault","par":3,"tid":2,"t":0.5,"a":{...}}

``t`` is seconds since the recorder opened (monotonic clock — a clock
step mid-run cannot reorder the timeline); spans are written at EXIT (so
``dur`` is exact), which means a parent line follows its children —
readers reconstruct the hierarchy from ``id``/``par``.  Every line is
flushed as it lands, so a kill -9 mid-run leaves a readable prefix plus
at most one torn trailing line — the same contract as the WAL
(serve/wal.py): :func:`read_trace` refuses the tear strict, salvages the
prefix in repair/trust, and refuses mid-file rot in every mode.  A CLEAN
close seals a ``.sum`` sidecar (integrity/sidecar.py) so ``sheep fsck``
can vouch for a finished trace byte-for-byte.

Thread-safety: span nesting is tracked per thread (threading.local), the
file write is one lock-guarded append per line.  Processes do not share
a recorder — a subprocess inheriting ``SHEEP_TRACE`` appends its own
``meta`` segment to the same file (append mode), which readers treat as
a new segment.

A second sink keeps spans in memory: inside :func:`capture` every span
is enabled, with or without ``SHEEP_TRACE``, and lands in the capture's
list as a :class:`CapturedSpan` (name, ids, thread, ``perf_counter``
start and end, attributes).  While ``torch``'s profiler records, an
enabled span also opens ``torch.profiler.record_function(<name>)``, so
the program's spans sit in the device trace on the profiler's own clock
and every kernel or copy launched inside one correlates to it.  ``torch``
is consulted only when it is loaded already: this module imports
without it.

The shared overlap accounting lives here too (:func:`overlap_stats`).
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import re
import sys
import threading
import time
import warnings
from typing import NamedTuple

ENV = "SHEEP_TRACE"
TRACE_SUFFIX = ".trace"
TRACE_VERSION = 1

#: rotation cap for long-lived daemons: when the active JSONL
#: grows past this many megabytes it is renamed to a numbered segment
#: (``x.trace`` -> ``x.0001.trace``) whose ``.sum`` is sealed on rotation,
#: and a fresh active file continues the SAME clock (t keeps counting
#: from the recorder's open, the new meta line repeats the original wall
#: ``t0``) — readers concatenate the chain.  Unset/0 = never rotate.
MAX_MB_ENV = "SHEEP_TRACE_MAX_MB"

_SEG_RE = re.compile(r"\.(\d{4})\.trace$")


def _segment_name(path: str, n: int) -> str:
    base = path[:-len(TRACE_SUFFIX)] if path.endswith(TRACE_SUFFIX) \
        else path
    return f"{base}.{n:04d}{TRACE_SUFFIX}"


def is_rotated_segment(path: str) -> bool:
    """True for a rotation-sealed segment (``x.0001.trace``): its tail
    was sealed at rotation, so a tear there is mid-chain damage — torn
    tails are legal ONLY on the newest (active) file of a chain."""
    return _SEG_RE.search(path) is not None


def trace_segments(path: str) -> list[str]:
    """The segment chain for an active trace path: rotated segments in
    rotation order, then the active file itself (when it exists)."""
    import glob as _glob
    base = path[:-len(TRACE_SUFFIX)] if path.endswith(TRACE_SUFFIX) \
        else path
    segs = []
    for p in _glob.glob(base + ".[0-9][0-9][0-9][0-9]" + TRACE_SUFFIX):
        m = _SEG_RE.search(p)
        if m:
            segs.append((int(m.group(1)), p))
    out = [p for _, p in sorted(segs)]
    if os.path.exists(path):
        out.append(path)
    return out


# -- request-id propagation --------------------------------------
#
# A fleet request crosses processes (router -> leader -> follower fsync);
# the rid is the join key that lets ``sheep trace --merge`` stitch their
# trace files back into one timeline.  The rid rides a thread-local scope
# so every span/event recorded inside it carries a top-level ``rid``
# field — including spans the SAMPLER skipped around (the scope is set
# whether or not the wrapping span recorded), and downstream spans the
# request opens (WAL fsync, repartition kicks on the request thread).

_rid_tl = threading.local()
_RID_SEED = os.urandom(4).hex()
_rid_counter = itertools.count(1)


def new_rid() -> str:
    """A compact process-unique request id: 8 random hex chars (the
    process) + an 8-hex counter — cheaper than urandom per request and
    unique across routers with overwhelming probability."""
    return f"{_RID_SEED}{next(_rid_counter):08x}"


def current_rid() -> str | None:
    return getattr(_rid_tl, "rid", None)


class _RidScope:
    """Class-based (not generator-based) context manager: this sits on
    the per-request hot path of router AND daemon, and the generator
    protocol's ~1.5us/call was most of the wire-token overhead budget
   ."""

    __slots__ = ("rid", "prev")

    def __init__(self, rid: str | None):
        self.rid = rid

    def __enter__(self) -> "_RidScope":
        if self.rid:
            self.prev = getattr(_rid_tl, "rid", None)
            _rid_tl.rid = self.rid
        return self

    def __exit__(self, *exc) -> bool:
        if self.rid:
            _rid_tl.rid = self.prev
        return False


_NOOP_RID_SCOPE = _RidScope(None)


def rid_scope(rid: str | None) -> "_RidScope":
    """Attach ``rid`` to every span/event recorded by this thread inside
    the scope (None = the shared no-op).  Nesting restores the outer rid
    on exit."""
    return _RidScope(rid) if rid else _NOOP_RID_SCOPE


class _NoopSpan:
    """The disabled-mode span: one shared instance, no state, no work.
    Identity-stable so the zero-allocation fast path is testable
    (``span("a") is span("b")`` when tracing is off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        pass


NOOP_SPAN = _NoopSpan()


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:  # numpy scalars and friends
        import numbers
        if isinstance(v, numbers.Integral):
            return int(v)
        if isinstance(v, numbers.Real):
            return float(v)
    except Exception:
        pass
    return str(v)


class CapturedSpan(NamedTuple):
    """One span as :func:`capture` keeps it.  ``tid`` and ``native`` are
    its thread's ``threading.get_ident()`` and ``get_native_id()``;
    ``start`` and ``end`` are ``time.perf_counter()`` seconds."""

    name: str
    id: int
    par: int | None
    tid: int
    native: int
    start: float
    end: float
    attrs: dict

    @property
    def dur(self) -> float:
        return self.end - self.start


class Capture:
    """The in-memory sink (``with capture() as cap: ...; cap.spans``):
    while entered, every span of every thread is enabled and appended to
    :attr:`spans` when it ends.  Captures nest and may run beside
    ``SHEEP_TRACE``; each keeps the spans that began inside it."""

    def __init__(self):
        self.spans: list[CapturedSpan] = []

    def named(self, name: str) -> list[CapturedSpan]:
        return [sp for sp in self.spans if sp.name == name]

    def __enter__(self) -> "Capture":
        global _captures
        with _capture_lock:
            _captures = _captures + (self,)
        return self

    def __exit__(self, *exc) -> bool:
        global _captures
        with _capture_lock:
            _captures = tuple(c for c in _captures if c is not self)
        return False


_captures: tuple = ()
_capture_lock = threading.Lock()


capture = Capture


def _profiler_range(name: str):
    """``record_function(name)``, entered, while torch's profiler records
    on this thread; else None.  torch is not imported here."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """One live span (enabled mode).  ``rec`` ids and nests it: the file
    recorder, or :data:`_UNFILED` for a span that only captures keep."""

    __slots__ = ("rec", "name", "attrs", "caps", "id", "par", "t0", "t1",
                 "rid", "prof")

    def __init__(self, rec, name: str, attrs: dict, caps: tuple = ()):
        self.rec = rec
        self.name = name
        self.attrs = attrs
        self.caps = caps

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        rec = self.rec
        tl = rec._tl
        stack = getattr(tl, "stack", None)
        if stack is None:
            stack = tl.stack = []
        self.par = stack[-1].id if stack else None
        self.id = rec._next_id()
        self.rid = current_rid()
        stack.append(self)
        self.prof = _profiler_range(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        rec = self.rec
        stack = rec._tl.stack
        # tolerate a mispaired exit (a span abandoned by an exception in
        # a generator): pop down to this span, never past it
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        rec._write_span(self, self.t0, t1 - self.t0)
        if self.caps:
            kept = CapturedSpan(self.name, self.id, self.par,
                                threading.get_ident(),
                                threading.get_native_id(), self.t0, t1,
                                dict(self.attrs))
            for cap in self.caps:
                cap.spans.append(kept)
        return False


class _Unfiled:
    """Ids and nesting for spans that no file records (a capture without
    ``SHEEP_TRACE``)."""

    def __init__(self):
        self._tl = threading.local()
        self._ids = itertools.count(1)

    def _next_id(self) -> int:
        return next(self._ids)

    def _write_span(self, sp: "_Span", t0: float, dur: float) -> None:
        pass


_UNFILED = _Unfiled()


class TraceRecorder:
    """Appends span/event lines to one JSONL file; tracks the in-memory
    per-phase rollup so live processes (bench records, serve STATS) can
    embed a summary without re-reading the file."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        # append mode: a resumed/forked run adds its own meta segment; a
        # stale sidecar from a previous clean close can no longer vouch
        # for the growing file, so drop it until the next clean close
        from ..integrity.sidecar import sidecar_path
        with contextlib.suppress(OSError):
            os.unlink(sidecar_path(path))
        self._f: io.TextIOBase | None = open(path, "a",
                                             encoding="ascii",
                                             errors="replace")
        self._lock = threading.Lock()
        self._tl = threading.local()
        self._id = 0
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._phases: dict[str, list] = {}  # name -> [count, total_s]
        self._events: dict[str, int] = {}   # name -> count
        # rotation state (SHEEP_TRACE_MAX_MB): byte budget for the
        # active file, current size, and the next segment number
        # (continuing past any segments an earlier recorder left)
        mb = os.environ.get(MAX_MB_ENV, "")
        try:
            self._max_bytes = int(float(mb) * (1 << 20)) if mb else 0
        except ValueError:
            warnings.warn(f"{MAX_MB_ENV}={mb!r} is not a number; "
                          f"trace rotation disabled")
            self._max_bytes = 0
        try:
            self._nbytes = os.path.getsize(path)
        except OSError:
            self._nbytes = 0
        self._seg = 0
        for p in trace_segments(path):
            m = _SEG_RE.search(p)
            if m:
                self._seg = max(self._seg, int(m.group(1)))
        import sys
        self._emit({"k": "meta", "v": TRACE_VERSION, "pid": os.getpid(),
                    "t0": self._wall0,
                    "argv": [str(a) for a in sys.argv[:6]]})

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _emit(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"),
                          default=_json_safe) + "\n"
        seal = None
        with self._lock:
            f = self._f
            if f is None:
                return
            try:
                f.write(line)
                f.flush()
                self._nbytes += len(line)
            except (OSError, ValueError):
                pass  # tracing must never break the traced build
            if self._max_bytes and self._nbytes >= self._max_bytes:
                seal = self._rotate_locked()
        if seal is not None:
            # the rotated segment's sidecar seals OUTSIDE the emit lock:
            # the atomic writer's fault hooks may emit a trace event and
            # re-enter _emit (the new active file absorbs it)
            try:
                from ..integrity.sidecar import write_sidecar
                write_sidecar(seal)
            except Exception:
                pass  # an unsealed segment reads as an unsealed partial

    def _rotate_locked(self) -> str | None:
        """Rename the full active file to the next numbered segment and
        reopen a fresh one continuing the SAME clock (t stays relative
        to the recorder's open; the new meta repeats the original wall
        t0 so readers align the chain as one timeline).  Returns the
        rotated segment path for the caller to seal, or None."""
        f = self._f
        try:
            f.flush()
            os.fsync(f.fileno())
        except (OSError, ValueError):
            pass
        with contextlib.suppress(Exception):
            f.close()
        self._f = None
        self._seg += 1
        seg = _segment_name(self.path, self._seg)
        try:
            os.replace(self.path, seg)
        except OSError:
            seg = None
        try:
            self._f = open(self.path, "a", encoding="ascii",
                           errors="replace")
        except OSError:
            return seg  # rotation stands; further lines are dropped
        self._nbytes = 0
        line = json.dumps({"k": "meta", "v": TRACE_VERSION,
                           "pid": os.getpid(), "t0": self._wall0,
                           "seg": self._seg},
                          separators=(",", ":")) + "\n"
        try:
            self._f.write(line)
            self._f.flush()
            self._nbytes += len(line)
        except (OSError, ValueError):
            pass
        return seg

    def span(self, name: str, attrs: dict) -> _Span:
        return _Span(self, name, attrs, _captures)

    def event(self, name: str, attrs: dict) -> None:
        stack = getattr(self._tl, "stack", None)
        with self._lock:
            self._events[name] = self._events.get(name, 0) + 1
        rec = {"k": "ev", "name": name,
               "par": stack[-1].id if stack else None,
               "tid": threading.get_ident() & 0xFFFF,
               "t": round(time.perf_counter() - self._t0, 6),
               "a": {k: _json_safe(v) for k, v in attrs.items()}}
        rid = current_rid()
        if rid is not None:
            rec["rid"] = rid
        self._emit(rec)

    def _write_span(self, sp: _Span, t0: float, dur: float) -> None:
        with self._lock:
            acc = self._phases.setdefault(sp.name, [0, 0.0])
            acc[0] += 1
            acc[1] += dur
        rec = {"k": "span", "name": sp.name, "id": sp.id,
               "par": sp.par,
               "tid": threading.get_ident() & 0xFFFF,
               "t": round(t0 - self._t0, 6),
               "dur": round(dur, 6),
               "a": {k: _json_safe(v) for k, v in sp.attrs.items()}}
        if sp.rid is not None:
            rec["rid"] = sp.rid
        self._emit(rec)

    def summary(self) -> dict:
        """In-memory per-phase rollup: {name: {count, total_s}} plus
        "_events" counts — what bench records embed live."""
        with self._lock:
            out = {name: {"count": c, "total_s": round(s, 6)}
                   for name, (c, s) in sorted(self._phases.items())}
            if self._events:
                out["_events"] = dict(sorted(self._events.items()))
            return out

    def close(self, seal: bool = True) -> None:
        """Flush, close, and (on a clean close) seal the ``.sum``
        sidecar that lets ``sheep fsck`` vouch for the finished file."""
        with self._lock:
            f, self._f = self._f, None
        if f is None:
            return
        try:
            f.flush()
            os.fsync(f.fileno())
        except (OSError, ValueError):
            pass
        with contextlib.suppress(Exception):
            f.close()
        if seal:
            try:
                from ..integrity.sidecar import write_sidecar
                write_sidecar(self.path)
            except Exception:
                pass  # a missing sidecar reads as an unsealed partial


# -- the module-level API (env-driven, ~zero cost when disabled) ----------

_recorder: TraceRecorder | None = None
_recorder_path: str | None = None
_atexit_installed = False
_rotate_lock = threading.Lock()


def _current() -> TraceRecorder | None:
    """The active recorder for the CURRENT value of ``SHEEP_TRACE`` —
    one environ lookup on the disabled fast path, recorder open/rotate
    (lock-guarded) when the value changed (tests and in-process A/B
    arms flip it)."""
    global _recorder, _recorder_path, _atexit_installed
    path = os.environ.get(ENV) or None
    if path == _recorder_path:
        return _recorder
    with _rotate_lock:
        if path == _recorder_path:  # lost the race: already rotated
            return _recorder
        new = None
        if path:
            try:
                new = TraceRecorder(path)
            except OSError as exc:
                # an unwritable SHEEP_TRACE must never break the traced
                # build: warn once, run untraced
                warnings.warn(f"SHEEP_TRACE={path!r} is unwritable "
                              f"({exc}); tracing disabled")
        old, _recorder = _recorder, new
        _recorder_path = path
        if _recorder is not None and not _atexit_installed:
            import atexit
            atexit.register(close_recorder)
            _atexit_installed = True
        cur = _recorder
    if old is not None:
        # close OUTSIDE the rotate lock: sealing the sidecar runs
        # through the atomic writer, whose fault hooks may emit a trace
        # event and re-enter here
        old.close()
    return cur


def enabled() -> bool:
    return _current() is not None


def _span_owner():
    """The recorder that ids and nests an enabled span, or None when
    spans are off (no ``SHEEP_TRACE``, no capture)."""
    rec = _current()
    if rec is None and _captures:
        return _UNFILED
    return rec


def span(name: str, **attrs):
    """A context manager timing one phase.  Disabled: the shared no-op
    singleton (identity-stable, allocation-free).  Enabled: a span line
    with hierarchical parent/thread ids lands at exit, in the file and
    in each open :func:`capture`."""
    rec = _span_owner()
    if rec is None:
        return NOOP_SPAN
    return _Span(rec, name, attrs, _captures)


def event(name: str, **attrs) -> None:
    """An instantaneous record (ladder decisions, fault firings)."""
    rec = _current()
    if rec is not None:
        rec.event(name, attrs)


SAMPLE_ENV = "SHEEP_TRACE_SAMPLE"

_sample_spec: str | None = None
_sample_every = 1
_sample_counters: dict[str, int] = {}
_sample_lock = threading.Lock()
#: calls between environ re-reads of the sample rate: the environ
#: lookup is ~2us (bytes round-trip through os.environ) and the skip
#: path runs once per REQUEST, so the rate is cached and re-read every
#: this-many calls (an env flip lands within one window)
_SAMPLE_RECHECK = 512
_sample_countdown = 0


def sample_every() -> int:
    """The parsed ``SHEEP_TRACE_SAMPLE`` rate: ``1/N`` (or a bare
    ``N``) means one span per N calls, 1 means every call (the
    default).  Garbage never breaks the traced server: it warns once
    and samples everything.  Calling this directly re-reads the env NOW
    (tests do); the hot path re-reads every :data:`_SAMPLE_RECHECK`
    calls."""
    global _sample_spec, _sample_every, _sample_countdown
    _sample_countdown = _SAMPLE_RECHECK
    spec = os.environ.get(SAMPLE_ENV, "")
    if spec != _sample_spec:
        _sample_spec = spec
        n = 1
        if spec:
            try:
                num, _, den = spec.partition("/")
                n = int(den) if den else int(num)
                if den and int(num) != 1:
                    raise ValueError
                if n < 1:
                    raise ValueError
            except ValueError:
                warnings.warn(f"{SAMPLE_ENV}={spec!r} is not 1/N or N; "
                              f"sampling every span")
                n = 1
        _sample_every = n
        with _sample_lock:
            _sample_counters.clear()
    return _sample_every


def sampled_span(name: str, **attrs):
    """:func:`span` under the ``SHEEP_TRACE_SAMPLE=1/N`` gate:
    per-REQUEST spans on a loaded server would blow the <2% trace
    overhead budget at tens of thousands of lines per second, so only
    every Nth call of each span name records — enough that traces
    exist under load, cheap enough to leave on.  Disabled tracing or a
    skipped sample returns the shared no-op singleton; a recorded span
    carries ``sample=N`` so readers can re-scale counts."""
    rec = _span_owner()
    if rec is None:
        return NOOP_SPAN
    global _sample_countdown
    _sample_countdown -= 1
    if _sample_countdown <= 0:
        sample_every()  # re-read the env once per window
    n = _sample_every
    if n > 1:
        # deliberately lock-free: a racy lost increment only nudges the
        # sampling cadence, and the skip path runs once per REQUEST on
        # a loaded server — the lock was most of the <2% budget
        c = _sample_counters.get(name, 0)
        _sample_counters[name] = c + 1
        if c % n:
            return NOOP_SPAN
        attrs["sample"] = n
    return _Span(rec, name, attrs, _captures)


class timed:
    """:func:`span` that ALWAYS measures: appends the phase's seconds to
    ``out`` (when given) whether or not tracing is enabled, the span's
    own duration when it is enabled.  THE one accumulation path for
    every perf-dict phase series that predates the recorder (the build
    path's layer timers, window_fold_s, ext read/fold, prefetch busy
    time) — the legacy record keys are views of these lists now.  A
    block that raises appends nothing."""

    __slots__ = ("out", "sp", "t0")

    def __init__(self, name: str, out: list | None = None, **attrs):
        self.out = out
        self.sp = span(name, **attrs)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.sp.__enter__()

    def __exit__(self, *exc) -> bool:
        sp = self.sp
        sp.__exit__(*exc)
        if self.out is not None and exc[0] is None:
            self.out.append(sp.t1 - sp.t0 if sp is not NOOP_SPAN
                            else time.perf_counter() - self.t0)
        return False


def annotate(**attrs) -> None:
    """Merge attributes into the current thread's innermost open span
    (no-op when tracing is disabled or no span is open)."""
    rec = _span_owner()
    if rec is None:
        return
    stack = getattr(rec._tl, "stack", None)
    if stack:
        stack[-1].annotate(**attrs)


def trace_summary() -> dict | None:
    """The live recorder's in-memory rollup (None when disabled) — what
    the bench records embed without re-reading the file."""
    rec = _current()
    return rec.summary() if rec is not None else None


def close_recorder() -> None:
    """Flush + close + seal the active recorder (atexit does this on
    clean interpreter exit; kill -9 leaves the partial-trace contract)."""
    global _recorder, _recorder_path
    with _rotate_lock:
        old, _recorder = _recorder, None
        _recorder_path = None
    if old is not None:
        old.close()  # outside the lock, same reason as _current


# -- shared overlap accounting ---------------------------------------------


def overlap_stats(serialized_s: float, wall_s: float) -> dict:
    """Realized overlap of phases that ran concurrently: ``serialized_s``
    is what the phases cost summed as if serial, ``wall_s`` what the
    clock actually saw.  Returns {"overlap_s", "overlap_frac"} rounded
    the way every record publishes them (the external-memory build's
    read/fold overlap)."""
    overlap = max(0.0, serialized_s - wall_s)
    return {
        "overlap_s": round(overlap, 4),
        "overlap_frac": round(overlap / serialized_s, 4)
        if serialized_s > 0 else 0.0,
    }


# -- read side (sheep trace / fsck) ---------------------------------------


def read_trace(path: str, mode: str | None = None):
    """Parse a trace file.  Returns ``(records, clean_bytes, torn)``.

    Same tear contract as the WAL: a torn TRAILING line (the partial
    line a kill -9 left — unterminated, or unparseable as JSON with
    nothing valid after it) is refused strict / salvaged with a warning
    in repair or trust; an unparseable line with a VALID line after it
    is mid-file rot and refused in every mode.
    """
    from ..integrity.errors import MalformedArtifact
    from ..integrity.sidecar import resolve_policy
    mode = resolve_policy(mode)
    with open(path, "rb") as f:
        data = f.read()
    records: list[dict] = []
    off = 0
    bad = None  # (offset, reason) of the first unreadable line
    while off < len(data):
        nl = data.find(b"\n", off)
        if nl < 0:
            bad = (off, f"{len(data) - off} unterminated trailing bytes")
            break
        raw = data[off:nl]
        try:
            rec = json.loads(raw)
            if not isinstance(rec, dict) or "k" not in rec:
                raise ValueError("not a trace record")
        except (ValueError, UnicodeDecodeError) as exc:
            bad = (off, f"unparseable line ({exc})")
            break
        records.append(rec)
        off = nl + 1
    if bad is None:
        return records, off, False
    # a bad line is only a TEAR if no valid record line follows it
    tail_off, reason = bad
    scan = data.find(b"\n", tail_off)
    while scan >= 0:
        nxt = data.find(b"\n", scan + 1)
        end = nxt if nxt >= 0 else len(data)
        intact = False
        try:
            rec = json.loads(data[scan + 1:end])
            intact = isinstance(rec, dict) and "k" in rec
        except (ValueError, UnicodeDecodeError):
            pass
        if intact:
            raise MalformedArtifact(
                f"{path}: corrupt trace — line at byte {tail_off} is "
                f"damaged ({reason}) but an intact record follows at "
                f"{scan + 1}: mid-file corruption, not a torn tail")
        scan = nxt
    msg = (f"{path}: torn trace — {reason} at byte {tail_off} "
           f"({len(records)} intact record(s) precede it)")
    if mode == "strict":
        raise MalformedArtifact(
            msg + "; refusing in strict mode (repair mode keeps the "
                  "clean prefix)")
    warnings.warn(msg + "; salvaging the clean prefix")
    return records, tail_off, True


def repair_trace(path: str) -> int:
    """Truncate a torn trailing line off the file (mirrors
    serve/wal.repair_wal).  Returns bytes removed (0 when clean).
    Mid-file rot still raises — amputation never resurrects it."""
    _, clean_end, torn = read_trace(path, "repair")
    if not torn:
        return 0
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(clean_end)
        f.flush()
        os.fsync(f.fileno())
    return size - clean_end


def read_trace_chain(path: str, mode: str | None = None) -> list[dict]:
    """Read a rotated segment chain as ONE record stream: every rotated
    segment strictly (their tails were sealed at rotation — a tear there
    is damage, not a kill), then the active file under ``mode`` (where a
    torn tail is the legal kill -9 shape)."""
    records: list[dict] = []
    chain = trace_segments(path)
    if not chain:
        raise OSError(f"no trace file or segments at {path}")
    for p in chain:
        seg_mode = "strict" if p != path else mode
        recs, _, _ = read_trace(p, seg_mode)
        records.extend(recs)
    return records


def rollup(records: list[dict]) -> dict:
    """Aggregate span records into the per-phase rollup:
    {name: {count, total_s, max_s}} plus "_events" counts by name."""
    phases: dict = {}
    events: dict[str, int] = {}
    for r in records:
        k = r.get("k")
        if k == "span":
            acc = phases.setdefault(
                r.get("name", "?"),
                {"count": 0, "total_s": 0.0, "max_s": 0.0})
            acc["count"] += 1
            dur = float(r.get("dur", 0.0))
            acc["total_s"] = round(acc["total_s"] + dur, 6)
            acc["max_s"] = round(max(acc["max_s"], dur), 6)
        elif k == "ev":
            name = r.get("name", "?")
            events[name] = events.get(name, 0) + 1
    out = dict(sorted(phases.items()))
    if events:
        out["_events"] = dict(sorted(events.items()))
    return out
