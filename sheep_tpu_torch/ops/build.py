"""Single-device build: edges -> (sequence, elimination forest).

Port of sheep_tpu/ops/build.py.  ``build_graph_hybrid`` is the flagship
path: the device runs the phases that scale with E (degree histogram,
(degree, vid) sort, link mapping, and reduce rounds that kill the
duplicate and star-collapsible links), then the remaining links move to
the host and the exact sequential union-find (``native``) finishes.
Sound because every round preserves threshold connectivity, and the
forest is a function of threshold connectivity alone.

The hybrid's tail is the reference's default, the streamed windowed
handoff (:func:`stream_handoff_enabled`): the reduced links are sorted by
hi on the device and fetched on a background thread as W equal-count
hi-quantile windows of fixed-length slices (:class:`_WindowStream`), and
each window is folded into the resumable union-find
(``native.LinksFold``) the moment it lands, so the fold of window k
overlaps the fetch of window k+1.  On CUDA the slices go into pinned host
memory through ``non_blocking`` copies on a side stream that waits on an
event recorded after the sort.  On the CPU the fetch is a view, so the
windows split on the host, and the prep takes the reference's CPU
default: a host degree sequence (:func:`host_seq_mode`) and an immediate
handoff whose fold counts pst itself.  Any stream failure falls back to a
serial fetch of the same device arrays, and ``perf["stream_mode"]`` says
so.

``SHEEP_STREAM_HANDOFF=0`` selects the serial arm: one fold of one
reduced link set.  With the overlap on (:func:`_overlap_enabled`, the
default on CUDA) that set comes from the speculative overlapped snapshot
(:class:`_SpecHandoff`): once the live links fall under a threshold, a
background stream starts fetching the current snapshot while the reduce
loop goes on, and the loop stops as soon as a stream has landed.  Any
snapshot, or union of snapshots, hands off exactly, since every round
preserves threshold connectivity.  ``SHEEP_OVERLAP_HANDOFF=0`` makes the
serial arm fetch once after the loop.  Where the reference branches on
the JAX platform, the port branches on ``device.type``; the env knobs keep
their meanings.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..convert import edges_to_device
from ..core.forest import Forest
from .forest import (_i32, _np, _to_forest, forest_fixpoint_hosted,
                     pack_links_6b, parent_from_links, pst_weights,
                     reduce_links_hosted, sort_links_by_hi, unpack_links_6b)
from .sort import (degree_histogram, degree_order, edge_links,
                   given_seq_links)


def prepare_links(tail: torch.Tensor, head: torch.Tensor, n: int,
                  with_pst: bool = True):
    """Phases before the fixpoint: degree histogram, (degree, vid) sort,
    edge->link mapping, pst segment-sum.  Returns (seq, pos, num_active,
    lo, hi, pst); pst counts the ORIGINAL links (the reduce rewrites lo)
    and is None when ``with_pst`` is False."""
    deg = degree_histogram(tail, head, n)
    seq, pos, m = degree_order(deg)
    lo, hi = edge_links(tail, head, pos, n)
    pst = pst_weights(lo, n) if with_pst else None
    return seq, pos, m, lo, hi, pst


def _finish(seq, m, parent, pst):
    m = int(m)
    seq = _as_u32(np.ascontiguousarray(_np(seq)[:m]))
    # trimmed to the m active slots; parents of active nodes are < m
    return seq, _to_forest(_np(parent)[:m], _np(pst)[:m], m)


def _num_vertices(tail, head, num_vertices) -> int:
    if num_vertices is not None:
        return num_vertices
    if not len(tail):
        return 0
    return int(max(tail.max(), head.max())) + 1


def _device_edges(tail, head, device):
    if isinstance(tail, torch.Tensor):
        return tail.to(device, torch.int32), head.to(device, torch.int32)
    return edges_to_device(tail, head, device)


def build_graph_device(tail, head, num_vertices: int | None = None,
                       device=None):
    """Device build through the host-orchestrated chunked fixpoint:
    returns (seq uint32 [m], Forest over m).  ``device`` None is CUDA."""
    device = resolve_device(device)
    n = _num_vertices(tail, head, num_vertices)
    if n == 0:
        return np.empty(0, np.uint32), Forest(
            np.empty(0, np.uint32), np.empty(0, np.uint32))
    t, h = _device_edges(tail, head, device)
    seq, _, m, lo, hi, pst = prepare_links(t, h, n)
    parent, _ = forest_fixpoint_hosted(lo, hi, n)
    return _finish(seq, m, parent, pst)


def _host_seq_pst(tail_np: np.ndarray, head_np: np.ndarray, n: int,
                  seq: np.ndarray | None = None):
    """Host-side (seq, pst) identical to prepare_links' outputs: same
    order (degree asc, vid asc) and same pst (one count per non-self-loop
    record at its earlier-in-sequence endpoint, absent heads included).
    A given ``seq`` replaces the degree sort.  Block-wise gathers keep the
    peak at a few int arrays of one block."""
    from ..core.sequence import degree_sequence, sequence_positions

    seq_h = degree_sequence(tail_np, head_np, n) if seq is None \
        else np.asarray(seq, dtype=np.uint32)
    pos = sequence_positions(seq_h, n - 1)
    pst = np.zeros(n, np.int64)
    block = 1 << 24
    for s in range(0, len(tail_np), block):
        # absent vids carry INVALID (0xFFFFFFFF) >= n, so min() picks the
        # present endpoint and the lo < n filter drops both-absent pairs
        pt = pos[tail_np[s:s + block]].astype(np.int64)
        ph = pos[head_np[s:s + block]].astype(np.int64)
        lo = np.minimum(pt, ph)
        live = (pt != ph) & (lo < n)
        pst += np.bincount(lo[live], minlength=n)[:n]
    return seq_h, pst.astype(np.uint32)


def build_graph_hybrid(tail, head, num_vertices: int | None = None,
                       handoff_factor: int | None = None,
                       host_edges: tuple[np.ndarray, np.ndarray] | None = None,
                       seq: np.ndarray | None = None,
                       perf: dict | None = None, device=None):
    """Flagship build: device reduction + native union-find tail.
    Returns (seq uint32 [m], Forest over m), bit-identical to the oracle.

    ``device`` None is CUDA (RuntimeError without it); pass "cpu" to run
    on the CPU.  ``handoff_factor``: hand off once at most factor * n live
    links remain (SHEEP_HANDOFF_FACTOR; default 3 on CUDA, 8 on the CPU).
    ``host_edges``: the same records as host numpy arrays; with them seq
    and pst are recomputed on the host while the device reduces (numpy
    inputs serve as their own host copy on CUDA, and on the CPU under the
    streamed immediate handoff, where they feed the host-seq prep).
    ``seq``: a given elimination order (edges to vids outside it count
    toward pst, never the tree).  ``perf``: a dict that receives loop_s,
    rounds, live, fetch_tail_s, handoff_links, packed_handoff, fold_s,
    pst_wait_s, prefetch_s (the seq/pst prefetch thread's own time, when
    it runs), fetch_windows and, from the streamed tail, stream_mode,
    window_fetch_s, window_fold_s, window_fetch_phases, overlap_s and
    overlap_frac, or, from the serial arm's speculative snapshot,
    overlap, spec_starts, spec_restarts, spec_wasted_mb,
    spec_stopped_loop, spec_mode, spec_start_live and spec_fetch_phases
    (:func:`fetch_phases`).
    """
    device = resolve_device(device)
    if handoff_factor is None:
        handoff_factor = default_handoff_factor(device)
    n = _num_vertices(tail, head, num_vertices)
    if seq is not None and len(seq):
        n = max(n, int(np.asarray(seq).max()) + 1)
    if n == 0:
        return np.empty(0, np.uint32), Forest(
            np.empty(0, np.uint32), np.empty(0, np.uint32))
    streamed_cpu = stream_handoff_enabled() and handoff_input_ok(device)
    if host_edges is None \
            and isinstance(tail, np.ndarray) and isinstance(head, np.ndarray) \
            and (device.type == "cuda" or streamed_cpu):
        # the reference's defaults: on an accelerator the host copy
        # replaces the 2n*4B seq/pst fetch; under the CPU's streamed
        # immediate handoff it feeds the host-seq prep below
        host_edges = (tail, head)
    t, h = _device_edges(tail, head, device)
    given_seq = None
    _lazy_pst = None
    acc_ok = False  # may the tail fold count pst from its own links?
    if seq is None and host_edges is not None and host_seq_mode(device) \
            and streamed_cpu:
        # host-seq prep: the degree sequence on the host up front, so the
        # device maps links only.  Every active vid is in it, so no
        # pst-only link is masked out and the fold may count pst itself
        from ..core.sequence import degree_sequence
        seq = degree_sequence(host_edges[0], host_edges[1], n)
        acc_ok = True
    if seq is not None:
        # given order: no histogram, no device sort
        given_seq = np.asarray(seq, dtype=np.uint32)
        lo, hi, pst = given_seq_links(t, h, given_seq, n,
                                      with_pst=host_edges is None)
        m = len(given_seq)
        dev_seq = None
        if pst is None:
            # pst counts the pre-dead-mask lo, so the rare prefetch
            # failure reruns the mapping with the scatter included
            def _lazy_pst():
                return given_seq_links(t, h, given_seq, n)[2]
    else:
        # the device pst scatter is skipped where the host recomputes pst
        # or the streamed immediate-handoff fold counts it
        dev_seq, _, m, lo, hi, pst = prepare_links(
            t, h, n, with_pst=host_edges is None and not streamed_cpu)
        # full-graph prep: every vid holds a position, so no pst-only
        # link is masked out
        acc_ok = True
        if pst is None:
            orig_lo = lo

            def _lazy_pst():
                return pst_weights(orig_lo, n)
    seq = given_seq if given_seq is not None else dev_seq
    # seq/pst overlap the reduce rounds on a second thread: recomputed
    # from the host edge copy, or fetched from the device
    fetched: dict = {}
    pre = None
    if acc_ok and given_seq is not None:
        # host-seq prep: seq and m are known, and pst comes from the
        # fold's own read pass (the fallbacks resolve it through
        # _lazy_pst), so there is nothing to prefetch
        fetched = {"seq": given_seq, "m": len(given_seq)}
    else:
        def _prefetch():
            t0 = time.perf_counter()
            try:
                if host_edges is not None:
                    t_np, h_np = host_edges
                    fetched["seq"], fetched["pst"] = _host_seq_pst(
                        t_np, h_np, n, seq=given_seq)
                    fetched["m"] = len(fetched["seq"])
                else:
                    fetched["seq"] = _np(seq)
                    if pst is not None:
                        fetched["pst"] = _np(pst)
            except Exception:  # fall back to the synchronous fetch below
                fetched.clear()
            if perf is not None:
                perf["prefetch_s"] = round(time.perf_counter() - t0, 4)

        pre = threading.Thread(target=_prefetch, daemon=True)
        pre.start()

    def _pst_resolved():
        if "pst" in fetched:
            return fetched["pst"]
        return pst if pst is not None else _lazy_pst()

    def _pst_after_fetch():
        # resolved only once the link fetch has begun, so the prefetch
        # overlaps it
        if pre is not None:
            pre.join()
        return _as_u32(_np(_pst_resolved()))

    res = reduce_and_finish_native(
        lo, hi, n, stop_live=handoff_factor * n,
        handoff_input=handoff_input_ok(device), pst_h=_pst_after_fetch,
        accumulate_pst_ok=acc_ok, perf=perf)
    if res[0] == "device":  # converged before the handoff threshold
        _, a, b, live, rounds = res
        if pre is not None:
            pre.join()
        parent = parent_from_links(a, b, n)
        return _finish(fetched.get("seq", seq), fetched.get("m", m), parent,
                       _pst_resolved())
    _, parent_h, pst_out, live, rounds = res
    m = int(fetched.get("m", m))
    seq_np = _as_u32(np.ascontiguousarray(_np(fetched.get("seq", seq))[:m]))
    return seq_np, Forest(parent_h[:m].copy(), pst_out[:m].copy())


def handoff_input_ok(device: torch.device) -> bool:
    """The immediate-handoff gate: skip the device dedupe rounds only
    where the device->host copy is free (the CPU); on the card the fetch
    is a real transfer and the rounds shrink it first."""
    return device.type == "cpu"


def default_handoff_factor(device: torch.device) -> int:
    """Handoff threshold, stop_live = factor * n (SHEEP_HANDOFF_FACTOR
    overrides): 8 on the CPU, where the transfer is free; 3 on CUDA, the
    reference's accelerator default."""
    default = "8" if device.type == "cpu" else "3"
    return int(os.environ.get("SHEEP_HANDOFF_FACTOR", default))


def pack_handoff(n: int, device: torch.device) -> bool:
    """The 6-byte link packing policy of the serial fetch and the stream
    alike (SHEEP_PACK_HANDOFF overrides): on for CUDA, off on the CPU;
    packing needs n < 2^24."""
    pack = os.environ.get("SHEEP_PACK_HANDOFF", "")
    if pack == "":
        pack = "0" if device.type == "cpu" else "1"
    return pack == "1" and n < (1 << 24)


def stream_handoff_enabled() -> bool:
    """The streamed windowed handoff gate (SHEEP_STREAM_HANDOFF
    overrides; default on).  An explicit SHEEP_OVERLAP_HANDOFF=1 without
    an explicit stream choice turns it off, as in the reference, so that
    arm names what it runs (the serial arm's speculative snapshot)."""
    v = os.environ.get("SHEEP_STREAM_HANDOFF", "")
    if v != "":
        return v == "1"
    return os.environ.get("SHEEP_OVERLAP_HANDOFF", "") != "1"


def handoff_windows(live: int, device: torch.device) -> int:
    """Window count of the streamed tail (SHEEP_HANDOFF_WINDOWS
    overrides): one on the CPU, where the fetch is a view and there is
    nothing to overlap; on CUDA four once the handoff holds at least 2^20
    links, so the fold runs behind the stream while each window stays
    large, and one below that."""
    v = os.environ.get("SHEEP_HANDOFF_WINDOWS", "")
    if v != "":
        return max(1, int(v))
    if device.type == "cpu":
        return 1
    return 4 if live >= (1 << 20) else 1


def host_seq_mode(device: torch.device) -> bool:
    """Host degree sequence for the streamed hybrid's prep
    (SHEEP_STREAM_HOST_SEQ overrides): on for the CPU, where host and
    device share the cores and the device program shrinks to the link
    mapping; off on CUDA, where the device sort is cheap and a host
    sequence would serialize in front of the mapping."""
    v = os.environ.get("SHEEP_STREAM_HOST_SEQ", "")
    if v != "":
        return v == "1"
    return device.type == "cpu"


def _overlap_enabled(device: torch.device) -> bool:
    """The serial arm's speculative overlapped snapshot gate
    (SHEEP_OVERLAP_HANDOFF overrides): on for CUDA, where the link fetch
    is a real transfer worth hiding behind device rounds, off on the CPU,
    where the fetch is a view."""
    v = os.environ.get("SHEEP_OVERLAP_HANDOFF", "")
    if v != "":
        return v == "1"
    return device.type != "cpu"


def fetch_links_host(lo: torch.Tensor, hi: torch.Tensor, live: int, n: int):
    """The serial link-fetch policy: a 64K-granular cut of the live
    prefix, 6-byte packing per :func:`pack_handoff`, dead-sentinel
    filter.  Returns (lo_h, hi_h int32 numpy arrays, packed)."""
    cut = min(int(lo.shape[0]), -(-live // (1 << 16)) * (1 << 16))
    packed = pack_handoff(n, lo.device)
    if packed:
        buf = pack_links_6b(lo[:cut], hi[:cut]).cpu().numpy()[:live]
        lo_h, hi_h = unpack_links_6b(buf)
    else:
        lo_h = lo[:cut].cpu().numpy()[:live]
        hi_h = hi[:cut].cpu().numpy()[:live]
    keep = lo_h < n  # a few scattered dead slots may remain in the prefix
    return lo_h[keep], hi_h[keep], packed


@contextlib.contextmanager
def _timed(out: list):
    """Append the block's seconds to ``out`` when it completes (the
    arithmetic of the reference's obs.trace.timed, without its span
    recorder)."""
    t0 = time.perf_counter()
    yield
    out.append(time.perf_counter() - t0)


def overlap_stats(serialized_s: float, wall_s: float) -> dict:
    """Realized overlap of concurrent phases: ``serialized_s`` is their
    summed cost, ``wall_s`` what the clock saw (the reference's
    obs.trace.overlap_stats)."""
    overlap = max(0.0, serialized_s - wall_s)
    return {
        "overlap_s": round(overlap, 4),
        "overlap_frac": round(overlap / serialized_s, 4)
        if serialized_s > 0 else 0.0,
    }


def _slice_rows(buf: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """The fixed-length row slice [start, start + length) of a device
    buffer (a view)."""
    return buf[start:start + length]


def _to_host(parts, stream, phases: dict | None = None) -> list:
    """Host numpy copies of device tensors.  With a CUDA ``stream``: into
    pinned buffers by ``non_blocking`` copies on it, then one event that
    the host waits on before numpy may read them.  Without: plain copies
    (the CPU, where pinned memory does not exist).  ``phases`` (see
    :func:`fetch_phases`) gains the call's host seconds spent allocating
    the buffers, enqueuing the copies and waiting on them, and on CUDA
    the copies' device milliseconds."""
    cuda = stream is not None
    t0 = time.perf_counter()
    outs = [torch.empty(p.shape, dtype=p.dtype, pin_memory=cuda)
            for p in parts]
    t1 = time.perf_counter()
    if cuda:
        start = torch.cuda.Event(enable_timing=phases is not None)
        start.record(stream)
    for out, part in zip(outs, parts):
        out.copy_(part, non_blocking=cuda)
    t2 = time.perf_counter()
    if cuda:
        done = torch.cuda.Event(enable_timing=phases is not None)
        done.record(stream)
        done.synchronize()  # releases the GIL while it waits
    t3 = time.perf_counter()
    if phases is not None:
        phases["alloc_s"] += t1 - t0
        phases["copy_s"] += t2 - t1
        phases["wait_s"] += t3 - t2
        if cuda:
            phases["device_ms"] += start.elapsed_time(done)
    return [out.numpy() for out in outs]


def fetch_phases() -> dict:
    """A fetch thread's breakdown, summed over its slices: ``slices``,
    ``bytes``, ``busy_s`` (each slice's whole time), and of that the host
    seconds allocating pinned buffers (``alloc_s``), enqueuing the copies
    (``copy_s``) and waiting on them (``wait_s``), and the copies' device
    milliseconds (``device_ms``, CUDA events around them)."""
    return {"slices": 0, "bytes": 0, "busy_s": 0.0, "alloc_s": 0.0,
            "copy_s": 0.0, "wait_s": 0.0, "device_ms": 0.0}


def merge_phases(parts) -> dict:
    """The sum of several :func:`fetch_phases` dicts, rounded."""
    total = fetch_phases()
    for part in parts:
        for k in total:
            total[k] += part[k]
    return {k: v if isinstance(v, int) else round(v, 4)
            for k, v in total.items()}


class _StreamFetcher:
    """Background slice-streamed device->host fetch of one link snapshot.

    The snapshot (lo, hi) holds every live link in its first ``live``
    slots.  Transfers run as fixed-length slices of a 6-byte-packed buffer
    (n < 2^24, per :func:`pack_handoff`; int32 pairs otherwise), so
    progress is observable between slices and an abort loses at most one
    slice.  On CUDA the fetch thread copies on its own side stream, which
    first waits on an event recorded on the caller's current stream after
    the pack, and it keeps the packed buffer alive (``record_stream``)
    until it ends.  In the int32-pair mode the buffers are the snapshot's
    own lo and hi, not copies: the same event orders the side stream after
    their producer, ``record_stream`` keeps the caching allocator from
    handing their memory to the caller's later kernels while the copies
    run, and the reduce loop never writes a snapshot it handed out.
    """

    def __init__(self, lo: torch.Tensor, hi: torch.Tensor, n: int,
                 live: int, slice_links: int, autostart: bool = True):
        self.packed = pack_handoff(n, lo.device)
        self.bytes_per_link = 6 if self.packed else 8
        width = int(lo.shape[0])  # pow2-padded
        # round an arbitrary knob DOWN to a power of two (floor 512), so
        # a slice always divides the pow2 width: a non-dividing slice
        # would drop tail links without an error
        slice_links = 1 << max(9, int(slice_links).bit_length() - 1)
        self.slice_len = min(slice_links, width)
        self.total_slices = min(-(-live // self.slice_len),
                                width // self.slice_len)
        self.done_slices = 0
        self.failed = False
        self.error: Exception | None = None  # what ended the thread
        self._slice_s: list = []  # per-slice fetch seconds
        self.phases = fetch_phases()
        self._abort = False
        self._slices: list = []
        if self.packed:
            self._dev = (pack_links_6b(lo, hi),)
        else:
            self._dev = (_i32(lo).contiguous(), _i32(hi).contiguous())
        self._device = lo.device
        self._ready = None
        if self._device.type == "cuda":
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self._device))
        self._thread = threading.Thread(target=self._run, daemon=True)
        if autostart:
            self._thread.start()

    # seams of the window queue (_WindowStream): gate a slice before its
    # fetch, observe one landing.  Here: free-running.
    def _wait_turn(self, i: int) -> None:
        pass

    def _on_slice(self) -> None:
        pass

    @property
    def busy_s(self) -> float:
        """Thread time spent fetching slices."""
        return sum(self._slice_s)

    def _run(self) -> None:
        try:
            if self._device.type == "cuda":
                with torch.cuda.device(self._device):
                    side = torch.cuda.Stream()
                    side.wait_event(self._ready)
                    for buf in self._dev:
                        buf.record_stream(side)
                    with torch.cuda.stream(side):
                        self._fetch_all(side)
            else:
                self._fetch_all(None)
        except Exception as exc:  # the consumer falls back to a serial fetch
            self.error = exc
            self.failed = True
        finally:
            self._dev = None  # release the device buffer promptly
            self._on_slice()

    def _fetch_all(self, side) -> None:
        for i in range(self.total_slices):
            self._wait_turn(i)
            if self._abort:
                return
            start = i * self.slice_len
            with _timed(self._slice_s):
                got = _to_host([_slice_rows(buf, start, self.slice_len)
                                for buf in self._dev], side, self.phases)
            self.phases["slices"] += 1
            self.phases["bytes"] += sum(a.nbytes for a in got)
            self.phases["busy_s"] += self._slice_s[-1]
            self._slices.append(got[0] if self.packed else tuple(got))
            self.done_slices = i + 1
            self._on_slice()

    def finished(self) -> bool:
        return not self.failed and self.done_slices >= self.total_slices

    def remaining_bytes(self) -> int:
        return (self.total_slices - self.done_slices) * self.slice_len \
            * self.bytes_per_link

    def fetched_bytes(self) -> int:
        return self.done_slices * self.slice_len * self.bytes_per_link

    def join(self, timeout: float | None = None,
             mark_failed: bool = True) -> bool:
        """Wait for the stream; True if it is STILL RUNNING afterwards
        (then marked failed unless ``mark_failed`` is False)."""
        self._thread.join(timeout)
        alive = self._thread.is_alive()
        if alive and mark_failed:
            self.failed = True
        return alive

    def abort(self, timeout: float = 5.0) -> None:
        """Stop at the next slice boundary and wait briefly; the slices
        that landed stay, and a healthy stream is not marked failed."""
        self._abort = True
        self.join(timeout, mark_failed=False)

    def _unpack(self, part: list):
        if not part:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        if self.packed:
            return unpack_links_6b(np.concatenate(part))
        los, his = zip(*part)
        return np.concatenate(los), np.concatenate(his)

    def collect(self) -> tuple[np.ndarray, np.ndarray]:
        """Host (lo, hi) of every fetched slice (unfiltered: dead
        sentinel slots remain; callers mask lo < n)."""
        return self._unpack(list(self._slices))


class _WindowStream(_StreamFetcher):
    """The window queue of the streamed handoff: a hi-SORTED link table
    streams as fixed-length slices grouped into W equal-count windows
    (contiguous count-slices of the sorted table are the hi-quantile
    windows), and the fetch thread runs at most :data:`PREFETCH` windows
    ahead of the fold.  Resident host memory is O(live / W * PREFETCH);
    :meth:`window` hands window k to the fold and frees its slices while
    k+1 keeps streaming.
    """

    #: windows in flight beyond the one being folded
    PREFETCH = 2

    def __init__(self, lo, hi, n: int, live: int, slice_links: int,
                 windows: int):
        super().__init__(lo, hi, n, live, slice_links, autostart=False)
        self._cv = threading.Condition()
        self._consumed = -1  # highest window handed to the fold
        w = max(1, min(windows, self.total_slices))
        self.windows = w
        self._cuts = [(k * self.total_slices) // w for k in range(w + 1)]
        self._thread.start()

    def _window_of(self, i: int) -> int:
        return bisect.bisect_right(self._cuts, i) - 1

    def _wait_turn(self, i: int) -> None:
        with self._cv:
            while (not self._abort
                   and self._window_of(i)
                   > self._consumed + 1 + self.PREFETCH):
                self._cv.wait(0.5)

    def _on_slice(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def window(self, k: int, timeout_s: float | None = None):
        """Block until window k has landed, then return its host (lo, hi)
        int arrays (unfiltered) and free its slices.  Raises RuntimeError
        on a failed or wedged stream."""
        lo_w, hi_w = self.collect_range(self._cuts[k], self._cuts[k + 1],
                                        timeout_s)
        with self._cv:
            self._consumed = max(self._consumed, k)
            self._cv.notify_all()
        return lo_w, hi_w

    def collect_range(self, s0: int, s1: int,
                      timeout_s: float | None = None):
        if timeout_s is None:
            # a generous watchdog: a wedged transfer must never hold the
            # build forever
            timeout_s = ((s1 - s0) * self.slice_len * self.bytes_per_link
                         / 5e5 + 120.0)
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self.done_slices < s1 and not self.failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    self.failed = True
                    break
                self._cv.wait(min(left, 0.5))
        if self.failed:
            raise RuntimeError("window stream failed or timed out") \
                from self.error
        part = self._slices[s0:s1]
        for i in range(s0, s1):  # bound resident memory to the window
            self._slices[i] = None
        return self._unpack(part)

    def abort(self, timeout: float = 5.0) -> None:
        self._abort = True
        with self._cv:
            self._cv.notify_all()
        self.join(timeout, mark_failed=False)


def _as_u32(a: np.ndarray) -> np.ndarray:
    """uint32 without a copy where possible (contiguous int32 reinterprets,
    exact under the nonnegative-int32 contract)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a
    if a.dtype == np.int32 and a.flags["C_CONTIGUOUS"]:
        return a.view(np.uint32)
    return a.astype(np.uint32, copy=False)


def _stream_tail(lo: torch.Tensor, hi: torch.Tensor, live: int, n: int,
                 pst_h, accumulate: bool, perf: dict | None):
    """The streamed windowed handoff: fetch the reduced live set as W
    ascending hi-quantile windows and fold each straight into the
    resumable union-find.  Returns (parent, pst) uint32 [n], or None on
    any failure (the caller then fetches the same device arrays
    serially).

    ``accumulate`` True: the windows carry the ORIGINAL link multiset
    (immediate handoff, no reduce round), and the fold counts pst itself;
    ``pst_h`` is not touched.  False: ``pst_h`` (an array or a zero-arg
    callable) resolves after the stream has started, so a caller's pst
    prefetch overlaps the first windows' fetch.
    """
    from ..core.forest import host_hi_window_bounds, links_fold

    t_start = time.perf_counter()
    w = handoff_windows(live, lo.device)
    # SHEEP_STREAM_DEVICE_WINDOWS=1 runs the card's transfer path (device
    # hi-sort + _WindowStream slices) on CPU tensors, for the tests
    device_windows = lo.device.type != "cpu" \
        or os.environ.get("SHEEP_STREAM_DEVICE_WINDOWS", "") == "1"
    stream = None
    fetch_s: list = []
    fold_s: list = []
    pst_wait_s = 0.0
    links_folded = 0
    try:
        if device_windows:
            slo, shi = sort_links_by_hi(lo, hi)
            slice_links = int(os.environ.get("SHEEP_OVERLAP_SLICE",
                                             str(1 << 18)))
            stream = _WindowStream(slo, shi, n, live, slice_links, w)
            del slo, shi
            w = stream.windows

            def windows_iter():
                for k in range(w):
                    yield stream.window(k)
        else:
            # the CPU: the fetch is a view, the windows split on the host
            # by the shared quantile rule
            def windows_iter():
                lo_h = _np(lo)[:live]
                hi_h = _np(hi)[:live]
                keep = lo_h < n
                if w == 1:
                    yield lo_h[keep], hi_h[keep]
                    return
                lo_k = lo_h[keep]
                hi_k = hi_h[keep]
                bounds = host_hi_window_bounds(hi_k[hi_k < n], w, n)
                for k in range(w):
                    sel = hi_k >= bounds[k]
                    if k + 1 < w:  # the last window keeps any pst-only tail
                        sel &= hi_k < bounds[k + 1]
                    yield lo_k[sel], hi_k[sel]

        it = windows_iter()
        pst_arr = None
        if not accumulate:
            t0 = time.perf_counter()
            pst_arr = _as_u32(pst_h() if callable(pst_h) else pst_h)
            pst_wait_s = time.perf_counter() - t0
        fold = links_fold(n, pst_arr)
        for _ in range(w):
            with _timed(fetch_s):
                wlo, whi = next(it)
                keep = wlo < n
                if not keep.all():
                    wlo, whi = wlo[keep], whi[keep]
            with _timed(fold_s):
                fold.block(_as_u32(wlo), _as_u32(whi))
            links_folded += len(wlo)
        parent, pst_out = fold.finish()
    except Exception as exc:
        if stream is not None:
            stream.abort()
        if perf is not None:
            perf["stream_mode"] = f"fallback:{type(exc).__name__}"
        return None
    if perf is not None:
        wall = time.perf_counter() - t_start
        fetch_busy = stream.busy_s if stream is not None else sum(fetch_s)
        perf.update({
            "stream_mode": "windowed",
            "fetch_windows": w,
            "window_fetch_s": [round(x, 4) for x in fetch_s],
            "window_fold_s": [round(x, 4) for x in fold_s],
            "fold_s": round(sum(fold_s), 4),
            "pst_wait_s": round(pst_wait_s, 4),
            **overlap_stats(fetch_busy + sum(fold_s), wall),
            "handoff_links": links_folded,
            "packed_handoff": stream.packed if stream is not None
            else False,
        })
        if stream is not None:
            perf["window_fetch_phases"] = merge_phases([stream.phases])
    return parent, pst_out


class _SpecHandoff:
    """The speculative overlapped handoff of the serial arm (the
    reference's ``_SpecHandoff``).

    Soundness: every chunk output has the same threshold connectivity as
    the input links, the forest is a function of threshold connectivity
    only, and the fold takes an arbitrary-order multiset, so any complete
    snapshot hands off exactly, and so does a union of (partial or
    complete) snapshots.  Partial buffers of abandoned fetches are kept
    and folded beside one complete snapshot; a wrong guess costs bytes,
    never exactness.  A snapshot is never written after the loop hands it
    out (``reduce_links_hosted``'s ``watch``), so a stream reads what it
    was given.

    Policy: once live <= SHEEP_OVERLAP_SPEC_FACTOR * n (default 8) and
    the snapshot is at least SHEEP_OVERLAP_MIN_MB (default 4), stream it
    (SHEEP_OVERLAP_SLICE links a slice) while the loop keeps reducing.  At
    each later chunk: a finished stream stops the loop; a stream whose
    bytes still in flight exceed MARGIN times a fresh fetch of the
    smaller snapshot is abandoned (its partial kept) and restarted on the
    smaller one.  At the loop's end, wait out the stream when its
    remainder is cheaper than a fresh fetch of the final set, else
    abandon it and fetch the final set serially.
    """

    MARGIN = 1.25

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.bpl = 6 if pack_handoff(n, device) else 8
        self.spec_live = int(os.environ.get(
            "SHEEP_OVERLAP_SPEC_FACTOR", "8")) * n
        self.slice_links = int(os.environ.get(
            "SHEEP_OVERLAP_SLICE", str(1 << 18)))
        self.min_bytes = int(float(os.environ.get(
            "SHEEP_OVERLAP_MIN_MB", "4")) * (1 << 20))
        self.active: _StreamFetcher | None = None
        self.kept: list[tuple[np.ndarray, np.ndarray]] = []
        self.dead = False  # a failed fetch disables further speculation
        self.phases: list[dict] = []  # each started fetcher's breakdown
        self.stats: dict = {"overlap": True, "spec_starts": 0,
                            "spec_restarts": 0, "spec_wasted_mb": 0.0,
                            "spec_stopped_loop": False,
                            "spec_mode": "never_started"}

    @staticmethod
    def maybe(n: int, device: torch.device) -> "_SpecHandoff | None":
        """A speculation policy where the overlap gate is on, else None
        (the port's fold is always native, so it is the gate alone)."""
        if not _overlap_enabled(device):
            return None
        return _SpecHandoff(n, device)

    def _start(self, lo, hi, live: int) -> None:
        try:
            self.active = _StreamFetcher(lo, hi, self.n, live,
                                         self.slice_links)
            self.phases.append(self.active.phases)
            self.stats["spec_starts"] += 1
            self.stats.setdefault("spec_start_live", live)
        except Exception:
            self.active = None
            self.dead = True

    def _abandon(self) -> None:
        f = self.active
        self.active = None
        if f is None:
            return
        f.abort()
        self.stats["spec_wasted_mb"] = round(
            self.stats["spec_wasted_mb"] + f.fetched_bytes() / (1 << 20), 2)
        if not f.failed and f.done_slices:
            self.kept.append(f.collect())
        if f.failed:
            self.dead = True

    def on_chunk(self, lo, hi, live) -> bool:
        """``reduce_links_hosted``'s ``watch`` hook: True stops the
        loop."""
        live = int(live)
        if self.dead:
            return False
        if self.active is not None:
            if self.active.failed:
                self._abandon()
                return False
            if self.active.finished():
                self.stats["spec_stopped_loop"] = True
                return True
            if self.active.remaining_bytes() > \
                    live * self.bpl * self.MARGIN:
                self.stats["spec_restarts"] += 1
                self._abandon()
                # a restart keeps the first start's floor: below it the
                # fetch costs less than a new pack
                if not self.dead and live * self.bpl >= self.min_bytes:
                    self._start(lo, hi, live)
            return False
        if live <= self.spec_live and live * self.bpl >= self.min_bytes:
            self._start(lo, hi, live)
        return False

    def abort_all(self) -> None:
        """Converged without a handoff: nothing to collect."""
        if self.active is not None:
            self.active.abort()
            self.active = None
        self.kept = []

    def complete(self, lo, hi, live: int) -> tuple[np.ndarray, np.ndarray]:
        """The host handoff link set at the loop's end: one complete
        snapshot (streamed or freshly fetched) plus any kept partials,
        lo < n filtered."""
        live = int(live)
        mode = "plain"
        lo_h = hi_h = None
        f = self.active
        if f is not None and not f.failed:
            if f.finished():
                mode = "spec_complete"
            elif f.remaining_bytes() <= live * self.bpl:
                mode = "spec_wait"
                # a generous watchdog (0.5 MB/s plus grace): a wedged
                # stream falls back to the serial fetch, never holds
                f.join(timeout=f.remaining_bytes() / 5e5 + 120.0)
            else:
                self._abandon()
                f = None
                mode = "restart_final"
            if f is not None and not f.failed:
                lo_h, hi_h = f.collect()
                self.active = None
        if lo_h is None:
            # never started, failed or abandoned at the end: fetch the
            # final reduced set the serial way
            lo_h, hi_h, _ = fetch_links_host(lo, hi, live, self.n)
            if mode == "spec_wait":
                # the watchdog fired mid-wait: say so, and count its bytes
                mode = "spec_wait_timeout"
                if f is not None:
                    self.stats["spec_wasted_mb"] = round(
                        self.stats["spec_wasted_mb"]
                        + f.fetched_bytes() / (1 << 20), 2)
            elif mode != "restart_final":
                mode = "plain"
        if self.kept:
            klo, khi = zip(*self.kept)
            lo_h = np.concatenate([lo_h, *klo])
            hi_h = np.concatenate([hi_h, *khi])
            self.kept = []
        keep = lo_h < self.n
        self.stats["spec_mode"] = mode
        return np.ascontiguousarray(lo_h[keep]), \
            np.ascontiguousarray(hi_h[keep])


def reduce_and_fetch_links(lo, hi, n: int, stop_live: int,
                           handoff_input: bool = False, perf=None):
    """The serial arm's reduce + fetch: chunk rounds to ``stop_live``
    with the speculative overlapped fetch where :func:`_overlap_enabled`
    (:class:`_SpecHandoff`), a serial fetch after the loop elsewhere.
    Returns (kind, a, b, live, rounds): kind "device" (converged before
    the threshold; a/b are device link tensors) or "host" (a/b are the
    fetched, lo<n-filtered host link arrays).  ``perf`` gains loop_s,
    fetch_tail_s, rounds, live and, on a handoff, handoff_links (the
    links actually handed off, kept partials included) and
    packed_handoff; with the speculation also its stats (overlap,
    spec_starts, spec_restarts, spec_wasted_mb, spec_stopped_loop,
    spec_mode, spec_start_live) and ``spec_fetch_phases``, its fetch
    threads' :func:`fetch_phases` summed."""
    spec = _SpecHandoff.maybe(n, lo.device)
    t0 = time.perf_counter()
    lo, hi, live, rounds, converged = reduce_links_hosted(
        lo, hi, n, stop_live=stop_live, handoff_input=handoff_input,
        watch=spec.on_chunk if spec is not None else None)
    t1 = time.perf_counter()
    if perf is not None:
        perf["loop_s"] = round(t1 - t0, 4)
        perf["rounds"] = int(rounds)
        perf["live"] = int(live)
    if converged:
        if spec is not None:
            spec.abort_all()
        if perf is not None:
            perf["fetch_tail_s"] = 0.0
            if spec is not None:
                perf.update(spec.stats)
                perf["spec_fetch_phases"] = merge_phases(spec.phases)
        return "device", lo, hi, int(live), rounds
    if spec is not None:
        lo_h, hi_h = spec.complete(lo, hi, int(live))
    else:
        lo_h, hi_h, _ = fetch_links_host(lo, hi, int(live), n)
    if perf is not None:
        perf["fetch_tail_s"] = round(time.perf_counter() - t1, 4)
        perf["handoff_links"] = int(len(lo_h))
        perf["packed_handoff"] = pack_handoff(n, lo.device)
        if spec is not None:
            perf.update(spec.stats)
            perf["spec_fetch_phases"] = merge_phases(spec.phases)
    return "host", lo_h, hi_h, int(live), rounds


def _serial_fold(lo_h, hi_h, n: int, pst_h, perf) -> tuple:
    """Resolve ``pst_h`` (None: the fold counts pst), then the monolithic
    fold; ``perf`` gains pst_wait_s and fold_s."""
    t0 = time.perf_counter()
    if callable(pst_h):
        pst_h = pst_h()
    t1 = time.perf_counter()
    out = finish_native_host(lo_h, hi_h, n, pst_h)
    if perf is not None:
        perf["pst_wait_s"] = round(t1 - t0, 4)
        perf["fold_s"] = round(time.perf_counter() - t1, 4)
    return out


def reduce_and_finish_native(lo, hi, n: int, stop_live: int,
                             handoff_input: bool = False, pst_h=None,
                             accumulate_pst_ok: bool = False, perf=None):
    """Reduce + handoff + native fold: the streamed windowed tail when
    :func:`stream_handoff_enabled` (any stream failure falls back to a
    serial fetch of the same device arrays), else the serial arm.

    Returns ("device", lo, hi, live, rounds) when the loop converged
    before the threshold, else ("forest", parent, pst, live, rounds) with
    parent/pst uint32 [n].  ``pst_h``: the prep-time pst, an array or a
    zero-arg callable, consulted only when the fold cannot count pst
    itself.  ``accumulate_pst_ok``: the caller vouches that the INPUT
    links are the original multiset with no pst-only record masked out;
    the fold then counts pst whenever the loop took the immediate handoff
    (zero rounds).  ``perf`` gains loop_s, rounds, live, fetch_tail_s
    (the whole tail: fetch, pst wait and fold, minus their overlap),
    pst_wait_s, fold_s, handoff_links, packed_handoff, fetch_windows (0
    on the serial arm) and the streamed tail's keys."""
    if not stream_handoff_enabled():
        kind, a, b, live, rounds = reduce_and_fetch_links(
            lo, hi, n, stop_live=stop_live, handoff_input=handoff_input,
            perf=perf)
        if kind == "device":
            return "device", a, b, live, rounds
        parent, pst = _serial_fold(a, b, n, pst_h, perf)
        if perf is not None:
            perf["fetch_tail_s"] = round(
                perf.get("fetch_tail_s", 0.0) + perf["pst_wait_s"]
                + perf["fold_s"], 4)
            perf["fetch_windows"] = 0
        return "forest", parent, pst, live, rounds
    t0 = time.perf_counter()
    # handoff_sort=False: the streamed tail sorts by hi for its windows
    lo, hi, live, rounds, converged = reduce_links_hosted(
        lo, hi, n, stop_live=stop_live, handoff_input=handoff_input,
        handoff_sort=False)
    t1 = time.perf_counter()
    if perf is not None:
        perf["loop_s"] = round(t1 - t0, 4)
        perf["rounds"] = int(rounds)
        perf["live"] = int(live)
    if converged:
        if perf is not None:
            perf["fetch_tail_s"] = 0.0
        return "device", lo, hi, int(live), rounds
    accumulate = accumulate_pst_ok and rounds == 0
    out = _stream_tail(lo, hi, int(live), n, pst_h, accumulate, perf)
    if out is None:
        # the stream failed: serial fetch of the SAME device arrays and
        # the monolithic fold; ``accumulate`` holds for it too (same
        # multiset), so the fold counts pst exactly as planned
        lo_h, hi_h, packed = fetch_links_host(lo, hi, int(live), n)
        if perf is not None:
            perf["handoff_links"] = int(len(lo_h))
            perf["packed_handoff"] = packed
        out = _serial_fold(lo_h, hi_h, n, None if accumulate else pst_h,
                           perf)
    parent, pst = out
    if perf is not None:
        perf["fetch_tail_s"] = round(time.perf_counter() - t1, 4)
    return "forest", parent, pst, int(live), rounds


def finish_native_host(lo_h: np.ndarray, hi_h: np.ndarray, n: int, pst_h):
    """Exact union-find tail on host link arrays: returns (parent, pst)
    uint32 [n].  pst_h may be a zero-arg callable, resolved here, or None
    (the fold counts pst from the links)."""
    from .. import native

    if callable(pst_h):
        pst_h = pst_h()
    return native.build_forest_links(_as_u32(lo_h), _as_u32(hi_h), n, pst_h)


def handoff_finish_native(lo, hi, live: int, n: int, pst_h):
    """Fetch a reduced link set and finish with the exact sequential
    union-find: returns (parent, pst) uint32 [n]."""
    lo_h, hi_h, _ = fetch_links_host(lo, hi, live, n)
    return finish_native_host(lo_h, hi_h, n, pst_h)
