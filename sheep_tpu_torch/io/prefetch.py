"""Reusable async block prefetcher: read block k+1 while block k folds.

This is the I/O generalization of the streaming windowed handoff's
``_WindowStream`` (ops/build.py): that class overlaps a DEVICE
transfer queue with the fold consuming it; this one overlaps an arbitrary
block *producer* — a ``.dat`` memmap stream (io/edges.iter_dat_blocks),
the spill rung's scratch-file slices (runtime/driver.py), anything that
yields blocks — with whatever consumes them.  Same contract as the window
queue: a background thread runs at most ``depth`` blocks ahead of the
consumer (double buffering by default, so resident memory beyond the
consumer's own state is O(depth x block)), a producer failure surfaces in
the consumer's iteration with the ORIGINAL exception (an injected EIO
from the fault plan must reach the retry/degrade logic typed, not wrapped
into anonymity), and abandoning the iterator releases the thread at the
next block boundary.

The producer's time inside ``next()`` accumulates through the flight
recorder's shared timing helper (obs.trace.timed — one span per block
when ``SHEEP_TRACE`` is on, the same measured series either way), and
``busy_s`` is its sum: measured, not assumed (on a 1-core host the
overlap capacity is ~zero and the records must say so honestly).
"""

from __future__ import annotations

import threading

from ..obs import trace as obs

#: blocks the producer may run ahead of the consumer (double buffering:
#: fold block k while k+1 is resident and k+2 is being read)
DEFAULT_DEPTH = 2


class BlockPrefetcher:
    """Iterate ``source`` on a background thread, at most ``depth`` blocks
    ahead of the consumer.  Use as an iterator (``for block in pf:``) or a
    context manager (guarantees the thread is released on early exit).
    ``trace_name`` names the per-block read span in the flight recorder."""

    _END = object()

    def __init__(self, source, depth: int = DEFAULT_DEPTH,
                 trace_name: str = "prefetch.read"):
        if depth < 1:
            raise ValueError(f"prefetch depth {depth} must be >= 1")
        self.depth = depth
        self.trace_name = trace_name
        self._read_s: list = []  # per-block producer seconds (obs.timed)
        self.blocks = 0          # blocks produced so far
        self._src = iter(source)
        self._buf: list = []
        self._exc: BaseException | None = None
        self._done = False
        self._abort = False
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def busy_s(self) -> float:
        """Producer time actually spent reading blocks (the overlap
        accounting's serialized read term)."""
        return sum(self._read_s)

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while len(self._buf) >= self.depth and not self._abort:
                        self._cv.wait(0.5)
                    if self._abort:
                        return
                try:
                    with obs.timed(self.trace_name, out=self._read_s,
                                   block=self.blocks):
                        item = next(self._src)
                except StopIteration:
                    return
                with self._cv:
                    self._buf.append(item)
                    self.blocks += 1
                    self._cv.notify_all()
        except BaseException as exc:  # re-raised typed on the consumer side
            with self._cv:
                self._exc = exc
                self._cv.notify_all()
        finally:
            with self._cv:
                self._done = True
                self._cv.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            while True:
                if self._buf:
                    item = self._buf.pop(0)
                    self._cv.notify_all()
                    return item
                if self._exc is not None:
                    exc, self._exc = self._exc, None
                    self._done = True
                    raise exc
                if self._done:
                    raise StopIteration
                self._cv.wait(0.5)

    def close(self) -> None:
        """Release the producer thread at its next block boundary and
        drop any buffered blocks.  Idempotent; safe mid-iteration (the
        early-exit path of a failed consumer)."""
        with self._cv:
            self._abort = True
            self._buf.clear()
            self._cv.notify_all()
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "BlockPrefetcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
