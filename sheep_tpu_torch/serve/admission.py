"""Admission control: the daemon sheds load instead of dying under it.

Two pressure signals, two degradations, both typed:

  slots    at most ``max_inflight`` requests execute at once; past that,
           new work is REFUSED with a typed overload error, not queued
           into an unbounded backlog (queueing is the client's job — a
           refusal tells it so honestly).  Inserts shed FIRST: they stop
           being admitted at half the slot budget (``insert_watermark``),
           so a burst degrades write availability before read
           availability — the partition service's whole job is answering
           part(v).
  memory   once measured RSS crosses the soft fraction of
           ``SHEEP_MEM_BUDGET`` (resources/governor.py — the same signal
           the chunk drivers shrink under), the service degrades to
           READ-ONLY: inserts are refused with a typed readonly error
           (they grow the resident state; queries do not), and recovers
           automatically when pressure clears.  Dying was the
           alternative; the OOM killer does not send "ERR".

Refusals are exceptions (``Overloaded`` / ``ReadOnly``) so the protocol
layer maps them to one-line typed errors and nothing anywhere interprets
a shed request as success.
"""

from __future__ import annotations

import contextlib
import threading

from ..resources.governor import ResourceGovernor


class AdmissionRefused(Exception):
    """Base of every admission refusal; ``code`` is the protocol error
    token the client sees."""

    code = "refused"


class Overloaded(AdmissionRefused):
    code = "overload"


class ReadOnly(AdmissionRefused):
    code = "readonly"


class AdmissionController:
    """Slot accounting + memory-pressure policy for one daemon."""

    def __init__(self, max_inflight: int = 64,
                 governor: ResourceGovernor | None = None,
                 read_only: bool = False):
        if max_inflight < 1:
            raise ValueError(f"max_inflight {max_inflight} must be >= 1")
        self.max_inflight = max_inflight
        #: inserts stop being admitted here — queries get the other half
        self.insert_watermark = max(1, max_inflight // 2)
        self.governor = governor if governor is not None \
            else ResourceGovernor.from_env()
        self.read_only = read_only
        self._inflight = 0
        self._lock = threading.Lock()
        self.shed = 0
        self.readonly_refusals = 0

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def _enter(self, kind: str) -> None:
        if kind == "insert":
            if self.read_only:
                self.readonly_refusals += 1
                raise ReadOnly("service is read-only")
            if self.governor.mem_pressure():
                self.readonly_refusals += 1
                raise ReadOnly(
                    "memory pressure: service degraded to read-only "
                    "(rss past the SHEEP_MEM_BUDGET soft threshold); "
                    "retry when pressure clears")
        with self._lock:
            limit = (self.insert_watermark if kind == "insert"
                     else self.max_inflight)
            if self._inflight >= limit:
                self.shed += 1
                raise Overloaded(
                    f"{self._inflight} requests in flight (limit {limit} "
                    f"for {kind}); shedding - retry with backoff")
            self._inflight += 1

    def _exit(self) -> None:
        with self._lock:
            self._inflight -= 1

    @contextlib.contextmanager
    def admit(self, kind: str):
        """Hold one request slot for the duration of its handling (kind:
        "query" or "insert").  Raises Overloaded/ReadOnly instead of
        entering."""
        self._enter(kind)
        try:
            yield
        finally:
            self._exit()
