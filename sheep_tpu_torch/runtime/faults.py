"""Deterministic fault injection + the runtime's exception taxonomy (port
of sheep_tpu/runtime/faults.py; :func:`is_retryable` classifies torch's
CUDA errors where the reference classifies XLA's, and
:func:`degradable` keeps a kernel fault on the card from being finished
on the host).

Every recovery path in the fault-tolerant build runtime
(sheep_tpu_torch.runtime) must be testable on CPU, where real dispatch
faults never happen.  This module provides the hook: the chunk drivers
call :func:`fault_point` at every dispatch attempt and every
checkpointed chunk boundary, and an installed :class:`FaultPlan`
(monkeypatchable via :func:`install_plan`, or env-configured via
``SHEEP_FAULT_INJECT``) kills exactly the k-th call at a named site.
Sites are counted per build (:func:`reset_counters`), so "kill dispatch
3" means the same dispatch on every run — which is what makes the
kill-at-every-chunk-boundary resume property test possible.

Fault kinds model the three real failure shapes of a device dispatch:

  xla       a faulted dispatch — retryable, surfaces as
            :class:`InjectedDispatchFault`, classified together with the
            card's real faults (torch.cuda.OutOfMemoryError, CUDA runtime
            and driver errors).  The name is the reference's, so a
            ``SHEEP_FAULT_INJECT`` spec means the same on both.
  deadline  a hung dispatch caught by the watchdog — retryable.
  kill      SIGKILL / OOM-killer: the process dies mid-build.  Raised as
            :class:`BuildKilled`, which nothing in the runtime catches —
            recovery is a NEW process resuming from the checkpoint.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..resources.errors import MemoryBudgetExceeded


class InjectedDispatchFault(RuntimeError):
    """A deliberately faulted device dispatch (kind="xla")."""


class DeadlineExceeded(RuntimeError):
    """A dispatch exceeded the watchdog budget (real or injected)."""


class DeviceHung(DeadlineExceeded):
    """The watchdog expired while the dispatch's work was queued on a CUDA
    stream.  A kernel on a stream cannot be abandoned the way JAX
    abandons a timed-out execution to its backend, and a retry on that
    stream would queue behind it, so the retry wrapper gives the rung up
    at once (:class:`RetryBudgetExhausted`) and the ladder degrades to a
    host rung, which touches the card no more."""


class BuildKilled(RuntimeError):
    """Simulated process death (kind="kill").  Never caught by the retry
    wrapper or the degradation ladder: tests catch it at top level and
    then resume from the checkpoint, exactly like a restarted process."""


class RetryBudgetExhausted(RuntimeError):
    """A dispatch site kept faulting past the retry budget; the ladder
    degrades to the next rung on this when the last attempt's fault is
    :func:`degradable`, and the build fails with it otherwise."""


@dataclass
class FaultPlan:
    """Kill the ``at``-th (0-based) matching call — and the ``times - 1``
    following matching calls — at ``site``.

    ``site``: comma-separated site names, or "*" for every site.
    ``times``: -1 means "every matching call from ``at`` on" (used to force
    a rung to exhaust its retry budget and trigger ladder degradation).
    """

    site: str
    at: int
    kind: str = "xla"
    times: int = 1

    def matches(self, site: str, index: int) -> bool:
        if self.site != "*" and site not in self.site.split(","):
            return False
        if index < self.at:
            return False
        return self.times < 0 or index < self.at + self.times

    def raise_fault(self, site: str, index: int) -> None:
        msg = f"injected {self.kind} fault at {site}[{index}]"
        if self.kind == "kill":
            raise BuildKilled(msg)
        if self.kind == "deadline":
            raise DeadlineExceeded(msg)
        raise InjectedDispatchFault(msg)


_plan: FaultPlan | None = None
_counters: dict[str, int] = {}


def install_plan(plan: FaultPlan | None) -> None:
    """Install (or with None, clear) the active fault plan."""
    global _plan
    _plan = plan


def clear_plan() -> None:
    install_plan(None)


def active_plan() -> FaultPlan | None:
    """The installed plan, falling back to ``SHEEP_FAULT_INJECT`` —
    format ``site:at[:kind[:times]]``, e.g. ``chunk:3:xla:2`` or
    ``boundary:1:kill``."""
    if _plan is not None:
        return _plan
    spec = os.environ.get("SHEEP_FAULT_INJECT", "")
    if not spec:
        return None
    return parse_plan(spec)


def parse_plan(spec: str) -> FaultPlan:
    parts = spec.split(":")
    if len(parts) < 2:
        raise ValueError(
            f"SHEEP_FAULT_INJECT={spec!r}: want site:at[:kind[:times]]")
    site, at = parts[0], int(parts[1])
    kind = parts[2] if len(parts) > 2 else "xla"
    times = int(parts[3]) if len(parts) > 3 else 1
    if kind not in ("xla", "deadline", "kill"):
        raise ValueError(f"unknown fault kind {kind!r}")
    return FaultPlan(site=site, at=at, kind=kind, times=times)


def reset_counters() -> None:
    """Start a fresh build: site indices count from 0 again."""
    _counters.clear()


def fault_count(site: str) -> int:
    """How many times ``site`` has fired since the last reset."""
    return _counters.get(site, 0)


def fault_point(site: str) -> int:
    """Record one call at ``site`` and raise if the active plan kills it.
    Returns this call's 0-based index (useful for logging)."""
    index = _counters.get(site, 0)
    _counters[site] = index + 1
    plan = active_plan()
    if plan is not None and plan.matches(site, index):
        from ..obs import trace as obs
        obs.event("fault", site=site, index=index, kind=plan.kind)
        plan.raise_fault(site, index)
    return index


#: how the CUDA runtime (cudaGetErrorString through C10_CUDA_CHECK) and
#: driver (CUresult through C10_CUDA_DRIVER_CHECK) errors that torch
#: raises as a plain RuntimeError begin
CUDA_ERROR_PREFIXES = ("CUDA error:", "CUDA driver error:")


def is_retryable(exc: BaseException) -> bool:
    """Classify a dispatch failure: True = retry/degrade territory, False =
    programming error or simulated process death (propagate).

    Retryable: the injected faults, ``torch.cuda.OutOfMemoryError``,
    ``torch.AcceleratorError`` (where this torch has it: an asynchronous
    CUDA fault such as an illegal address), and a ``RuntimeError`` whose
    message begins with the CUDA runtime's or driver's error prefix.
    Every other exception propagates, as the reference lets every
    non-XLA error propagate: a programming error is never retried into a
    degrade.
    """
    if isinstance(exc, BuildKilled):
        return False
    if isinstance(exc, (InjectedDispatchFault, DeadlineExceeded)):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) \
        and str(exc).startswith(CUDA_ERROR_PREFIXES)


def degradable(exc: BaseException) -> bool:
    """Whether the ladder may give a failed rung up to the next one.

    True for the failures a cheaper rung is the recovery from: an
    injected fault, a watchdog deadline (:class:`DeviceHung` included),
    and memory exhaustion, the host's (``MemoryError``,
    ``MemoryBudgetExceeded``) or the card's
    (``torch.cuda.OutOfMemoryError``).  A spent retry budget is judged by
    its last attempt's fault (its ``__cause__``).  A kernel fault on the
    card (``torch.AcceleratorError``, a CUDA runtime or driver error) is
    retried on its rung, but once the budget is spent it fails the build:
    work that was on the card is never finished on the host in its
    place.
    """
    if isinstance(exc, RetryBudgetExhausted) and exc.__cause__ is not None:
        exc = exc.__cause__
    return isinstance(exc, (RetryBudgetExhausted, InjectedDispatchFault,
                            DeadlineExceeded, MemoryError,
                            MemoryBudgetExceeded,
                            torch.cuda.OutOfMemoryError))
