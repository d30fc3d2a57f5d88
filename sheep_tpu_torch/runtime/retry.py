"""Retry-with-backoff for device dispatches, with adaptive shrinking (port
of sheep_tpu/runtime/retry.py; the watchdog syncs on a CUDA event where
the reference blocks on jax's outputs).

The chunk drivers' unit of failure is one bounded dispatch (a
``fixpoint_chunk`` call).  A dispatch that faults under a per-execution
budget does so because its wall time outgrew it — and since wall time
scales with the per-dispatch round count, the right retry is not "same
thing again" but SHRINK: halve ``jrounds`` before re-dispatching, so a
dispatch that tripped the budget asks for half the work next time.
Progress already made is never lost (dispatches are functional — the
inputs are intact after a fault), and a 1-round dispatch is the minimum
quantum, so shrinking terminates.

Exponential backoff between attempts covers the transient-infrastructure
case: sleeping ``base * 2^attempt`` capped at ``cap``.  A watchdog
(optional) bounds how long a HUNG dispatch can stall the build: the
attempt and its sync run on a helper thread and a timeout classifies the
dispatch as faulted (:class:`DeadlineExceeded`, retryable).  On the card
the timed-out work stays queued on its stream, where nothing can abandon
it and a retry would queue behind it: that timeout is
:class:`DeviceHung`, which gives the rung up to the ladder at once.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from .faults import (DeadlineExceeded, DeviceHung, RetryBudgetExhausted,
                     fault_point, is_retryable)


@dataclass
class RetryPolicy:
    """Knobs for one build's dispatch retries (env: SHEEP_MAX_RETRIES /
    SHEEP_BACKOFF_BASE / SHEEP_WATCHDOG_S)."""

    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    shrink: bool = True
    watchdog_s: float | None = None
    # injectable for tests (no real sleeping in the suite)
    sleep: Callable[[float], None] = field(default=time.sleep)

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_base_s * (2 ** attempt), self.backoff_cap_s)


def _cuda_tensors(out):
    """The CUDA tensors among a dispatch's outputs (tensors, nested in
    tuples, lists or dict values)."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_cuda else []
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _cuda_tensors(x)]
    if isinstance(out, dict):
        return [t for x in out.values() for t in _cuda_tensors(x)]
    return []


def sync_outputs(out) -> bool:
    """Wait until a dispatch's outputs are ready: record one CUDA event on
    the current stream of each device its CUDA outputs live on, then
    ``synchronize()`` it (an asynchronous fault surfaces here, inside the
    attempt).  Returns whether there was CUDA work to wait for; CPU
    tensors are ready when the dispatch returns."""
    devices = {t.device for t in _cuda_tensors(out)}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return bool(devices)


def _caller_stream():
    """The calling thread's current CUDA stream, or None when this
    process has not initialised CUDA (then no dispatch can queue on the
    card, and none is initialised here)."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream()


def call_with_watchdog(fn, j, timeout_s: float | None):
    """``fn(j)`` + a sync of its outputs under a deadline (None =
    unbounded).

    The whole attempt runs on a helper thread: dispatch itself can block
    too (a wedged host step), not just the result wait.  torch's current
    stream is per thread, so the helper enqueues on the CALLER's current
    stream (captured here, entered there): the attempt's kernels order
    with everything the caller queued before it, and a caller that runs
    on a side stream keeps it.  On timeout the attempt is classified as
    a retryable :class:`DeadlineExceeded`; when its outputs were already
    queued on a CUDA stream (the hang is on the card), as
    :class:`DeviceHung`.
    """
    if timeout_s is None:
        out = fn(j)
        sync_outputs(out)
        return out
    stream = _caller_stream()
    done = threading.Event()
    result: dict = {}

    def attempt():
        try:
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext():
                out = fn(j)
                result["cuda"] = bool(_cuda_tensors(out))
                sync_outputs(out)
            result["out"] = out
        except BaseException as exc:  # surfaced on the caller thread
            result["err"] = exc
        finally:
            done.set()

    t = threading.Thread(target=attempt, daemon=True)
    t.start()
    if not done.wait(timeout_s):
        if result.get("cuda"):
            raise DeviceHung(
                f"dispatch still not ready after {timeout_s}s watchdog; "
                f"its CUDA work stays queued on the stream")
        raise DeadlineExceeded(
            f"dispatch still not ready after {timeout_s}s watchdog")
    if "err" in result:
        raise result["err"]
    return result["out"]


def run_with_retry(policy: RetryPolicy, site: str,
                   fn: Callable, j: int | None,
                   on_retry: Callable[[str, int, int | None], None]
                   | None = None):
    """Run ``fn(j)`` (a dispatch returning device outputs), blocking until
    ready; on a retryable failure, back off, halve ``j`` (when shrinking
    applies and ``j`` is not None), and retry up to the budget — except
    after :class:`DeviceHung`, which spends the budget at once.

    Each ATTEMPT passes through :func:`faults.fault_point` under ``site``
    — that is the deterministic injection hook.  Returns
    ``(outputs, j_used)``.  Raises :class:`RetryBudgetExhausted` once the
    budget is spent (the degradation ladder's cue), and re-raises
    non-retryable exceptions (including BuildKilled) untouched.
    """
    attempt = 0
    while True:
        try:
            fault_point(site)
            return call_with_watchdog(fn, j, policy.watchdog_s), j
        except BaseException as exc:
            if not is_retryable(exc):
                raise
            if attempt >= policy.max_retries or isinstance(exc, DeviceHung):
                raise RetryBudgetExhausted(
                    f"{site}: {attempt + 1} attempts all faulted "
                    f"(last: {type(exc).__name__}: {exc})") from exc
            policy.sleep(policy.backoff(attempt))
            if policy.shrink and j is not None:
                j = max(1, j // 2)
            attempt += 1
            if on_retry is not None:
                on_retry(site, attempt, j)
