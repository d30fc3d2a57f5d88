"""The comparison that decides ``correct``: every build of the window
against the plain reference, array by array.

The entry names the numbers compared and their limits (its ``LIMITS``):
``<array>_diff`` counts the entries of that answer array that differ
from the reference's, taken over the worst build.  A build that raised
is wrong: ``builds_failed`` has the limit 0 in every cell.
"""

from __future__ import annotations

import numpy as np


def diff_count(got, want: np.ndarray) -> int:
    """Entries of ``got`` that differ from ``want``; a missing array or
    one of another length differs in every entry it lacks or adds."""
    if got is None:
        return len(want)
    got = np.asarray(got)
    k = min(len(got), len(want))
    return int(np.count_nonzero(got[:k] != want[:k])) \
        + abs(len(got) - len(want))


def compare(outputs: list, failed: int, want: dict, limits: dict) -> dict:
    """``outputs``: the builds' answers; ``want``: the reference's;
    ``limits``: the entry's ``{"<array>_diff": limit}``.  Returns
    {name: (value, limit)}."""
    got = {}
    for name, limit in limits.items():
        key = name.removesuffix("_diff")
        worst = max((diff_count(out.get(key), want[key]) for out in outputs),
                    default=0)
        got[name] = (worst, limit)
    got["builds_failed"] = (failed, 0)
    return got


def passes(numbers: dict, builds: int) -> bool:
    return builds > 0 and all(v <= lim for v, lim in numbers.values())
