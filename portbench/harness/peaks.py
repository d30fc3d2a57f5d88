"""The card's peaks and the least work of kernel K1.

The rate is NVIDIA's data sheet figure for the H100 SXM at its 700 W
limit; a card set below that limit runs slower, so a share is stated
with the card's power limit beside it.  K1's terms are those of
``chip_smoke.k1_bound_ms``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet


def k1_bytes(links: int, levels: int, width: int) -> int:
    """The least bytes one descent moves, however many launches it is
    split into: lo and hi read and out written once (12 bytes a link),
    and each of its ``levels`` tables of ``width`` int32 entries read
    once."""
    return 12 * links + 4 * levels * width


def k1_bound_s(links: int, levels: int, width: int) -> float:
    """The least time of one descent at the card's memory rate."""
    return k1_bytes(links, levels, width) / HBM_BYTES_PER_S
