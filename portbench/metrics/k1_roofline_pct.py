"""k1_roofline_pct: the least time of the traced builds' K1 descents
(``harness.peaks``: 12 bytes a link and 4 a table entry a level, at the
card's data-sheet memory rate) over K1's device time in them, x 100."""

from harness.peaks import k1_bound_s


def read(run):
    if run.k1 is None or not run.k1.descents:
        return None
    device_s = run.k1_device_s()
    if not device_s:
        return None
    bound = sum(k1_bound_s(*d) for d in run.k1.descents)
    return 100.0 * bound / device_s
