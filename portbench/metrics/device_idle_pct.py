"""device_idle_pct: the share of the traced builds' wall time in which
no kernel, copy or set ran on the card, x 100 (``torch.profiler``)."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
