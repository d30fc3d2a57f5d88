"""peak_device_gib: the largest ``torch.cuda.max_memory_allocated()`` of
any build of the window, each measured from a reset of the peak."""


def read(run):
    peaks = [b.peak_bytes for b in run.builds if b.peak_bytes is not None]
    return max(peaks) / 2**30 if peaks else None
