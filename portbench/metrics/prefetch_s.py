"""prefetch_s: seconds of the host prefetch thread a build starts
(native degree sort, numpy pst pass; ``perf["prefetch_s"]`` of
``ops/build.py``), averaged over the traced builds."""


def read(run):
    return run.perf_mean("prefetch_s")
