"""pst_wait_s: seconds the tail of a build waits on the host prefetch
(``perf["pst_wait_s"]`` of ``ops/build.py``), averaged over the traced
builds."""


def read(run):
    return run.perf_mean("pst_wait_s")
