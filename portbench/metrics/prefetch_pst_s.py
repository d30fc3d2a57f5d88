"""prefetch_pst_s: seconds of the host prefetch's numpy pst pass (span
``build.prefetch.pst`` in ``ops/build.py`` ``_host_seq_pst``,
``perf["prefetch_pst_s"]``), averaged over the traced builds."""


def read(run):
    return run.perf_mean("prefetch_pst_s")
