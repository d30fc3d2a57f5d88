"""prefetch_seq_s: seconds of the host prefetch's native degree sort
(span ``build.prefetch.seq`` in ``ops/build.py`` ``_host_seq_pst``,
``perf["prefetch_seq_s"]``), averaged over the traced builds."""


def read(run):
    return run.perf_mean("prefetch_seq_s")
