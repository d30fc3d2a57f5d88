"""fetch_tail_s: seconds of a build's whole tail after the device reduce
loop: the handoff's fetch, the wait on the host prefetch where there is
one, and the native fold, less their overlap (``perf["fetch_tail_s"]``
of ``ops/build.py``), averaged over the traced builds."""


def read(run):
    return run.perf_mean("fetch_tail_s")
