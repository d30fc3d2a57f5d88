"""block_loop_s: seconds of an out-of-core build's block loop
(``perf["block_loop_s"]`` of ``ops/stream.py``), averaged over the
traced builds."""


def read(run):
    return run.perf_mean("block_loop_s")
