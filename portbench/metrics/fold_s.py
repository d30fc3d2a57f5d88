"""fold_s: seconds of a build's native fold in the handoff
(``perf["fold_s"]`` of ``ops/build.py``), averaged over the traced builds."""


def read(run):
    return run.perf_mean("fold_s")
