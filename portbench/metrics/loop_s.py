"""loop_s: seconds of a build's device reduce loop down to the handoff
(``perf["loop_s"]`` of ``ops/build.py``; in the out-of-core build, the
final carry's loop), averaged over the traced builds."""


def read(run):
    return run.perf_mean("loop_s")
