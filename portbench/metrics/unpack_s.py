"""unpack_s: host seconds of a build's handoff unpacking its fetched
slices into link arrays (the spans ``handoff.unpack`` of ``ops/build.py``
``_StreamFetcher._unpack``, summed in ``perf["unpack_s"]``), averaged
over the traced builds."""


def read(run):
    return run.perf_mean("unpack_s")
