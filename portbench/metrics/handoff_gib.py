"""handoff_gib: GiB that a build's handoff copies off the card, 6 bytes a
link fetched where the links pack (vid slots under 2^24) and 8 where
they do not, as the program counts them (``ops.build.handoff_bytes``,
``perf["handoff_bytes"]``, the attribute ``bytes`` of ``handoff.tail``),
averaged over the traced builds."""


def read(run):
    got = run.perf_mean("handoff_bytes")
    return got / 2**30 if got else None
