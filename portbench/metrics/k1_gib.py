"""k1_gib: GiB that kernel K1's descents of a build need at least (12
bytes a link, 4 a table entry a level), as the program counts them
(``ops.forest.k1_bytes``, the attribute ``bytes`` of each ``forest.k1``
span; ``perf["k1_bytes"]``), averaged over the traced builds."""


def read(run):
    got = run.perf_mean("k1_bytes")
    return got / 2**30 if got else None
