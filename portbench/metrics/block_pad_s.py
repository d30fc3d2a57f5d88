"""block_pad_s: host seconds of an out-of-core build padding its blocks
(the spans ``stream.pad`` of ``ops/stream.py`` ``_padded_block``, summed
in ``perf["block_pad_s"]``), averaged over the traced builds."""


def read(run):
    return run.perf_mean("block_pad_s")
