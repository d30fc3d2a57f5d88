"""block_upload_s: host seconds of an out-of-core build copying its
padded blocks to the card (the spans ``stream.upload`` of ``ops/stream.py``
``_padded_block``, summed in ``perf["block_upload_s"]``), averaged over
the traced builds."""


def read(run):
    return run.perf_mean("block_upload_s")
