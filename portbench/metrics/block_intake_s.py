"""block_intake_s: seconds of an out-of-core build that the program's
timers leave out: the build's time less its block loop
(``block_loop_s``), its final loop (``loop_s``) and its tail
(``fetch_tail_s``).  That is, for each block, its host padding and
upload (``ops/stream.py`` ``_padded_block``) and its link extraction
(``_block_links``), and once a build the position table and the pst
fetch.  Averaged over the traced builds."""

PARTS = ("block_loop_s", "loop_s", "fetch_tail_s")


def read(run):
    vals = [b.end - b.start - sum(b.perf[k] for k in PARTS)
            for b in run.builds
            if b.perf is not None and all(k in b.perf for k in PARTS)]
    return sum(vals) / len(vals) if vals else None
