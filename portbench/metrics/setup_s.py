"""setup_s: process start to the first timed build (imports, CUDA init,
the program's libraries, the graph made on the card and copied to the
host, the traffic's own preparation, one warm-up build)."""


def read(run):
    return run.setup_s
