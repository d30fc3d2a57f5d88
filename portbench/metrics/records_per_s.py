"""records_per_s: all records of all whole builds of the window over the
time from the first build's start to the last build's end (host clock;
each build ends with its answer in host memory)."""


def read(run):
    if not run.builds:
        return None
    span = run.builds[-1].end - run.builds[0].start
    return run.records * len(run.builds) / span
