"""CLI and sample: all reads of the window over all of its wall time, the
quantity of the end-to-end reads_per_s, in the cells whose runs spread it
too widely to hold it to a bound end to end (read from the traced run)."""


def read(run):
    if run["window_s"] <= 0 or run["reads"] <= 0:
        return None
    return run["reads"] / run["window_s"]
