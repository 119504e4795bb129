"""Stitched directions: the program's `xd_directions` stage seconds (the
XD per-base direction column built for a stitched batch, summed over
threads) per million reads of the window."""


def read(run):
    s = run["stages"].get("xd_directions")
    if s is None or run["reads"] <= 0:
        return None
    return s / (run["reads"] / 1e6)
