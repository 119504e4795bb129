"""BAM decode: the program's `bam_open` stage seconds (the whole file
inflated at a native reader's open, summed over threads) per million
reads of the window."""


def read(run):
    s = run["stages"].get("bam_open")
    if s is None or run["reads"] <= 0:
        return None
    return s / (run["reads"] / 1e6)
