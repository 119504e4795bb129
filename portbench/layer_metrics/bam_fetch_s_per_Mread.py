"""BAM decode: the program's `bam_fetch` stage seconds (summed over
threads) per million reads of the window."""


def read(run):
    s = run["stages"].get("bam_fetch")
    if s is None or run["reads"] <= 0:
        return None
    return s / (run["reads"] / 1e6)
