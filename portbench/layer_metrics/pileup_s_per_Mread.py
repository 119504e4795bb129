"""Native pileup: the program's `pileup` stage seconds (summed over
threads) per million reads of the window."""


def read(run):
    s = run["stages"].get("pileup")
    if s is None or run["reads"] <= 0:
        return None
    return s / (run["reads"] / 1e6)
