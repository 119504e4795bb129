"""Caller: the program's `allele_calling` stage microseconds (summed over
threads) per candidate it scored (counter `candidates_scored`)."""


def read(run):
    s = run["stages"].get("allele_calling")
    n = run["counters"].get("candidates_scored", 0)
    if s is None or n <= 0:
        return None
    return s * 1e6 / n
