"""Caller, step `filters` (the per-allele filters, then the callable, report
and forced pass): the program's `allele_calling.filters` stage microseconds
(summed over threads) per candidate it scored (counter `candidates_scored`).
The five `allele_calling.*` stages tile `AlleleCaller.call`."""


def read(run):
    s = run["stages"].get("allele_calling.filters")
    n = run["counters"].get("candidates_scored", 0)
    if s is None or n <= 0:
        return None
    return s * 1e6 / n
