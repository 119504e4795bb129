"""Caller, step `scoring` (Q (on the card for batches of 4096 or more),
strand bias and the per-allele attributes): the program's
`allele_calling.scoring` stage microseconds (summed over threads) per
candidate it scored (counter `candidates_scored`). The five
`allele_calling.*` stages tile `AlleleCaller.call`."""


def read(run):
    s = run["stages"].get("allele_calling.scoring")
    n = run["counters"].get("candidates_scored", 0)
    if s is None or n <= 0:
        return None
    return s * 1e6 / n
