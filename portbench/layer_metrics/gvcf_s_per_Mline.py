"""gVCF: the program's `gvcf_scoring` and `gvcf_formatting` stage seconds
(summed over threads) per million reference lines scored (counter
`loci_scored`)."""


def read(run):
    stages = run["stages"]
    n = run["counters"].get("loci_scored", 0)
    if n <= 0 or ("gvcf_scoring" not in stages
                  and "gvcf_formatting" not in stages):
        return None
    s = stages.get("gvcf_scoring", 0.0) + stages.get("gvcf_formatting", 0.0)
    return s / (n / 1e6)
