"""Native pileup: the slabs a pass of the C++ pileup ran in, averaged over
the window's passes (the program's counters `pileup_slabs` over
`pileup_passes`); above 1 where the passes split across threads. None where
the program keeps no such counters or ran no pass in the window."""


def read(run):
    slabs = run["counters"].get("pileup_slabs")
    passes = run["counters"].get("pileup_passes")
    if slabs is None or not passes:
        return None
    return slabs / passes
