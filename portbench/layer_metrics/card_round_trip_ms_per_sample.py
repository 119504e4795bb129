"""Card round trips: the program's `card_round_trip` stage milliseconds
(copy in, launch, copy back: the caller's Q batches and the gVCF's
`score_tuples` batches; summed over threads) per sample of the window."""


def read(run):
    s = run["stages"].get("card_round_trip")
    if s is None or run["samples"] <= 0:
        return None
    return s * 1e3 / run["samples"]
