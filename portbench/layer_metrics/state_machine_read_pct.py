"""Candidates: the share of the window's reads that the per-read candidate
state machine walked (the program's counter `reads_state_machine`), in
percent; 0 where every read takes the columnar route. None where the
program keeps no such counter."""


def read(run):
    n = run["counters"].get("reads_state_machine")
    if n is None or run["reads"] <= 0:
        return None
    return 100.0 * n / run["reads"]
