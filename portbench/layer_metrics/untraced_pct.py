"""CLI and sample: the share of the window's `sample` wall time in which
no stage span of that sample is open on any thread (the program's spans;
`sample`, `scheduler.job` and `window` hold stages and count as none), in
percent."""

from portbench.program_spans import CONTAINERS, union_s, window_spans


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    samples, spans = got
    wall = sum(s.end - s.start for s in samples)
    if wall <= 0:
        return None
    covered = 0.0
    for smp in samples:
        covered += union_s([(max(s.start, smp.start), min(s.end, smp.end))
                            for s in spans
                            if s.sample == smp.id
                            and s.name not in CONTAINERS])
    return 100.0 * (1.0 - covered / wall)
