"""Scheduler and windows: the thread CPU seconds of the window's
`scheduler.job` and `window` spans (the program's spans; a span inside
another of them counts once, in the outer one) over the wall-time union
of those spans, in cores: 1.0 where the threads ran one at a time."""

from portbench.program_spans import union_s, window_spans

WORKERS = ("scheduler.job", "window")


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    _samples, spans = got
    by_id = {s.id: s for s in spans}
    ids = {s.id for s in spans if s.name in WORKERS}

    def inside_another(s):
        p = s.parent
        while p is not None and p in by_id:
            if p in ids:
                return True
            p = by_id[p].parent
        return False

    outer = [s for s in spans if s.id in ids and not inside_another(s)]
    wall = union_s([(s.start, s.end) for s in outer])
    if wall <= 0 or any(s.cpu_s is None for s in outer):
        return None
    return sum(s.cpu_s for s in outer) / wall
