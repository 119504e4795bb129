"""The program's own spans over the window, for the per-layer metrics that
need intervals (the run dict holds only totals): pisces_tpu_torch's
registry (utils/metrics) keeps each stage's start, end, thread, parent and
sample in a buffer, and the window's samples are its last `sample` spans
(the warm-up's come before them)."""

# spans that hold other stages rather than being a step of their own
CONTAINERS = ("sample", "scheduler.job", "window")


def window_spans(run):
    """(the window's `sample` spans, every span of those samples), or None
    where the program keeps no spans or its buffer holds fewer samples than
    the window ran."""
    from pisces_tpu_torch.utils.metrics import metrics
    get = getattr(metrics, "spans", None)
    n = run["samples"]
    if get is None or n <= 0:
        return None
    spans = get()
    samples = [s for s in spans if s.name == "sample"]
    if len(samples) < n:
        return None
    samples = samples[-n:]
    ids = {s.id for s in samples}
    return samples, [s for s in spans if s.sample in ids]


def union_s(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
