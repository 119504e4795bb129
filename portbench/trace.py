"""The traced run: the benchmark's own spans and the profiler's device view.

Spans: in a `--trace 1` run the benchmark wraps its calls into each layer
of the program (the module attributes below) and records each call's
start and end on the host clock, on whatever thread it runs (the
profiler's own host ranges are thread-local, and the scheduler runs
chromosomes on worker threads), so the host stage open during each idle
gap of the card can be named. The program itself is not edited; its own
stage totals (utils/metrics) are read beside these.

Device view: one torch.profiler session over the window that records the
card's activity alone (recording every host operation would slow the host
layers the window measures); a short device operation marks the window's
start. From its events, the union of device intervals (kernels, copies,
sets) inside the window is busy_s, each device operation's total
time feeds the breakdown, and the gaps between busy intervals are the idle
gaps.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional, Tuple

# device operation names are cut to this many characters (templated
# kernels' names run to hundreds)
NAME_CHARS = 120
# the kernel of torch.cuda._sleep, which run.mark_device launches to mark
# the window's start; the program launches none
MARK = "spin_kernel"
# (module, attribute, span): the layers' entry points the window reaches
SPAN_TARGETS = (
    ("pisces_tpu_torch.apps.pisces", "call_chromosome", "call_chromosome"),
    ("pisces_tpu_torch.apps.pisces", "find_indel_candidates", "candidates"),
    ("pisces_tpu_torch.apps.pisces", "aggregate_native_mismatches",
     "candidates"),
    ("pisces_tpu_torch.apps.pisces", "native_pileup", "pileup"),
    ("pisces_tpu_torch.apps.pisces", "write_spliced", "vcf_write"),
    ("pisces_tpu_torch.calling.fast_gvcf", "score_reference_positions",
     "gvcf_scoring"),
    ("pisces_tpu_torch.calling.fast_gvcf", "format_reference_lines",
     "gvcf_formatting"),
    ("pisces_tpu_torch.calling.caller:AlleleCaller", "call", "allele_calling"),
    ("pisces_tpu_torch.io.native:NativeBamReader", "fetch", "bam_fetch"),
    ("pisces_tpu_torch.io.native:NativeBamReader", "fetch_region",
     "bam_fetch"),
)


def _owner(path: str):
    import importlib
    mod, _, cls = path.partition(":")
    obj = importlib.import_module(mod)
    return getattr(obj, cls) if cls else obj


@contextlib.contextmanager
def layer_spans():
    """Wrap each SPAN_TARGETS entry for the duration of the block; yields
    the list that collects (span, start s, end s) on time.perf_counter."""
    spans: List[Tuple[str, float, float]] = []
    saved = []
    try:
        for path, attr, span in SPAN_TARGETS:
            owner = _owner(path)
            fn = getattr(owner, attr)

            def wrap(fn=fn, label=span):
                @functools.wraps(fn)
                def inner(*a, **k):
                    t0 = time.perf_counter()
                    try:
                        return fn(*a, **k)
                    finally:
                        spans.append((label, t0, time.perf_counter()))
                return inner
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap())
        yield spans
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_view(events, spans, host_ends, marked: bool) -> Optional[dict]:
    """From profiler FunctionEvents: window_s, busy_s, per-op device
    seconds, idle gaps labelled by the host span covering most of each,
    and each operation's device seconds and count. Where `marked`, the
    trace's first device operation is the MARK launched at the host
    clock's reading `host_ends[0]`, and the window lasts as long on the
    trace's clock as on the host's (a trace may lose its last events, so
    nothing at its end is relied on); without a card the trace has no
    device operations and the window is the host's. `spans` are
    layer_spans()'s on the host clock. None where the mark is missing."""
    device = []
    for e in events:
        if getattr(e.device_type, "name", str(e.device_type)) == "CUDA":
            tr = e.time_range
            device.append((e.name[:NAME_CHARS], tr.start, tr.end))
    h0, h1 = host_ends
    device.sort(key=lambda d: d[1])
    if marked and not (device and MARK in device[0][0]):
        return None
    w0 = device[0][1] if marked else 0.0
    w1 = w0 + (h1 - h0) * 1e6
    device = [d for d in device if MARK not in d[0]]
    # host clock (s) to the trace's clock (us), anchored at the window start
    host = [(n, w0 + (s - h0) * 1e6, w0 + (e - h0) * 1e6)
            for n, s, e in spans]
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device
               if e > w0 and s < w1]
    busy = _merge([(s, e) for _n, s, e in clipped])
    busy_us = sum(e - s for s, e in busy)
    per_op: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for n, s, e in clipped:
        per_op[n] = per_op.get(n, 0.0) + (e - s) / 1e6
        counts[n] = counts.get(n, 0) + 1
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    labelled = []
    for g0, g1 in gaps:
        # the stage with the most host time inside the gap (summed over
        # threads); call_chromosome only where no stage inside it overlaps;
        # "host" where the program was in none of the spans
        overlap: Dict[str, float] = {}
        for name, s, e in host:
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                overlap[name] = overlap.get(name, 0.0) + ov
        inner = {k: v for k, v in overlap.items() if k != "call_chromosome"}
        pick = inner or overlap
        best = max(pick, key=pick.get) if pick else "host"
        labelled.append((best, (g1 - g0) / 1e6))
    labelled.sort(key=lambda x: -x[1])
    ops = sorted(per_op.items(), key=lambda x: -x[1])
    return {"window_s": h1 - h0,
            "last_device_s": (max(e for _n, _s, e in clipped) - w0) / 1e6
            if clipped else 0.0,
            "busy_s": busy_us / 1e6, "n_device": len(clipped),
            "device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in labelled[:10]],
            "op_seconds": per_op, "op_counts": counts}
