"""Structured tracing / step metrics.

The reference's observability is minimal (SURVEY §5: Benchmark wall-clock,
peak memory at exit, per-(bam,chr) elapsed seconds). The rebuild adds the
subsystem SURVEY §5 calls for: named stages, each a span with a start, an
end, a thread, a parent and a sample, totalled by name; counters; the
seconds the interpreter's collections paused the process; the peak device
memory that torch allocated; and an optional torch.profiler trace that
holds the spans beside the profiler's own events — all behind a
process-global registry so hot paths pay two perf_counter calls per scope.

Spans are always recorded, into a buffer of fixed capacity (the oldest goes
first), so stages stay coarse: a chromosome, a window, a step of the
caller, never a read, a candidate or a locus. A span's parent is the span
open on its thread when it opened; work handed to another thread takes the
span open where it was handed over (Metrics.carry). The root span of one
apps/pisces.main call is `sample`; every span under it carries its id.

Usage:
    from pisces_tpu_torch.utils.metrics import metrics
    with metrics.stage("pileup"):
        ...
    pool.submit(metrics.carry(job))     # the job's spans nest under here
    metrics.count("reads", n)
    metrics.device_watermark(device)    # record peak device memory
    metrics.spans()                     # the buffer's closed spans
    metrics.report()                    # log a summary table
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from pisces_tpu_torch.utils.logger import log

# closed spans the buffer holds; a sample records a few dozen
SPAN_CAPACITY = 16384
# the trace's process row for the spans: above Linux's largest pid, so no
# row of the profiler's shares it
SPAN_PID = 1 << 22


class Span(NamedTuple):
    """One stage's interval on time.perf_counter (end None while it is
    open). `thread` is the native thread id (the profiler's thread tracks
    use it too); `parent` the id of the span open on the thread, or handed
    over to it, when it opened (None at a root); `sample` the id of the
    `sample` span it runs under (None outside any); `cpu_s` the thread's
    CPU seconds inside it, where the stage asked for them
    (time.thread_time)."""
    name: str
    start: float
    end: float
    thread: int
    id: int
    parent: Optional[int]
    sample: Optional[int]
    cpu_s: Optional[float]


class _Stage:
    __slots__ = ("total_s", "calls")

    def __init__(self):
        self.total_s = 0.0
        self.calls = 0


class Metrics:
    """Process-global metric registry; thread-safe, negligible overhead."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._stages: Dict[str, _Stage] = {}
        self._counters: Dict[str, float] = {}
        self._hbm_peak_bytes = 0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._spans = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        # the gc callback's own state, never under self._lock: a collection
        # can start on a thread that holds it. Collections do not nest (the
        # interpreter runs one at a time), so one start time does.
        self._gc_start: Optional[float] = None
        self._gc_pause_s = 0.0
        self._gc_collections = 0

    # -- stage spans -------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def stage(self, name: str, cpu: bool = False, new_sample: bool = False):
        """Time the block as stage `name`: its total grows by the block's
        seconds and the buffer gains its span. cpu=True also records the
        thread's CPU seconds in it; new_sample=True makes it the root of a
        sample (Metrics.sample)."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = next(self._ids)
        c0 = time.thread_time() if cpu else 0.0
        # open: no end yet
        me = Span(name, time.perf_counter(), None, threading.get_native_id(),
                  sid, parent.id if parent else None,
                  sid if new_sample else (parent.sample if parent else None),
                  None)
        stack.append(me)
        try:
            yield
        finally:
            t1 = time.perf_counter()
            span = me._replace(end=t1, cpu_s=time.thread_time() - c0
                               if cpu else None)
            stack.remove(me)
            with self._lock:
                s = self._stages.get(name)
                if s is None:
                    s = self._stages[name] = _Stage()
                s.total_s += t1 - me.start
                s.calls += 1
                self._spans.append(span)

    def sample(self):
        """The root span of one sample (apps/pisces.main)."""
        return self.stage("sample", new_sample=True)

    def carry(self, fn):
        """fn, to run on another thread under the span open here now, so
        that the spans it opens there nest under this one."""
        stack = self._stack()
        if not stack:
            return fn
        parent = stack[-1]

        def under_parent(*a, **k):
            theirs = self._stack()
            theirs.append(parent)
            try:
                return fn(*a, **k)
            finally:
                theirs.remove(parent)
        return under_parent

    def spans(self) -> List[Span]:
        """The buffer's closed spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def open_spans(self) -> List[Span]:
        """The spans open on this thread, outermost first, each as if it
        closed now (cpu_s None)."""
        now = time.perf_counter()
        return [s._replace(end=now) for s in self._stack()]

    # -- counters ----------------------------------------------------------
    def count(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def _on_gc(self, phase: str, info: dict) -> None:
        """gc.callbacks entry: the seconds from each collection's start to
        its stop (counter gc_pause_s). Takes no lock."""
        if phase == "start":
            self._gc_start = time.perf_counter()
        elif self._gc_start is not None:
            self._gc_pause_s += time.perf_counter() - self._gc_start
            self._gc_collections += 1
            self._gc_start = None

    # -- device memory -----------------------------------------------------
    def device_watermark(self, device=None) -> Optional[int]:
        """Record the peak device memory allocated by torch on a CUDA
        `device` as a watermark; returns bytes, or None for a CPU device."""
        import torch
        if device is None or torch.device(device).type != "cuda":
            return None
        used = int(torch.cuda.max_memory_allocated(device))
        with self._lock:
            self._hbm_peak_bytes = max(self._hbm_peak_bytes, used)
        return used

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        gc_counters = {"gc_collections": float(self._gc_collections),
                       "gc_pause_s": self._gc_pause_s}
        with self._lock:
            counters = dict(self._counters)
            counters.update(gc_counters)
            return {
                "stages": {k: {"seconds": round(v.total_s, 4),
                               "calls": v.calls}
                           for k, v in sorted(self._stages.items())},
                "counters": dict(sorted(counters.items())),
                "hbm_peak_bytes": self._hbm_peak_bytes,
                "wall_seconds": round(time.perf_counter() - self._t0, 3),
            }

    def report(self, emit=log) -> dict:
        snap = self.snapshot()
        for name, s in snap["stages"].items():
            emit(f"stage {name}: {s['seconds']:.2f}s over {s['calls']} calls")
        for name, n in snap["counters"].items():
            emit(f"counter {name}: "
                 + (f"{n:,.0f}" if float(n).is_integer() else f"{n:,.3f}"))
        if snap["hbm_peak_bytes"]:
            emit(f"device memory watermark: "
                 f"{snap['hbm_peak_bytes'] / (1 << 20):.1f} MiB")
        return snap

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()
            self._counters.clear()
            self._spans.clear()
            self._hbm_peak_bytes = 0
            self._t0 = time.perf_counter()
        self._gc_pause_s = 0.0
        self._gc_collections = 0


metrics = Metrics()
gc.callbacks.append(metrics._on_gc)

# the kernel of torch.cuda._sleep, which profiler_trace launches to mark
# the profile's start on the trace's clock
_MARK = "spin_kernel"


def _mark_card() -> float:
    """The host clock's reading just before a short kernel that starts
    once the card is idle: the profile's start on both clocks."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


def _span_events(spans: List[Span], t0: float, t1: float,
                 ts0: float) -> List[dict]:
    """Chrome trace complete events of the spans inside [t0, t1] (clipped
    to it), placed so that host time t0 falls at trace time ts0 (us), one
    track a thread under their own process row."""
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_PID, "tid": 0,
               "args": {"name": "pisces_tpu_torch stages"}}]
    threads = set()
    for s in spans:
        start, end = max(s.start, t0), min(s.end, t1)
        if end < start:
            continue
        threads.add(s.thread)
        events.append({
            "ph": "X", "cat": "stage", "name": s.name, "pid": SPAN_PID,
            "tid": s.thread, "ts": ts0 + (start - t0) * 1e6,
            "dur": (end - start) * 1e6,
            "args": {"id": s.id, "parent": s.parent, "sample": s.sample,
                     "cpu_s": s.cpu_s}})
    for tid in sorted(threads):
        events.append({"ph": "M", "name": "thread_name", "pid": SPAN_PID,
                       "tid": tid, "args": {"name": f"thread {tid}"}})
    return events


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """Capture a torch.profiler trace (CPU and, when present, CUDA
    activity; Chrome trace format) of the enclosed region into
    trace_dir/trace.json when trace_dir is set, with the region's stage
    spans added as complete events, one track a thread. With a card they
    sit on the trace's clock, anchored by a short kernel launched at the
    profile's start; without one they run on the host clock from the
    profile's start. No-op without trace_dir."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = _mark_card() if card else time.perf_counter()
        yield
        t1 = time.perf_counter()
        still_open = metrics.open_spans()
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    ts0 = 0.0
    if card:
        marks = [e["ts"] for e in events
                 if e.get("cat") == "kernel" and _MARK in e.get("name", "")]
        if marks:
            ts0 = min(marks)
        else:
            log("profiler trace holds no start mark: stage spans on the "
                "host clock from the profile's start", "WARNING")
    spans = [s for s in metrics.spans() if s.end > t0 and s.start < t1]
    events.extend(_span_events(spans + still_open, t0, t1, ts0))
    with open(path, "w") as f:
        json.dump(trace, f)


def kernel_device_ms(fn, kernel: str, iters: int, tries: int = 2):
    """(mean device ms, events seen): the device time of the CUDA kernel
    whose name holds `kernel` over `iters` calls of fn(), from
    torch.profiler's key_averages(), averaged over the events the trace
    holds: the kernel alone, without the host's launch path. A trace now
    and then holds fewer events than launches; then it traces again, up to
    `tries` traces, and keeps the one with the most. (None, 0) where no
    trace holds the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = (None, 0)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if kernel in e.key and e.device_time_total > 0]
        count = sum(e.count for e in hits)
        if count > best[1]:
            best = (sum(e.device_time_total for e in hits) / count / 1e3,
                    count)
        if count == iters:
            break
    return best
