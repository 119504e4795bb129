"""Structured tracing / step metrics.

The reference's observability is minimal (SURVEY §5: Benchmark wall-clock,
peak memory at exit, per-(bam,chr) elapsed seconds). The rebuild adds the
subsystem SURVEY §5 calls for: named stage timers with hierarchical scopes,
step metrics (loci/sec, reads/sec), the peak device memory that torch
allocated, and an optional torch.profiler trace capture — all behind a
process-global registry so hot paths pay one perf_counter call per scope.

Usage:
    from pisces_tpu_torch.utils.metrics import metrics
    with metrics.stage("pileup"):
        ...
    metrics.count("reads", n)
    metrics.device_watermark(device)    # record peak device memory
    metrics.report()                    # log a summary table
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

from pisces_tpu_torch.utils.logger import log


class _Stage:
    __slots__ = ("total_s", "calls")

    def __init__(self):
        self.total_s = 0.0
        self.calls = 0


class Metrics:
    """Process-global metric registry; thread-safe, negligible overhead."""

    def __init__(self):
        self._stages: Dict[str, _Stage] = {}
        self._counters: Dict[str, float] = {}
        self._hbm_peak_bytes = 0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    # -- stage timing ------------------------------------------------------
    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._stages.get(name)
                if s is None:
                    s = self._stages[name] = _Stage()
                s.total_s += dt
                s.calls += 1

    # -- counters ----------------------------------------------------------
    def count(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def rate(self, counter: str, stage: Optional[str] = None) -> float:
        """counter units per second, over a stage's time (or process time)."""
        n = self._counters.get(counter, 0.0)
        if stage is not None and stage in self._stages:
            dt = self._stages[stage].total_s
        else:
            dt = time.perf_counter() - self._t0
        return n / dt if dt > 0 else 0.0

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
        with self._lock:
            return {
                "stages": {k: {"seconds": round(v.total_s, 4),
                               "calls": v.calls}
                           for k, v in sorted(self._stages.items())},
                "counters": dict(sorted(self._counters.items())),
                "hbm_peak_bytes": self._hbm_peak_bytes,
                "wall_seconds": round(time.perf_counter() - self._t0, 3),
            }

    def report(self, emit=log) -> dict:
        snap = self.snapshot()
        for name, s in snap["stages"].items():
            emit(f"stage {name}: {s['seconds']:.2f}s over {s['calls']} calls")
        for name, n in snap["counters"].items():
            emit(f"counter {name}: {n:,.0f}")
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
            self._hbm_peak_bytes = 0
            self._t0 = time.perf_counter()


metrics = Metrics()


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """Capture a torch.profiler trace (CPU and, when present, CUDA
    activity; Chrome trace format) of the enclosed region into trace_dir
    when it is set; no-op otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


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
