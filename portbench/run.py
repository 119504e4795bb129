"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name: the cell in BENCHMARK.json, its configuration
in portbench/configs/<config>.json, the configuration's read layout in
portbench/layouts/<layout>.py (single_end unless its reads block names
one), its traffic in portbench/traffic/<traffic>.json, each per-layer
metric's reader in portbench/layer_metrics/<metric>.py.

A run:
1. set-up (setup_s): checks the cards, imports the program, generates the
   sample (and, where the traffic asks for one, a smaller warm-up sample
   of the same configuration) in a child process (the layout's
   make_sample and write_sample, portbench/gen.py),
   builds the program's host library and kernels (into
   pisces_tpu_torch/build/ inside the checkout; only the first run of a
   checkout builds), opens the card and runs the warm-up sample, or the
   sample itself, through the entry below;
2. the window: a closed loop, one sample after another through
   pisces_tpu_torch.apps.pisces.main(argv) with the configuration's flags,
   each into a fresh output folder (the one before it is deleted), until
   --seconds have passed; the sample in flight at the deadline runs to its
   end and counts. reads_per_s is all reads over all of the window's wall
   time; peak_rss_gib the process's peak resident memory in the window;
3. after the window: the last sample's VCF body against the plain
   reference (portbench/reference), which works from the layout's counts
   of the generated read arrays; with --trace 1 the window ran under
   torch.profiler (the card's activity alone), and the per-layer metrics
   are read from its trace, the program's stage totals and counters.

The result is the last line of standard output; the numbers compared,
each with its limit, are the last lines of standard error and the last key
of the result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# modules whose presence in the measured process fails the run, compared by
# the whole top-level name (pisces_tpu_torch begins with pisces_tpu)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pisces_tpu")
GIB = float(1 << 30)


class RunError(Exception):
    """A run that cannot give a result (exit 2, nothing printed)."""


def err(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# finding a cell's files by name
# ---------------------------------------------------------------------------

def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's BENCHMARK.json entries, configuration and traffic."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise RunError(f"no BENCHMARK.json in {root}")
    with open(path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return {"bench": bench, "cell": cell, "config": config,
            "traffic": traffic}


def metrics_of(bench: dict, section: str, cell: str) -> list:
    """The metric entries of a section that this cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str, root: str = ROOT):
    """portbench/layer_metrics/<name>.py's read(run) function."""
    path = os.path.join(root, "portbench", "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_layer_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(modules=None) -> list:
    names = {m.split(".", 1)[0] for m in (modules if modules is not None
                                          else list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def check_no_jax(when: str) -> None:
    """Fail the run where this process holds a forbidden module."""
    found = forbidden_loaded()
    if found:
        raise RunError(f"{when}: modules of JAX or of the JAX package are "
                       "loaded: " + ", ".join(found))


def argv_of(config: dict, paths: dict, out_dir: str, device: str) -> list:
    """The command line a user would type for this sample."""
    flags = [f.replace("{intervals}", paths["intervals"])
             for f in config["flags"]]
    if device != "cuda":
        flags = [device if i and flags[i - 1] == "-device" else f
                 for i, f in enumerate(flags)]
    return ["-bam", paths["bam"], "-g", paths["genome"], "-o", out_dir] + flags


# ---------------------------------------------------------------------------
# peak resident memory of the window
# ---------------------------------------------------------------------------

class PeakRss:
    """The process's peak RSS over a stretch of time: the largest RSS that a
    helper process reads from /proc/<pid>/statm every 5 ms (a process, so
    that the sampling takes no turn of this process's interpreter lock from
    the program's threads). The one source on every host: the card's
    machine has neither a VmHWM line nor its reset."""

    INTERVAL_S = 0.005
    HELPER = (
        "import os, sys, time\n"
        "pid, dt = sys.argv[1], float(sys.argv[2])\n"
        "page = os.sysconf('SC_PAGE_SIZE')\n"
        "def rss():\n"
        "    with open(f'/proc/{pid}/statm') as f:\n"
        "        return int(f.read().split()[1]) * page\n"
        "sys.stdin.readline()\n"
        "peak = rss()\n"
        "os.set_blocking(0, False)\n"
        "while sys.stdin.buffer.read(1) is None:  # stop, or end of file\n"
        "    peak = max(peak, rss())\n"
        "    time.sleep(dt)\n"
        "print(max(peak, rss()), flush=True)\n")

    def __init__(self):
        import subprocess
        self._helper = subprocess.Popen(
            [sys.executable, "-c", self.HELPER, str(os.getpid()),
             str(self.INTERVAL_S)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    @staticmethod
    def _rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def start(self) -> None:
        self._helper.stdin.write("start\n")
        self._helper.stdin.flush()

    def stop(self) -> int:
        try:
            out, _ = self._helper.communicate("stop\n", timeout=60)
        finally:
            if self._helper.poll() is None:
                self._helper.kill()
                self._helper.wait()
        return int(max(int(out.split()[-1]), self._rss()))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _generate(config, traffic, seed, out_dir, result_path, root):
    from portbench import gen
    paths = gen.generate_inputs(config, traffic, seed, out_dir, root)
    with open(result_path, "w") as f:
        json.dump(paths, f)


def mark_device(device: str) -> float:
    """The host clock's reading beside a short operation on the card
    (trace.MARK) that starts after all queued work has ended: it marks the
    window's start in the trace's clock."""
    import torch
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    if device == "cuda":
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return t


def _profile(device: str):
    """A torch.profiler session of the card's activity alone: recording
    every host operation would slow the host layers that the per-layer
    metrics read (without a card, the host's, which holds no device
    operation)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if device == "cuda"
                               else ProfilerActivity.CPU])


def _stage_snapshot():
    from pisces_tpu_torch.utils.metrics import metrics
    snap = metrics.snapshot()
    return ({k: v["seconds"] for k, v in snap["stages"].items()},
            {k: v["calls"] for k, v in snap["stages"].items()},
            dict(snap["counters"]))


def host_steal_s() -> float:
    """Seconds that the hypervisor took from this machine's CPUs, summed
    over them (/proc/stat's steal column); 0 where it is not kept."""
    try:
        with open("/proc/stat") as f:
            cols = f.readline().split()
        return int(cols[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT) -> dict:
    """One run; returns the result dict (the last line's object) and the
    checks. device "cpu" skips the look for a card (the CPU tests)."""
    c = load_cell(name, root)
    bench, cell, config, traffic = c["bench"], c["cell"], c["config"], \
        c["traffic"]
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {cell['chips']}")
    if importlib.util.find_spec("pisces_tpu_torch") is None:
        raise RunError("the program (pisces_tpu_torch) is not in the "
                       "checkout")
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        result = _run(seed, seconds, trace, device, bench, cell, config,
                      traffic, work, root)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the last step before the result: what the check, the readers or
    # anything they import loaded after the window counts too
    check_no_jax("before the result")
    return result


def _run(seed, seconds, trace, device, bench, cell, config, traffic, work,
         root):
    import multiprocessing as mp

    import torch
    result_path = os.path.join(work, "inputs.json")
    child = mp.get_context("spawn").Process(
        target=_generate,
        args=(config, traffic, seed, work, result_path, root))
    child.start()
    try:
        from pisces_tpu_torch.apps import pisces as app
        from pisces_tpu_torch.io import native
        from pisces_tpu_torch.ops import scoring_kernels
        native.get_lib()
        if device == "cuda":
            scoring_kernels.build_kernels()
            torch.cuda.init()
            torch.zeros(1, device="cuda").sum().item()
        t_built = time.perf_counter()
    finally:
        child.join()
    t_inputs = time.perf_counter()
    if child.exitcode != 0:
        raise RunError(f"input generation failed (exit {child.exitcode})")
    with open(result_path) as f:
        inputs = json.load(f)
    out_root = os.path.join(work, "out")
    code = app.main(argv_of(config, inputs["warmup"],
                            os.path.join(out_root, "warmup"), device))
    if code != 0:
        raise RunError(f"the warm-up sample failed (exit {code})")
    warm_launches = dict(scoring_kernels.launch_counts)
    shutil.rmtree(os.path.join(out_root, "warmup"), ignore_errors=True)
    gc.collect()
    setup_s = time.perf_counter() - T0
    err(f"set-up {setup_s:.3f} s: program imported, built and the card "
        f"opened at {t_built - T0:.3f} s, inputs at {t_inputs - T0:.3f} s, "
        f"warm-up {setup_s - (t_inputs - T0):.3f} s")

    # ---- the window ------------------------------------------------------
    stages0, calls0, counters0 = _stage_snapshot()
    scoring_kernels.reset_launch_counts()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rss = PeakRss()
    prof = None
    spans = None
    if trace:
        from portbench.trace import layer_spans
        span_ctx = layer_spans()
        spans = span_ctx.__enter__()
        prof = _profile(device)
        prof.__enter__()
        window_perf0 = mark_device(device)
    rss.start()
    samples, failed, reads = 0, 0, 0
    walls, cpus = [], []
    last_out, prev_out = None, None
    steal0 = host_steal_s()
    cpu_start = time.process_time()
    t_start = time.perf_counter()
    try:
        while time.perf_counter() - t_start < seconds:
            out_dir = os.path.join(out_root, f"s{samples}")
            t, c = time.perf_counter(), time.process_time()
            code = app.main(argv_of(config, inputs["sample"], out_dir,
                                    device))
            walls.append(time.perf_counter() - t)
            cpus.append(time.process_time() - c)
            samples += 1
            reads += inputs["sample"]["n_reads"]
            if code != 0:
                failed += 1
            if prev_out is not None:
                shutil.rmtree(prev_out, ignore_errors=True)
            prev_out, last_out = out_dir, out_dir
        if device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
        cpu_s = time.process_time() - cpu_start
        steal_s = host_steal_s() - steal0
    finally:
        peak_rss = rss.stop()
    view = None
    if trace:
        window_perf1 = time.perf_counter()
        prof.__exit__(None, None, None)
        span_ctx.__exit__(None, None, None)
    stages1, calls1, counters1 = _stage_snapshot()
    launches = dict(scoring_kernels.launch_counts)
    mem_peak = (int(torch.cuda.max_memory_reserved()) if device == "cuda"
                else 0)
    check_no_jax("at the window's end")
    err(f"window: {samples} samples in {window_s:.3f} s, walls "
        + ", ".join(f"{w:.3f}" for w in walls)
        + f"; CPU {cpu_s:.3f} s, a sample "
        + ", ".join(f"{c:.3f}" for c in cpus)
        + f"; host steal {steal_s:.3f} s; warm-up launches {warm_launches}")

    # ---- after the window: the program's state freed, then the check ----
    if trace:
        from portbench.trace import device_view
        view = device_view(prof.events(), spans,
                           (window_perf0, window_perf1), device == "cuda")
        if view is not None:
            err(f"trace: window {view['window_s']:.6f} s, its last device "
                f"operation ends at {view['last_device_s']:.6f} s; "
                f"{len(spans)} host spans, {view['n_device']} device events")
        prof = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    judged = judge(config, traffic, seed, last_out, launches, failed,
                   device, root)

    e2e_values = {"reads_per_s": reads / window_s,
                  "peak_rss_gib": peak_rss / GIB, "setup_s": setup_s}
    err("end to end: " + ", ".join(f"{k} {v!r}"
                                   for k, v in e2e_values.items()))
    out_metrics = {}
    if not trace:
        for m in metrics_of(bench, "end_to_end", cell["name"]):
            out_metrics[m["name"]] = {"value": e2e_values[m["name"]],
                                      "unit": m["unit"]}
    else:
        run = {"cell": cell["name"], "config": config, "traffic": traffic,
               "reads": reads, "samples": samples, "window_s": window_s,
               "stages": _delta(stages1, stages0),
               "stage_calls": _delta(calls1, calls0),
               "counters": _delta(counters1, counters0),
               "launches": launches, "device": view,
               "reference": judged["reference"]}
        for m in metrics_of(bench, "per_layer", cell["name"]):
            value = load_reader(m["name"], root)(run)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell["chips"], "memory_peak_bytes": mem_peak}
    if trace and view is not None:
        dev["busy_s"] = view["busy_s"]
        dev["window_s"] = view["window_s"]
    result = {"correct": judged["correct"], "attempted": samples,
              "failed": failed, "metrics": out_metrics, "device": dev}
    if trace and view is not None:
        result["breakdown"] = {"device_ops": view["device_ops"],
                               "idle_gaps": view["idle_gaps"]}
    result["checks"] = judged["checks"]
    return result


def judge(config: dict, traffic: dict, seed: int, out_dir: str,
          launches: dict, failed: int, device: str = "cuda",
          root: str = ROOT) -> dict:
    """The last sample's body against the plain reference, and the
    run's other checks: each {name: {value, limit}}."""
    from portbench import gen
    from portbench.reference import compare, scoring
    limits = config["limits"]
    layout = gen.load_layout(config, root)
    sample = layout.make_sample(gen.sample_spec(config, traffic), seed)
    expected = compare.expected_body(sample, layout.counts,
                                     config["calling"], scoring.F64)
    names = [n for n in os.listdir(out_dir) if n.endswith(".vcf")] \
        if out_dir and os.path.isdir(out_dir) else []
    body = compare.read_body(os.path.join(out_dir, names[0])) if names else ""
    q_filter = config["calling"]["q_filter"]
    r = compare.compare(body, expected, q_filter)
    for ex in r["examples"]:
        err(f"differs: {ex}")
    checks = {
        "failed_samples": {"value": failed, "limit": 0},
        "lines_compared": {"value": r["lines_compared"], "limit": ">=1"},
        "line_mismatches": {"value": r["line_mismatches"],
                            "limit": limits["line_mismatches"]},
        "sb_gap": {"value": r["sb_gap"], "limit": limits["sb_gap"]},
    }
    ok = (failed == 0 and r["lines_compared"] >= 1
          and r["line_mismatches"] <= limits["line_mismatches"]
          and r["sb_gap"] <= limits["sb_gap"])
    # the hand-written kernels the configuration's path launches (on the
    # CPU their plain versions stand in, and nothing launches)
    for k in config.get("kernels", []) if device == "cuda" else ():
        checks[f"{k}_launches"] = {"value": launches.get(k, 0),
                                   "limit": ">=1"}
        ok = ok and launches.get(k, 0) >= 1
    reference = {"tuples": []}
    if config["calling"]["gvcf"]:
        reference["tuples"] = [_kernel_work(ref, config["calling"])
                               for _n, _s, _v, ref in expected]
    return {"correct": bool(ok), "checks": checks, "reference": reference}


def _kernel_work(ref: dict, calling: dict) -> dict:
    """(ops, bytes) of one chromosome's score_tuples launch: its unique
    reference tuples, with the reference's frequency and genotype."""
    import numpy as np

    from portbench import roofline
    tuples = ref["tuples"]
    uniq, first = np.unique(tuples, axis=0, return_index=True)
    ops = roofline.tuple_kernel_ops(uniq, ref["freq"][first], ref["gt"][first],
                                    calling["noise_q"], calling["min_freq"])
    return {"unique": int(len(uniq)), "ops": ops,
            "bytes": float(len(uniq) * roofline.TUPLE_BYTES)}


def print_result(result: dict) -> None:
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except RunError as e:
        err(str(e))
        return 2
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
