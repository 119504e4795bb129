"""Whole runs of small cells on the CPU: the result line's schema,
discovery of a new configuration, traffic and per-layer metric by name
alone, the control, and the faults that `correct` has to catch."""
import json
import os
import re
import shutil

import numpy as np
import pytest

from portbench import control, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 123


def _run(root, cell, trace=False, seconds=1.0):
    return run.run_cell(cell, SEED, seconds, trace, device="cpu", root=root)


def test_result_line_schema(small_root, capsys):
    with open(os.path.join(small_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for trace in (False, True):
        r = _run(small_root, "small.panel", trace)
        run.print_result(r)
        out, errs = capsys.readouterr()
        last = json.loads(out.strip().splitlines()[-1])
        assert list(last)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(last)[-1] == "checks"
        assert last["correct"] is True and last["failed"] == 0
        assert last["attempted"] >= 1
        section = "per_layer" if trace else "end_to_end"
        names = {m["name"] for m in run.metrics_of(bench, section,
                                                   "small.panel")}
        if trace:
            # no card: the device's readers find nothing to read
            names = {n for n in names if n.split(".")[0] not in (
                "score_tuples_roofline_pct", "device_idle_pct")}
            assert {"busy_s", "window_s"} <= set(last["device"])
            assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(last["metrics"]) == names
        for m in last["metrics"].values():
            assert isinstance(m["value"], float) and m["value"] > 0
        for k in ("platform", "kind", "count", "memory_peak_bytes"):
            assert k in last["device"]
        # the checks are the last lines of standard error, each with a limit
        tail = errs.strip().splitlines()[-len(last["checks"]):]
        assert all(line.startswith("check ") and " limit " in line
                   for line in tail)


def test_benchmark_json_follows_its_contract():
    root = run.ROOT
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        with open(os.path.join(root, c["file"])) as f:
            conf = json.load(f)
        assert set(c["reduced"]) <= set(conf) and conf["name"] == c["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "reads_per_s", "peak_rss_gib"} <= e2e
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(root, "portbench", "traffic",
                                           w["traffic"] + ".json"))
        layer = run.metrics_of(bench, "per_layer", w["name"])
        assert layer, w["name"]
        # set-up, another end-to-end metric, and whatever its per-layer
        # metrics move
        own = {m["name"] for m in run.metrics_of(bench, "end_to_end",
                                                 w["name"])}
        assert "setup_s" in own and len(own) >= 2, w["name"]
        assert {m["moves"] for m in layer} <= own, w["name"]
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(root, "portbench",
                                           "layer_metrics",
                                           m["name"] + ".py"))


def test_new_config_traffic_and_metric_by_files_alone(small_root):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as new files and BENCHMARK.json entries, editing no file."""
    pb = os.path.join(small_root, "portbench")
    with open(os.path.join(pb, "configs", "somatic_panel.json")) as f:
        conf = json.load(f)
    conf["name"] = "panel_no_threads"
    conf["flags"] = [x for i, x in enumerate(conf["flags"])
                     if x != "-MaxThreads" and
                     (i == 0 or conf["flags"][i - 1] != "-MaxThreads")]
    with open(os.path.join(pb, "configs", "panel_no_threads.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pb, "traffic", "small_panel.json")) as f:
        traffic = json.load(f)
    traffic["chroms"] = ["x1"]
    traffic["reads"] = traffic["reads_per_chrom"]
    with open(os.path.join(pb, "traffic", "one_small.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "layer_metrics", "samples_run.py"), "w") as f:
        f.write("def read(run):\n    return float(run['samples'])\n")
    with open(os.path.join(small_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "panel_no_threads", "source": "x",
                             "file": "portbench/configs/panel_no_threads.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new.cell",
                               "config": "panel_no_threads",
                               "traffic": "one_small", "chips": 1,
                               "why": "x"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "reads_per_s")["workloads"].append("new.cell")
    bench["per_layer"].append({"name": "samples_run", "unit": "samples",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "reads_per_s",
                               "workloads": ["new.cell"]})
    with open(os.path.join(small_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = _run(small_root, "new.cell", trace=True)
    assert r["correct"] is True
    assert r["metrics"]["samples_run"]["value"] == r["attempted"]
    r = _run(small_root, "new.cell")
    assert set(r["metrics"]) == {"reads_per_s", "peak_rss_gib", "setup_s"}


def test_new_read_layout_by_files_alone(small_root):
    """A later change adds a read layout (stitched and paired reads of two
    lengths, mate fields, an XD tag on every read, the stitcher's @PG line)
    with a configuration, a traffic mix and a cell, as new files and
    BENCHMARK.json entries, editing no file; the reference carries the
    stitched direction, and the check sees it."""
    from portbench import gen
    from portbench.reference import compare, scoring
    from portbench.tests.conftest import (PAIRED_READS, PAIRED_TRAFFIC,
                                          add_paired_layout)
    add_paired_layout(small_root)
    pb = os.path.join(small_root, "portbench")
    with open(os.path.join(pb, "configs", "somatic_panel.json")) as f:
        conf = json.load(f)
    conf["name"] = "stitched_panel"
    conf["reads"] = PAIRED_READS
    with open(os.path.join(pb, "configs", "stitched_panel.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pb, "traffic", "small_pairs.json"), "w") as f:
        json.dump(PAIRED_TRAFFIC, f)
    with open(os.path.join(small_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "stitched_panel", "source": "x",
                             "file": "portbench/configs/stitched_panel.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "pairs.panel",
                               "config": "stitched_panel",
                               "traffic": "small_pairs", "chips": 1,
                               "why": "x"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "reads_per_s")["workloads"].append("pairs.panel")
    with open(os.path.join(small_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = _run(small_root, "pairs.panel")
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["lines_compared"]["value"] >= 2 * 6000
    assert set(r["metrics"]) == {"reads_per_s", "peak_rss_gib", "setup_s"}
    # the reference's pileup holds stitched bases; counted as forward ones
    # they give another body, which the run's check would refuse
    c = run.load_cell("pairs.panel", small_root)
    layout = gen.load_layout(c["config"], small_root)
    sample = layout.make_sample(gen.sample_spec(c["config"], c["traffic"]),
                                SEED)
    assert layout.counts(sample, sample.chroms[0], 20)[..., 2].sum() > 0

    def as_forward(s, ch, min_bq):
        x = layout.counts(s, ch, min_bq).copy()
        x[..., 0] += x[..., 2]
        x[..., 2] = 0
        return x
    cal, limits = c["config"]["calling"], c["config"]["limits"]
    want = compare.expected_body(sample, layout.counts, cal, scoring.F64)
    got = compare.expected_body(sample, as_forward, cal, scoring.F64)
    r = compare.compare(compare.render(got, cal["q_filter"]), want,
                        cal["q_filter"])
    assert (r["line_mismatches"] > limits["line_mismatches"]
            or r["sb_gap"] > limits["sb_gap"]), r


@pytest.mark.parametrize("cell", ["small.panel", "small.wgs"])
def test_control_is_not_correct(small_root, cell):
    c = run.load_cell(cell, small_root)
    r = control.control_numbers(c["config"], c["traffic"], SEED)
    assert r["lines_compared"] > 0
    assert not r["passes"], r


def _alter_tuple_scores(monkeypatch):
    from pisces_tpu_torch.ops import scoring_kernels
    real = scoring_kernels.score_reference_tuples

    def altered(*a, **k):
        out = real(*a, **k)
        out["gq"] = out["gq"] + 1
        return out
    monkeypatch.setattr(scoring_kernels, "score_reference_tuples", altered)


def _alter_candidate_q(monkeypatch):
    from pisces_tpu_torch.ops import torch_scoring
    real = torch_scoring.score_snv_loci

    def altered(*a, **k):
        out = real(*a, **k)
        out["variant_qscore"] = out["variant_qscore"] + 1
        return out
    monkeypatch.setattr(torch_scoring, "score_snv_loci", altered)


def _drop_half_the_reads(monkeypatch):
    from pisces_tpu_torch.apps import pisces as app
    real = app.filter_batch

    def half(*a, **k):
        keep = np.array(real(*a, **k), copy=True)
        keep[::2] = False
        return keep
    monkeypatch.setattr(app, "filter_batch", half)


def _caller_returns_nothing(monkeypatch):
    from pisces_tpu_torch.calling.caller import AlleleCaller
    monkeypatch.setattr(AlleleCaller, "call", lambda self, *a, **k: {})


@pytest.mark.parametrize("cell,fault", [
    ("small.panel", _alter_tuple_scores),
    ("small.wgs", _alter_candidate_q),
    ("small.panel", _drop_half_the_reads),
    ("small.wgs", _drop_half_the_reads),
    ("small.panel", _caller_returns_nothing),
    ("small.wgs", _caller_returns_nothing),
])
def test_faults_come_out_not_correct(small_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(small_root, cell)
    assert r["correct"] is False
    assert r["checks"]["line_mismatches"]["value"] > 0


@pytest.mark.cuda
def test_small_cells_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from portbench.tests.conftest import make_root
    root = make_root(str(tmp_path / "root"))
    for cell in ("small.panel", "small.wgs"):
        r = run.run_cell(cell, SEED, 2.0, True, device="cuda", root=root)
        assert r["correct"] is True, r["checks"]
        assert r["device"]["busy_s"] > 0
        if cell == "small.panel":
            assert r["checks"]["score_tuples_launches"]["value"] >= 1
            assert 0 < r["metrics"]["score_tuples_roofline_pct"]["value"] \
                <= 100


def test_peak_rss_helper_process_sees_an_allocation():
    rss = run.PeakRss()
    base = rss._rss()
    rss.start()
    block = np.ones(256 << 20, np.uint8)
    import time
    time.sleep(0.2)
    del block
    time.sleep(0.05)
    assert rss.stop() >= base + (200 << 20)
    assert rss._helper.returncode == 0


@pytest.mark.parametrize("late", ["jax", "pisces_tpu"])
def test_guard_catches_a_module_loaded_after_the_window(small_root, late):
    """A per-layer reader (run after the window and the check) that loads
    a forbidden module fails the run: the guard is the last step."""
    import sys
    with open(os.path.join(small_root, "portbench", "layer_metrics",
                           "bam_fetch_s_per_Mread.py"), "a") as f:
        f.write(f"\nimport sys, types\nsys.modules.setdefault({late!r}, "
                f"types.ModuleType({late!r}))\n")
    assert late not in sys.modules
    try:
        with pytest.raises(run.RunError, match="before the result.*" + late):
            _run(small_root, "small.wgs", trace=True)
    finally:
        sys.modules.pop(late, None)


class _Event:
    def __init__(self, name, start, end, device="CUDA"):
        import types
        self.name = name
        self.device_type = types.SimpleNamespace(name=device)
        self.time_range = types.SimpleNamespace(start=start, end=end)


def test_device_view_aligns_the_window_on_its_start_mark():
    """The trace's clock (us) is anchored at the start mark; the window
    lasts as long as on the host's clock, so a trace that lost its last
    events still spans the window; marks and host events are not busy."""
    from portbench import trace
    events = [_Event("host op", 0.0, 9e6, device="CPU"),
              _Event("at::cuda::spin_kernel(long)", 1000.0, 1001.0),
              _Event("score_tuples_kernel", 3000.0, 4000.0),
              _Event("Memcpy HtoD", 6000.0, 7000.0)]
    spans = [("pileup", 10.0, 10.002), ("allele_calling", 10.002, 10.01)]
    view = trace.device_view(events, spans, (10.0, 10.01), True)
    assert view["window_s"] == pytest.approx(0.01)
    assert view["busy_s"] == pytest.approx(0.002)
    assert view["n_device"] == 2
    assert view["last_device_s"] == pytest.approx(0.006)
    assert [n for n, _s in view["idle_gaps"]] == [
        "allele_calling", "pileup", "allele_calling"]
    assert view["idle_gaps"][0][1] == pytest.approx(0.004)
    assert trace.device_view(events[2:], spans, (10.0, 10.01), True) is None
