"""Fixtures of the benchmark's own tests: a small copy of the benchmark's
root whose cells run on the CPU in seconds.

    python -m pytest portbench/tests -q            # CPU
    python -m pytest portbench/tests -q -m cuda    # on a card
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the small cells: a panel of two 15 kb chromosomes at about 670x that
# warms up on its sample, as the panel traffic does, and a germline segment
# of 300 kb at 30x in 100 kb windows with a warm-up sample of its own; both
# over the program's device thresholds (4096 unique tuples, 4096
# candidates)
SMALL_TRAFFIC = {
    "small_panel": {"why": "two 15 kb chromosomes at about 670x",
                    "depth": 667, "reads": 200000, "chroms": ["c1", "c2"],
                    "chrom_len": 15000, "reads_per_chrom": 100000,
                    "warmup": "sample"},
    "small_wgs": {"why": "one 300 kb segment at 30x", "depth": 30,
                  "reads": 60000, "chroms": ["c20"], "chrom_len": 300000,
                  "reads_per_chrom": 60000,
                  "warmup": {"chroms": ["cw"], "chrom_len": 50000,
                             "reads_per_chrom": 10000}},
}
SMALL_CELLS = {"small.panel": ("somatic_panel", "small_panel"),
               "small.wgs": ("germline_wgs", "small_wgs")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


def make_root(dest: str) -> str:
    """A copy of BENCHMARK.json and portbench's data files under dest, with
    the small cells in place of the real ones (the code stays the repo's)."""
    os.makedirs(os.path.join(dest, "portbench"), exist_ok=True)
    for sub in ("configs", "traffic", "layer_metrics", "layouts"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        os.path.join(dest, "portbench", sub))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, spec in SMALL_TRAFFIC.items():
        with open(os.path.join(dest, "portbench", "traffic",
                               name + ".json"), "w") as f:
            json.dump(spec, f)
    bench["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "small"}
        for n, (c, t) in SMALL_CELLS.items()]
    # every end-to-end metric in both small cells, so that each per-layer
    # metric's moves is reported wherever it is
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = list(SMALL_CELLS)
    for m in bench["per_layer"]:
        m["workloads"] = (["small.panel"] if m["name"].split(".")[0] in (
            "gvcf_s_per_Mline", "score_tuples_roofline_pct")
            else list(SMALL_CELLS))
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dest


@pytest.fixture
def small_root(tmp_path):
    return make_root(str(tmp_path / "root"))


# a read layout that the tests add by files alone: stitched and paired
# reads of two lengths, mate fields, an XD tag on every read and the
# stitcher's @PG line (portbench/tests/layouts/paired_xd.py)
PAIRED_READS = {"layout": "paired_xd", "stitched_share": 0.5,
                "profile": {"base_error": 0.001, "low_q_tail": 0.2,
                            "tail_len": 15, "low_q": 12, "high_q": 30},
                "somatic": {"vafs": [0.05, 0.1], "sites_per_vaf": 3}}
PAIRED_TRAFFIC = {"why": "two 6 kb chromosomes at about 160x",
                  "chroms": ["p1", "p2"], "chrom_len": 6000,
                  "reads_per_chrom": 8000, "reads": 16000, "depth": 156,
                  "warmup": "sample"}


def add_paired_layout(root: str) -> str:
    """Copy the paired layout into root's layouts; returns its name."""
    shutil.copy(os.path.join(ROOT, "portbench", "tests", "layouts",
                             "paired_xd.py"),
                os.path.join(root, "portbench", "layouts"))
    return PAIRED_READS["layout"]
