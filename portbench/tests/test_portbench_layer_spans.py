"""The per-layer readers of the program's own spans and counters, each on a
hand-built run dict and span set: the expected value, and None where its
stage, counter or samples are missing."""
import types

import pytest

from pisces_tpu_torch.utils import metrics as metrics_mod
from pisces_tpu_torch.utils.metrics import Span

from portbench import run

STEPS = ("prepare", "coverage", "scoring", "filters", "genotype")
ONE_JOB = tuple(f"caller_{k}_us_per_cand" for k in STEPS) + (
    "card_round_trip_ms_per_sample", "bam_open_s_per_Mread",
    "gc_pause_pct", "untraced_pct")


def _run(**over):
    r = {"reads": 2_000_000, "samples": 2, "window_s": 40.0,
         "stages": {f"allele_calling.{k}": 0.5 * (i + 1)
                    for i, k in enumerate(STEPS)},
         "counters": {"candidates_scored": 250_000.0, "gc_pause_s": 0.8},
         "launches": {}, "device": None}
    r["stages"].update(card_round_trip=0.004, bam_open=3.0)
    r.update(over)
    return r


def _readers(name):
    """The reader and, where the metric has one, its .one_job twin."""
    names = [name] + ([name + ".one_job"] if name in ONE_JOB else [])
    return [run.load_reader(n) for n in names]


def _span(name, start, end, id_, parent, sample, thread=1, cpu_s=None):
    return Span(name, start, end, thread, id_, parent, sample, cpu_s)


def _spans():
    """A warm-up sample, then two window samples of 10 s each:
    sample 10 (t 100-110) runs two jobs on two threads, both inside
    100-108 (the union of the jobs is 100-108), whose stages leave
    100-101 and 107-110 untraced; sample 20 (t 200-210) runs one window
    whose stages cover 201-209."""
    return [
        _span("sample", 0, 5, 1, None, 1),
        _span("pileup", 1, 4, 2, 1, 1),
        # sample 10
        _span("bam_open", 101, 102, 12, 11, 10, thread=2),
        _span("allele_calling", 102, 106, 13, 11, 10, thread=2),
        _span("allele_calling.scoring", 103, 104, 14, 13, 10, thread=2),
        _span("scheduler.job", 100, 106, 11, 10, 10, thread=2, cpu_s=5.0),
        _span("pileup", 103, 107, 16, 15, 10, thread=3),
        _span("scheduler.job", 102, 108, 15, 10, 10, thread=3, cpu_s=3.0),
        _span("sample", 100, 110, 10, None, 10),
        # sample 20
        _span("bam_fetch", 201, 205, 22, 21, 20),
        _span("allele_calling", 205, 209, 23, 21, 20),
        _span("window", 200.5, 209.5, 21, 20, 20, cpu_s=8.0),
        _span("sample", 200, 210, 20, None, 20),
    ]


@pytest.fixture
def program_spans(monkeypatch):
    """Point the program's registry at a hand-built span list."""
    holder = {"spans": _spans()}
    monkeypatch.setattr(metrics_mod.metrics, "spans",
                        lambda: list(holder["spans"]))
    return holder


@pytest.mark.parametrize("i,step", list(enumerate(STEPS)))
def test_caller_steps(i, step):
    name = f"caller_{step}_us_per_cand"
    for read in _readers(name):
        assert read(_run()) == pytest.approx(0.5 * (i + 1) * 1e6 / 250_000)
        stages = {k: v for k, v in _run()["stages"].items()
                  if k != f"allele_calling.{step}"}
        assert read(_run(stages=stages)) is None
        assert read(_run(counters={"gc_pause_s": 1.0})) is None


@pytest.mark.parametrize("name,stage,expected", [
    ("card_round_trip_ms_per_sample", "card_round_trip", 2.0),
    ("bam_open_s_per_Mread", "bam_open", 1.5),
])
def test_stage_readers(name, stage, expected):
    for read in _readers(name):
        assert read(_run()) == pytest.approx(expected)
        stages = {k: v for k, v in _run()["stages"].items() if k != stage}
        assert read(_run(stages=stages)) is None


def test_gc_pause_pct():
    for read in _readers("gc_pause_pct"):
        assert read(_run()) == pytest.approx(2.0)
        assert read(_run(counters={"candidates_scored": 1.0})) is None


def test_untraced_pct(program_spans):
    # sample 10: stages cover 101-107 of 100-110 (4 s untraced); sample
    # 20: 201-209 of 200-210 (2 s); the warm-up sample is not read
    for read in _readers("untraced_pct"):
        assert read(_run()) == pytest.approx(100.0 * 6 / 20)
        assert read(_run(samples=1)) == pytest.approx(100.0 * 2 / 10)
        assert read(_run(samples=4)) is None


def test_worker_cores_busy(program_spans):
    read = run.load_reader("worker_cores_busy")
    # jobs: 8 CPU s over 100-108; the window: 8 CPU s over 200.5-209.5
    assert read(_run()) == pytest.approx(16.0 / 17.0)
    assert read(_run(samples=1)) == pytest.approx(8.0 / 9.0)
    # a window inside a job counts once, in the job
    program_spans["spans"].insert(0, _span(
        "window", 103, 105, 30, 11, 10, thread=2, cpu_s=2.0))
    assert read(_run()) == pytest.approx(16.0 / 17.0)
    # no job or window spans in the window's samples
    program_spans["spans"] = [s for s in program_spans["spans"]
                              if s.name not in ("scheduler.job", "window")]
    assert read(_run()) is None


def test_span_readers_without_the_programs_spans(monkeypatch):
    """A program whose registry keeps no spans (an older checkout): the
    readers return None and raise nothing."""
    monkeypatch.setattr(metrics_mod, "metrics",
                        types.SimpleNamespace(snapshot=lambda: {}))
    for name in ("untraced_pct", "worker_cores_busy"):
        for read in _readers(name):
            assert read(_run()) is None


def test_span_readers_on_an_empty_window(program_spans):
    for name in ("untraced_pct", "worker_cores_busy"):
        for read in _readers(name):
            assert read(_run(samples=0)) is None
