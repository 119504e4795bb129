"""The port's metric registry (pisces_tpu_torch/utils/metrics.py): stage
spans with their parents, threads and samples; the span buffer's capacity;
stages on more threads than cores; the interpreter's collections on four
threads; spans handed across the scheduler's pool and drain threads and the
window pipeline's workers; the spans a sample records, which must not grow
with depth; the spans in -profiledir's trace.json; and the caller's counts
of SNV rows held as columns and of rows made objects, against the object
path on the same run.

The workloads are the synthetic messy BAM of pisces_tpu_torch.synthetic:
two chromosomes of 20 kb with a .bai, at 6,000 and at 24,000 reads (seed
1). The `pisces_tpu` package's registry has tests of its own
(tests/test_metrics.py).
"""
import collections
import gc
import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

import pisces_tpu_torch.apps.pisces as torch_app
import pisces_tpu_torch.calling.caller as torch_caller
import pisces_tpu_torch.calling.collapser as torch_collapser
import pisces_tpu_torch.calling.fast_gvcf as torch_fast_gvcf
from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.io import native
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.options import PiscesApplicationOptions
from pisces_tpu_torch.domain.types import AlleleCategory
from pisces_tpu_torch.synthetic import write_sites_vcf, write_synthetic_workload
from pisces_tpu_torch.utils.metrics import SPAN_PID, Metrics, metrics

STEPS = {"allele_calling.prepare", "allele_calling.coverage",
         "allele_calling.scoring", "allele_calling.filters",
         "allele_calling.genotype"}


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("metrics"))
    out = {}
    for name, reads in (("shallow", 6_000), ("deep", 24_000)):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        out[name] = write_synthetic_workload(d, 2, 20_000, reads, seed=1,
                                             index=True)
    return out


def _sample(bam, genome, out, extra=()):
    """One CLI run from an empty registry: (its sample span, every span
    recorded in it)."""
    metrics.reset()
    assert torch_main(["-bam", bam, "-g", genome, "-o", out, "-gVCF",
                       "true", "-device", "cpu", *extra]) == 0
    spans = metrics.spans()
    roots = [s for s in spans if s.name == "sample"]
    assert len(roots) == 1
    return roots[0], spans


def _chain_ends_at(span, by_id, root):
    while span.parent is not None:
        span = by_id[span.parent]
    return span is root


def test_stages_nest_under_their_parents():
    m = Metrics()
    with m.sample():
        with m.stage("a"):
            with m.stage("b"):
                pass
        with m.stage("c", cpu=True):
            sum(range(10_000))
    with m.stage("outside"):
        pass
    spans = m.spans()
    assert [s.name for s in spans] == ["b", "a", "c", "sample", "outside"]
    by = {s.name: s for s in spans}
    root = by["sample"]
    assert root.parent is None and root.sample == root.id
    assert by["a"].parent == root.id and by["c"].parent == root.id
    assert by["b"].parent == by["a"].id
    assert {by[n].sample for n in "abc"} == {root.id}
    assert by["outside"].parent is None and by["outside"].sample is None
    assert (root.start <= by["a"].start <= by["b"].start <= by["b"].end
            <= by["a"].end <= by["c"].start <= by["c"].end <= root.end)
    assert by["c"].cpu_s is not None and by["c"].cpu_s >= 0
    assert by["a"].cpu_s is None
    assert {s.thread for s in spans} == {threading.get_native_id()}
    stages = m.snapshot()["stages"]
    assert stages["a"]["calls"] == 1 and stages["sample"]["calls"] == 1
    # a stage that raises still closes, and leaves no span open
    with pytest.raises(ValueError):
        with m.stage("raises"):
            raise ValueError
    assert m.spans()[-1].name == "raises" and m.open_spans() == []


def test_carry_hands_the_open_span_to_another_thread():
    m = Metrics()

    def work():
        with m.stage("worker"):
            pass
        return threading.get_native_id()

    with ThreadPoolExecutor(max_workers=1) as pool:
        with m.sample():
            with m.stage("submit"):
                carried = m.carry(work)
            tid = pool.submit(carried).result()
            # the same pool thread, handed nothing: a root of its own
            pool.submit(work).result()
    by = {s.name: s for s in m.spans() if s.name != "worker"}
    carried_span, plain = [s for s in m.spans() if s.name == "worker"]
    assert carried_span.parent == by["submit"].id
    assert carried_span.sample == by["sample"].id
    assert carried_span.thread == tid != threading.get_native_id()
    assert plain.parent is None and plain.sample is None
    assert plain.thread == tid
    # nothing open: carry returns the function itself
    assert m.carry(work) is work


def test_buffer_keeps_its_capacity():
    m = Metrics(capacity=8)
    for i in range(20):
        with m.stage(f"s{i}"):
            pass
    spans = m.spans()
    assert [s.name for s in spans] == [f"s{i}" for i in range(12, 20)]
    # the totals keep every call
    assert sum(v["calls"] for v in m.snapshot()["stages"].values()) == 20
    m.reset()
    assert m.spans() == [] and m.snapshot()["stages"] == {}


def test_stages_on_many_threads_lose_no_update():
    """More threads than cores, switching often: every stage counts, every
    span is kept, and each nested span's parent opened on its own thread."""
    m = Metrics(capacity=20_000)
    n_threads, n_iter = max(16, 2 * (os.cpu_count() or 1)), 300

    def work():
        for _ in range(n_iter):
            with m.stage("outer"):
                with m.stage("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    stages = m.snapshot()["stages"]
    assert stages["outer"]["calls"] == stages["inner"]["calls"] == \
        n_threads * n_iter
    spans = m.spans()
    assert len(spans) == 2 * n_threads * n_iter
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer"
            assert by_id[s.parent].thread == s.thread
        else:
            assert s.parent is None


def test_gc_pauses_on_four_threads_are_counted():
    """Collections forced inside stages on four threads, one of them with
    the registry's lock held: all finish, and their pauses count."""
    metrics.reset()
    errors = []

    def work(i):
        try:
            for _ in range(3):
                with metrics.stage("gc_work"):
                    junk = [[j] for j in range(20_000)]
                    if i == 0:
                        with metrics._lock:
                            gc.collect()
                    else:
                        gc.collect()
                    del junk
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a collection hung"
    assert errors == []
    counters = metrics.snapshot()["counters"]
    assert counters["gc_pause_s"] > 0
    assert counters["gc_collections"] >= 4
    assert metrics.snapshot()["stages"]["gc_work"]["calls"] == 12


def test_scheduled_run_spans_reach_their_sample(workload, tmp_path,
                                                monkeypatch):
    """-MaxThreads 2 on two chromosomes: every span carries the sample's
    id, and its parent chain ends at the sample across the pool and drain
    threads; the five caller steps tile each allele_calling; the device
    branches (taken here on the CPU device) are card_round_trip spans."""
    bam, genome = workload["shallow"]
    monkeypatch.setattr(torch_caller, "DEVICE_BATCH_THRESHOLD", 1)
    monkeypatch.setattr(torch_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    root, spans = _sample(bam, genome, str(tmp_path / "o"),
                          ["-MaxThreads", "2"])
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.sample == root.id, s
        assert _chain_ends_at(s, by_id, root), s
    names = collections.Counter(s.name for s in spans)
    jobs = [s for s in spans if s.name == "scheduler.job"]
    assert len(jobs) == 2
    assert all(j.parent == root.id and j.cpu_s >= 0 for j in jobs)
    assert root.thread not in {j.thread for j in jobs}
    # the whole-file opens happen in the jobs
    assert names["bam_open"] >= 1
    assert {by_id[s.parent].name for s in spans
            if s.name == "bam_open"} == {"scheduler.job"}
    # the ordered writer's drain thread writes the chromosomes
    writes = [s for s in spans if s.name == "vcf_write"]
    assert len(writes) == 2
    assert all(w.parent == root.id for w in writes)
    assert not {w.thread for w in writes} & (
        {root.thread} | {j.thread for j in jobs})
    callers = [s for s in spans if s.name == "allele_calling"]
    assert len(callers) == 2
    for ac in callers:
        parts = sorted((s for s in spans if s.parent == ac.id),
                       key=lambda s: s.start)
        assert {p.name for p in parts} == STEPS
        assert ac.start <= parts[0].start and parts[-1].end <= ac.end
        assert all(a.end <= b.start for a, b in zip(parts, parts[1:]))
        assert sum(p.end - p.start for p in parts) >= 0.7 * (ac.end
                                                             - ac.start)
    trips = [s for s in spans if s.name == "card_round_trip"]
    assert {by_id[t.parent].name for t in trips} == {
        "allele_calling.scoring", "gvcf_scoring"}


def test_pipelined_windows_nest_under_the_sample(workload):
    """call_chromosome_windowed on two pipeline threads: each window is a
    span on a worker thread under the span open where it was handed over,
    with its thread's CPU seconds, and each stage nests in its window."""
    bam, genome_dir = workload["shallow"]
    o = PiscesApplicationOptions()
    o.window_size = 5_000
    o.validate()
    genome = Genome(genome_dir)
    chrom = genome.get_chr_reference(genome.chromosome_names[0])

    def open_lazy():
        return native.open_bam(bam, lazy=True)

    reader = open_lazy()
    metrics.reset()
    with metrics.sample():
        results = list(torch_app.call_chromosome_windowed(
            o, chrom, reader, reader.header.ref_index(chrom.name), None,
            "cpu", reader_factory=open_lazy, pipeline_threads=2))
    spans = metrics.spans()
    root = spans[-1]
    assert root.name == "sample"
    by_id = {s.id: s for s in spans}
    windows = [s for s in spans if s.name == "window"]
    assert len(windows) == len(results) == 4
    assert all(w.parent == root.id and w.sample == root.id
               and w.cpu_s is not None for w in windows)
    assert len({w.thread for w in windows}) == 2
    assert root.thread not in {w.thread for w in windows}
    for s in spans:
        if s.name in ("sample", "window"):
            continue
        up = s
        while up.name != "window":
            up = by_id[up.parent]
        assert up.thread == s.thread and up.start <= s.start <= s.end \
            <= up.end


@pytest.mark.parametrize("flags", [[], ["-WindowSize", "5000"]],
                         ids=["whole", "windows"])
def test_spans_a_sample_do_not_grow_with_depth(workload, tmp_path, flags):
    """The same spans, by name and number, at 6,000 and 24,000 reads: none
    is recorded per read, candidate, allele or locus."""
    counts = []
    for key in ("shallow", "deep"):
        bam, genome = workload[key]
        _root, spans = _sample(bam, genome, str(tmp_path / key),
                               ["-backend", "numpy", *flags])
        counts.append(collections.Counter(s.name for s in spans))
    assert counts[0] == counts[1]
    assert counts[0]["sample"] == 1
    assert counts[0]["allele_calling"] == counts[0]["pileup"] >= 2
    assert sum(counts[0].values()) <= 25 * counts[0]["allele_calling"]


def test_profiledir_trace_holds_the_spans(workload, tmp_path):
    """-profiledir's trace.json holds every span of the run as a complete
    event of the spans' own process row, one track a thread, with times
    in the order the spans ran (the host clock from the profile's start,
    without a card), each inside its parent."""
    bam, genome = workload["shallow"]
    prof = tmp_path / "prof"
    root, spans = _sample(bam, genome, str(tmp_path / "o"),
                          ["-MaxThreads", "2", "-profiledir", str(prof)])
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    ours = [e for e in trace["traceEvents"] if e.get("pid") == SPAN_PID]
    events = {e["args"]["id"]: e for e in ours if e["ph"] == "X"}
    # the stages, and the sample that was still open at the export
    assert set(events) == {s.id for s in spans}
    for s in spans:
        e = events[s.id]
        assert e["name"] == s.name and e["tid"] == s.thread
        assert e["ts"] >= 0 and e["dur"] >= 0
        if s.name != "sample":
            assert e["dur"] == pytest.approx((s.end - s.start) * 1e6,
                                             abs=0.01)
        if s.parent is not None:
            p = events[s.parent]
            assert p["ts"] <= e["ts"] + 0.01
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 0.01
    order = sorted(spans, key=lambda s: s.start)
    assert [events[s.id]["ts"] for s in order] == sorted(
        events[s.id]["ts"] for s in order)
    assert events[root.id]["ts"] == 0.0
    # one track a thread: the sample's, each job's, the drain thread's
    tracks = {e["tid"] for e in ours
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tracks == {s.thread for s in spans}
    job_tracks = {events[s.id]["tid"] for s in spans
                  if s.name == "scheduler.job"}
    assert len(job_tracks) == 2 and events[root.id]["tid"] not in job_tracks


def _caller_run(bam, genome, out, extra, monkeypatch, objects_only):
    """One CLI run; returns its counters, the SNV rows left after each
    collapse and the SNV alleles each call reported (objects_only: each
    call given its SNV rows as objects)."""
    after_collapse, reported = [], []
    collapse = torch_collapser.VariantCollapser.collapse
    call = torch_caller.AlleleCaller.call

    def spy_collapse(self, *a, **k):
        kept = collapse(self, *a, **k)
        after_collapse.append(sum(c.category == AlleleCategory.SNV
                                  and not c.is_forced for c in kept))
        return kept

    def spy_call(self, candidates, source, snvs=None):
        if objects_only and snvs is not None:
            candidates, snvs = snvs.to_candidates() + candidates, None
        by_position = call(self, candidates, source, snvs)
        reported.append(sum(a.category == AlleleCategory.SNV
                            for lst in by_position.values() for a in lst))
        return by_position

    with monkeypatch.context() as m:
        m.setattr(torch_collapser.VariantCollapser, "collapse", spy_collapse)
        m.setattr(torch_caller.AlleleCaller, "call", spy_call)
        _sample(bam, genome, out, extra)
    return metrics.snapshot()["counters"], after_collapse, reported


@pytest.mark.parametrize("forced", [False, True], ids=["plain", "forced"])
def test_caller_counts_its_columnar_rows(workload, tmp_path, monkeypatch,
                                         forced):
    """caller_rows_columnar is the SNV rows left after collapse and
    caller_rows_materialized the SNV alleles reported (called, or forced
    while not callable), both read off the object path's run of the same
    sample; candidates_scored is the same on both paths. The forced case
    forces, on each chromosome, the strongest SNV row and the weakest."""
    bam, genome = workload["shallow"]
    extra = ["-backend", "numpy"]
    if forced:
        sites = []
        aggregate = torch_app.aggregate_native_mismatches

        def spy(*a):
            snvs = aggregate(*a)
            sup = snvs.support_by_direction.sum(axis=1)
            for i in (int(sup.argmax()), int(sup.argmin())):
                sites.append((snvs.chromosome, int(snvs.position[i]),
                              chr(snvs.ref_base[i]), chr(snvs.alt_base[i])))
            return snvs

        with monkeypatch.context() as m:
            m.setattr(torch_app, "aggregate_native_mismatches", spy)
            _sample(bam, genome, str(tmp_path / "sites"), extra)
        assert len(sites) == 4
        extra += ["-ForcedAlleles",
                  write_sites_vcf(str(tmp_path / "forced.vcf"), sites)]
    got, _, got_reported = _caller_run(bam, genome, str(tmp_path / "c"),
                                       extra, monkeypatch, False)
    want, want_rows, want_reported = _caller_run(
        bam, genome, str(tmp_path / "o"), extra, monkeypatch, True)
    assert got_reported == want_reported
    assert got["caller_rows_columnar"] == sum(want_rows) > 0
    assert got["caller_rows_materialized"] == sum(want_reported) > 0
    assert got["caller_rows_materialized"] < got["caller_rows_columnar"]
    assert "caller_rows_columnar" not in want
    assert got["candidates_scored"] == want["candidates_scored"] \
        > got["caller_rows_columnar"]


@pytest.mark.parametrize("method", ["approximate", "exact"])
def test_caller_counts_its_spanning_columns(workload, tmp_path, monkeypatch,
                                            method):
    """caller_spanning_columnar is every deletion, insertion and MNV the
    caller scored, under the default coverage method; -CoverageMethod
    exact keeps its per-allele exact_spanning_coverage, and the counter
    reads 0."""
    import pisces_tpu_torch.ops.exact_coverage as exact_coverage
    bam, genome = workload["shallow"]
    spanning = (AlleleCategory.DELETION, AlleleCategory.INSERTION,
                AlleleCategory.MNV)
    scored, exact_calls = [], []
    coverage = torch_caller.AlleleCaller._coverage
    exact = exact_coverage.exact_spanning_coverage

    def spy(self, source, alleles):
        scored.append(sum(a.category in spanning for a in alleles))
        return coverage(self, source, alleles)

    def spy_exact(*a, **k):
        exact_calls.append(1)
        return exact(*a, **k)

    extra = ["-backend", "numpy"]
    if method == "exact":
        extra += ["-CoverageMethod", "exact"]
    with monkeypatch.context() as m:
        m.setattr(torch_caller.AlleleCaller, "_coverage", spy)
        m.setattr(exact_coverage, "exact_spanning_coverage", spy_exact)
        _sample(bam, genome, str(tmp_path / "o"), extra)
    got = metrics.snapshot()["counters"].get("caller_spanning_columnar", 0)
    assert sum(scored) > 10
    if method == "exact":
        assert got == 0
        assert len(exact_calls) == sum(scored)
    else:
        assert got == sum(scored)
        assert exact_calls == []
