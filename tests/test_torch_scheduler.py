"""The port's schedulers (pisces_tpu_torch/parallel/scheduler.py): threaded
(bam x chr) jobs with ordered or per-chromosome-shard output, and spawned
per-chromosome processes with resume; their CLI routing; and the locks that
keep the native build, its bindings and the launch counts right under
threads.

The workload is the synthetic messy BAM of pisces_tpu_torch.synthetic
(three chromosomes of 20 kb, 6,000 reads, seed 2). Every scheduled run must
be byte-equal to the port's serial process_bam run and to the reference
package's scheduler run of the same options (both on the host f64 path:
no batch reaches a dispatch threshold at this size).
"""
import glob
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (keeps JAX on the CPU)
from pisces_tpu.io.fasta import Genome as JGenome
from pisces_tpu.options import PiscesApplicationOptions as JOptions

import pisces_tpu_torch.apps.pisces as torch_app
from pisces_tpu_torch.apps.pisces import main as torch_main, process_bam
from pisces_tpu_torch.entry import vcf_body
from pisces_tpu_torch.io import native
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.ops import scoring_kernels as K
from pisces_tpu_torch.ops.scoring_params import ScoringParams
from pisces_tpu_torch.options import PiscesApplicationOptions
from pisces_tpu_torch.parallel.scheduler import (
    JobManager, OrderedChromosomeWriter, process_bams_parallel,
    process_chromosomes_multiprocess,
)
from pisces_tpu_torch.synthetic import write_synthetic_workload


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sched"))
    bam, genome = write_synthetic_workload(tmp, 3, 20_000, 6_000, seed=2)
    return tmp, bam, genome


def _options(out_dir, cls=PiscesApplicationOptions):
    o = cls()
    o.output_directory = str(out_dir)
    o.vcf_writing_parameters.output_gvcf_file = True
    return o


@pytest.fixture(scope="module")
def serial(workload):
    """The port's serial body and the reference package's scheduled
    bodies, each run once."""
    from pisces_tpu.parallel import scheduler as jsched
    tmp, bam, genome = workload
    out = process_bam(_options(os.path.join(tmp, "serial")), bam,
                      Genome(genome), device="cpu")
    ref = {}
    for tbc in (False, True):
        ref[tbc] = vcf_body(jsched.process_bams_parallel(
            _options(os.path.join(tmp, f"jpar{tbc}"), JOptions), [bam],
            JGenome(genome), 3, use_device=False, thread_by_chr=tbc)[0])
    ref["mp"] = vcf_body(jsched.process_chromosomes_multiprocess(
        _options(os.path.join(tmp, "jmp"), JOptions), bam, genome, 2,
        False))
    return vcf_body(out), ref


class TestJobManager:
    def test_runs_all_jobs(self):
        results = []
        JobManager(4).process([lambda i=i: results.append(i)
                               for i in range(20)])
        assert sorted(results) == list(range(20))

    @pytest.mark.parametrize("mode", ["terminate", "wait"])
    def test_error_modes_raise(self, mode):
        done = []

        def bad():
            raise ValueError("boom")
        with pytest.raises(ValueError, match="boom"):
            JobManager(1, error_mode=mode).process(
                [bad] + [lambda: done.append(1)] * 5)
        # terminate cancels the jobs not yet started; wait runs them all
        assert (len(done) == 5) == (mode == "wait")

    def test_error_mode_none_swallows(self):
        done = []

        def bad():
            raise ValueError("boom")
        JobManager(2, error_mode="none").process(
            [bad, lambda: done.append(1)])
        assert done == [1]


def test_ordered_writer_emits_in_genome_order():
    ow = OrderedChromosomeWriter(["chr1", "chr2", "chr3"])
    written = []

    def worker():
        time.sleep(0.02)
        ow.submit("chr3", ["c"])
        ow.submit("chr1", ["a"])
        time.sleep(0.02)
        ow.submit("chr2", ["b"])

    t = threading.Thread(target=worker)
    t.start()
    ow.drain(lambda name, alleles: written.append((name, alleles)))
    t.join(timeout=10)
    assert not t.is_alive()
    assert written == [("chr1", ["a"]), ("chr2", ["b"]), ("chr3", ["c"])]


@pytest.mark.parametrize("max_threads", [1, 2, 3])
def test_threads_equal_serial_and_reference(workload, serial, tmp_path,
                                            max_threads):
    _, bam, genome = workload
    body, ref = serial
    outs = process_bams_parallel(_options(tmp_path), [bam], Genome(genome),
                                 max_threads, device="cpu")
    assert vcf_body(outs[0]) == body == ref[False]
    assert len(body) > 100


@pytest.mark.parametrize("flow", ["native", "python"])
def test_thread_by_chr_byte_identical(workload, serial, tmp_path,
                                      monkeypatch, flow):
    _, bam, genome = workload
    body, ref = serial
    if flow == "python":
        monkeypatch.setattr(torch_app, "open_bam", lambda path:
                            native.open_bam(path, prefer_native=False))
    outs = process_bams_parallel(_options(tmp_path), [bam], Genome(genome),
                                 3, device="cpu", thread_by_chr=True)
    assert vcf_body(outs[0]) == body == ref[True]
    assert not glob.glob(str(tmp_path / "*.vcf_*"))


def test_several_bams_each_equal_serial(workload, serial, tmp_path):
    _, bam, genome = workload
    body, _ = serial
    other = str(tmp_path / "copy.bam")
    os.symlink(bam, other)
    outs = process_bams_parallel(_options(tmp_path / "out"), [bam, other],
                                 Genome(genome), 2, device="cpu")
    assert [os.path.basename(p) for p in outs] == ["b.genome.vcf",
                                                   "copy.genome.vcf"]
    assert vcf_body(outs[0]) == vcf_body(outs[1]) == body


def test_multiprocess_shards_and_resume(workload, serial, tmp_path):
    _, bam, genome = workload
    body, ref = serial
    out = process_chromosomes_multiprocess(_options(tmp_path), bam, genome,
                                           2, device="cpu")
    assert vcf_body(out) == body == ref["mp"]
    assert not os.path.exists(tmp_path / "b.progress.json")
    assert not glob.glob(str(tmp_path / "*.vcf_*"))

    # a completed shard on disk is trusted verbatim under resume=True
    shard = tmp_path / "b.vcf_chr2"
    shard.write_text("#CHROM\nchr2\t1\t.\tA\tC\t.\tPASS\tSENTINEL\n")
    out2 = process_chromosomes_multiprocess(_options(tmp_path), bam, genome,
                                            2, device="cpu", resume=True)
    got = vcf_body(out2)
    assert "chr2\t1\t.\tA\tC\t.\tPASS\tSENTINEL" in got
    assert [ln for ln in got if not ln.startswith("chr2")] == \
        [ln for ln in body if not ln.startswith("chr2")]
    assert not os.path.exists(tmp_path / "b.progress.json")


def test_failed_child_fails_the_run_and_resume_finishes(workload, serial,
                                                        tmp_path):
    """A child that dies (its chromosome's reference hidden) fails the
    run; completed shards stay, and resume=True finishes the rest."""
    import shutil
    tmp, bam, genome = workload
    body, _ = serial
    gdir = str(tmp_path / "genome")
    shutil.copytree(genome, gdir)
    fa = os.path.join(gdir, "chr3.fa")
    os.rename(fa, fa + ".hidden")
    with pytest.raises(Exception):
        process_chromosomes_multiprocess(_options(tmp_path), bam, gdir, 1,
                                         device="cpu")
    shards = sorted(os.path.basename(p)
                    for p in glob.glob(str(tmp_path / "b.vcf_chr[0-9]")))
    assert shards == ["b.vcf_chr1", "b.vcf_chr2"]
    os.rename(fa + ".hidden", fa)
    out = process_chromosomes_multiprocess(_options(tmp_path), bam, gdir, 1,
                                           device="cpu", resume=True)
    assert vcf_body(out) == body


@pytest.mark.parametrize("flags", [
    ["-MaxThreads", "2"],
    ["-MaxThreads", "3", "-ThreadByChr", "true"],
    ["-MultiProcess", "true", "-MaxThreads", "2"],
    ["-MultiProcess", "true", "-Resume", "true"],
])
def test_cli_routes_to_the_schedulers(workload, serial, tmp_path,
                                      monkeypatch, flags):
    from pisces_tpu_torch.parallel import scheduler
    _, bam, genome = workload
    body, _ = serial
    calls = []
    for name in ("process_bams_parallel", "process_chromosomes_multiprocess"):
        fn = getattr(scheduler, name)
        monkeypatch.setattr(scheduler, name, lambda *a, _fn=fn, _n=name,
                            **k: calls.append(_n) or _fn(*a, **k))
    assert torch_main(["-bam", bam, "-g", genome, "-o", str(tmp_path),
                       "-gVCF", "true", "-device", "cpu", *flags]) == 0
    assert vcf_body(str(tmp_path / "b.genome.vcf")) == body
    assert calls == ["process_chromosomes_multiprocess"
                     if "-MultiProcess" in flags else
                     "process_bams_parallel"]


def test_native_build_and_bindings_once_under_threads(monkeypatch):
    """Eight threads that start the first build and binding at once get
    one library, loaded once."""
    lib = native.build_native()
    monkeypatch.setattr(native, "_native", None)
    loads = []
    real = native.NativeLibrary
    monkeypatch.setattr(native, "NativeLibrary", lambda *a: loads.append(1)
                        or real(*a))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got, errors = [], []
    barrier = threading.Barrier(8)

    def worker():
        try:
            barrier.wait(timeout=10)
            got.append((native.build_native(), native.get_lib()))
        except Exception as e:  # reported below
            errors.append(e)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and len(got) == 8
    assert len({id(b) for b, _ in got}) == 1
    assert len({id(l) for _, l in got}) == 1
    assert got[0][0].path == lib.path


class _FakeKernels:
    """A kernel library whose launch does nothing: _launch's bookkeeping
    alone, on CPU tensors."""

    def bind(self, name, inputs, out, params):
        return lambda: None


def test_launch_and_pileup_counts_exact_under_threads(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(K, "build_kernels", lambda: _FakeKernels())
    bam, _ = write_synthetic_workload(str(tmp_path / "w"), 1, 5_000, 300,
                                      seed=3)
    readers = [native.open_bam(bam) for _ in range(4)]
    K.reset_launch_counts()
    native.reset_pileup_calls()
    tuples = torch.zeros((4, 6), dtype=torch.int32)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker(reader):
        batch = reader.fetch(ref_id=0, as_views=True)
        keep = np.ones(batch.n, bool)
        for _ in range(50):
            K._launch("score_tuples", (tuples, None), 4, ScoringParams())
            native.native_pileup(reader, keep, 20, 5)
    try:
        threads = [threading.Thread(target=worker, args=(readers[i % 4],))
                   for i in range(4)] + [
            threading.Thread(target=lambda: [
                K._launch("score_loci", (tuples, None), 4, ScoringParams())
                for _ in range(200)]) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert K.launch_counts == {"score_tuples": 200, "score_loci": 800}
    assert native.pileup_calls == 200


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("thread_by_chr", [False, True])
def test_threads_launch_once_per_chromosome_on_card(cuda_device, workload,
                                                    tmp_path, monkeypatch,
                                                    thread_by_chr):
    """On the card, with the tuple threshold at 1: the pool's threads
    launch score_tuples once per chromosome, counted exactly, and the body
    equals the serial run on the card."""
    import pisces_tpu_torch.calling.fast_gvcf as fast_gvcf
    _, bam, genome = workload
    monkeypatch.setattr(fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    serial_out = process_bam(_options(tmp_path / "serial"), bam,
                             Genome(genome), device=cuda_device)
    K.reset_launch_counts()
    outs = process_bams_parallel(_options(tmp_path / "par"), [bam],
                                 Genome(genome), 3, device=cuda_device,
                                 thread_by_chr=thread_by_chr)
    torch.cuda.synchronize()
    assert K.launch_counts["score_tuples"] == 3
    assert vcf_body(outs[0]) == vcf_body(serial_out)
