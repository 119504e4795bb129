"""-WindowSize streaming of the port (apps/pisces.call_chromosome_windowed
over lazy .bai readers) against its own whole-chromosome run and against
the reference package's windowed run.

The workload is the synthetic messy BAM of pisces_tpu_torch.synthetic (two
chromosomes of 20 kb, 6,000 reads, seed 1) with its .bai; reads cover every
position, so every window edge cuts through covered pileup. Windowed
bodies must be byte-equal to the whole-chromosome body of the same
options, on both read flows, serial or pipelined. Against the reference
package (its -backend jax with both dispatch thresholds at 1), every field
must agree but the reference-line strand bias, which is held against the
f64 host run (-backend numpy) as tests/test_torch_e2e.py does; with
-backend numpy both packages must be byte-equal.
"""
import os

import pytest
import torch

import conftest  # noqa: F401  (keeps JAX on the CPU)
import pisces_tpu.calling.fast_gvcf as jax_fast_gvcf
import pisces_tpu.io.native as jax_native
from pisces_tpu.apps.pisces import main as jax_main

import pisces_tpu_torch.apps.pisces as torch_app
import pisces_tpu_torch.calling.fast_gvcf as torch_fast_gvcf
import pisces_tpu_torch.io.native as torch_native
from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.entry import compare_vcf_bodies, vcf_body
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.io.vcf_write import VcfWriter, VcfWriterConfig
from pisces_tpu_torch.ops import scoring_kernels as K
from pisces_tpu_torch.options import PiscesApplicationOptions
from pisces_tpu_torch.synthetic import write_synthetic_workload
from test_torch_e2e import candidate_batches_on_device

WINDOWS = ["5000", "7777"]


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("windowed"))
    bam, genome = write_synthetic_workload(tmp, 2, 20_000, 6_000, seed=1,
                                           index=True)
    intervals = os.path.join(tmp, "regions.picard")
    with open(intervals, "w") as f:
        f.write("@HD\tVN:1.6\n")
        f.write("chr1\t1500\t5200\nchr1\t9000\t9050\nchr2\t100\t2500\n")
    return tmp, bam, genome, intervals


@pytest.fixture(scope="module")
def whole_runs():
    """(gvcf, intervals, backend) -> the port's whole-chromosome body."""
    return {}


def _python_flow(monkeypatch):
    """The port's open_bam on the pure-Python reader, lazy or not."""
    monkeypatch.setattr(
        torch_app, "open_bam",
        lambda path, lazy=False: torch_native.open_bam(
            path, prefer_native=False, lazy=lazy))


def _run(main, bam, genome, out, gvcf="true", extra=()):
    assert main(["-bam", bam, "-g", genome, "-o", out, "-gVCF", gvcf,
                 *extra]) == 0
    return vcf_body(os.path.join(
        out, "b.genome.vcf" if gvcf == "true" else "b.vcf"))


def _whole(whole_runs, workload, gvcf, iv, backend):
    tmp, bam, genome, _ = workload
    key = (gvcf, bool(iv), backend)
    if key not in whole_runs:
        whole_runs[key] = _run(
            torch_main, bam, genome,
            os.path.join(tmp, f"whole{gvcf}{len(iv)}{backend}"), gvcf,
            ["-device", "cpu", "-backend", backend, *iv])
    return whole_runs[key]


@pytest.fixture
def pileup_calls(monkeypatch):
    calls = []
    fn = torch_app.native_pileup
    monkeypatch.setattr(torch_app, "native_pileup",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("flow", ["native", "python"])
@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_windowed_equals_whole(workload, whole_runs, monkeypatch,
                               pileup_calls, window, flow, gvcf):
    tmp, bam, genome, _ = workload
    if flow == "python":
        _python_flow(monkeypatch)
    got = _run(torch_main, bam, genome,
               os.path.join(tmp, f"w{window}{flow}{gvcf}"), gvcf,
               ["-device", "cpu", "-WindowSize", window])
    windows = 2 * -(-20_000 // int(window))
    assert len(pileup_calls) == (windows if flow == "native" else 0)
    assert got == _whole(whole_runs, workload, gvcf, [], "torch")
    assert len(got) > (100 if gvcf == "true" else 20)


@pytest.mark.parametrize("flow", ["native", "python"])
def test_windowed_intervals_equal_whole(workload, whole_runs, monkeypatch,
                                        flow):
    tmp, bam, genome, intervals = workload
    if flow == "python":
        _python_flow(monkeypatch)
    iv = ["-IntervalPaths", intervals]
    got = _run(torch_main, bam, genome, os.path.join(tmp, f"wi{flow}"),
               "true", ["-device", "cpu", "-WindowSize", "5000", *iv])
    assert got == _whole(whole_runs, workload, "true", iv, "torch")


def _stream(options, genome_dir, bam, out, threads, prefer_native):
    """Every chromosome through call_chromosome_windowed into one VCF;
    returns (body, the windows' positions arrays)."""
    genome = Genome(genome_dir)
    options.validate()
    positions = []

    def open_lazy():
        return torch_native.open_bam(bam, prefer_native, lazy=True)

    reader = open_lazy()
    with VcfWriter(out, VcfWriterConfig(options), genome.directory, "b.bam",
                   genome.chromosome_lengths, "") as writer:
        writer.write_header()
        for name in genome.chromosome_names:
            chrom = genome.get_chr_reference(name)
            for (alleles, ref_lines), w0, w1 in \
                    torch_app.call_chromosome_windowed(
                        options, chrom, reader,
                        reader.header.ref_index(name), None, "cpu",
                        reader_factory=open_lazy, pipeline_threads=threads):
                assert all(w0 <= a.position <= w1 for a in alleles)
                positions.append(ref_lines[0])
                torch_app.write_spliced(writer, alleles, ref_lines)
    return vcf_body(out), positions


@pytest.mark.parametrize("flow", ["native", "python"])
def test_pipelined_windows_equal_serial(workload, tmp_path, flow):
    _, bam, genome, _ = workload
    o = PiscesApplicationOptions()
    o.window_size = 3_000
    bodies = {}
    for threads in (1, 2, 3):
        bodies[threads], positions = _stream(
            o, genome, bam, str(tmp_path / f"p{threads}.vcf"), threads,
            flow == "native")
        # each window's positions are its own (a zero-copy view into a
        # reader's buffers would be read-only)
        assert all(p.flags.writeable for p in positions)
        assert len(positions) == 2 * 7
    assert bodies[1] == bodies[2] == bodies[3]
    assert len(bodies[1]) > 100


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_windowed_matches_reference_windowed(workload, whole_runs,
                                             monkeypatch, backend):
    tmp, bam, genome, _ = workload
    candidate_batches_on_device(monkeypatch)
    monkeypatch.setattr(jax_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    monkeypatch.setattr(torch_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    w = ["-WindowSize", "5000"]
    port = _run(torch_main, bam, genome, os.path.join(tmp, f"pw{backend}"),
                "true", ["-device", "cpu", "-backend", backend, *w])
    jb = "jax" if backend == "torch" else "numpy"
    ref = _run(jax_main, bam, genome, os.path.join(tmp, f"jw{backend}"),
               "true", ["-backend", jb, *w])
    if backend == "numpy":
        assert port == ref
    else:
        host = _run(jax_main, bam, genome, os.path.join(tmp, "jwhost"),
                    "true", ["-backend", "numpy", *w])
        assert [ln.rpartition(":")[0] for ln in port] == \
            [ln.rpartition(":")[0] for ln in ref]
        compare_vcf_bodies(port, host)
    assert port == _whole(whole_runs, workload, "true", [], backend)


def test_missing_bai_logs_a_warning_and_runs_whole(workload, tmp_path,
                                                   whole_runs, monkeypatch):
    _, bam, genome, _ = workload
    plain = str(tmp_path / "b.bam")
    os.symlink(bam, plain)
    warnings = []
    log = torch_app.log
    monkeypatch.setattr(torch_app, "log", lambda msg, level="INFO":
                        (warnings.append(msg) if level == "WARNING" else None)
                        or log(msg, level))
    got = _run(torch_main, plain, genome, str(tmp_path / "out"), "true",
               ["-device", "cpu", "-WindowSize", "5000"])
    assert got == _whole(whole_runs, workload, "true", [], "torch")
    assert len(warnings) == 2 and all(".bai missing" in w for w in warnings)


def test_mesh_reaches_every_window(workload, whole_runs, monkeypatch):
    from pisces_tpu_torch.parallel import sharding
    tmp, bam, genome, _ = workload
    calls = []
    fn = sharding.sharded_score_reference_positions
    monkeypatch.setattr(sharding, "sharded_score_reference_positions",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    meshes = []
    get_mesh = sharding.get_mesh
    monkeypatch.setattr(sharding, "get_mesh",
                        lambda *a: meshes.append(1) or get_mesh(*a))
    got = _run(torch_main, bam, genome, os.path.join(tmp, "wmesh"), "true",
               ["-device", "cpu", "-WindowSize", "5000", "-MeshDevices",
                "2"])
    assert got == _whole(whole_runs, workload, "true", [], "torch")
    assert len(calls) == 8 and len(meshes) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [1, 2])
def test_windows_launch_the_kernel_on_card(cuda_device, workload,
                                           monkeypatch, tmp_path, threads):
    """On the card, with the tuple threshold at 1: one score_tuples launch
    per window, serial or pipelined, and the body of the f64 host run."""
    _, bam, genome, _ = workload
    monkeypatch.setattr(torch_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    o = PiscesApplicationOptions()
    o.window_size = 5_000
    K.reset_launch_counts()
    torch_native.reset_pileup_calls()
    genome_obj = Genome(genome)
    o.validate()
    reader = torch_native.open_bam(bam, lazy=True)
    n = 0
    for name in genome_obj.chromosome_names:
        for _result, _w0, _w1 in torch_app.call_chromosome_windowed(
                o, genome_obj.get_chr_reference(name), reader,
                reader.header.ref_index(name), None, cuda_device,
                reader_factory=lambda: torch_native.open_bam(bam, lazy=True),
                pipeline_threads=threads):
            n += 1
    torch.cuda.synchronize()
    assert n == 8
    assert K.launch_counts["score_tuples"] == 8
    assert torch_native.pileup_calls == 8
    card = _run(torch_main, bam, genome, str(tmp_path / "card"), "true",
                ["-WindowSize", "5000"])
    host = _run(torch_main, bam, genome, str(tmp_path / "host"), "true",
                ["-WindowSize", "5000", "-backend", "numpy"])
    compare_vcf_bodies(card, host)
