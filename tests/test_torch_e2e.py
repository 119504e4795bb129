"""The port end to end against the reference package, and the port's
isolation from JAX and from the reference package.

Both packages call the same synthetic messy BAM (written by the port's own
generator, which makes the reference bench's workload). Both dispatch
thresholds are forced to 1, so every unique reference tuple and every
candidate batch goes through the device code of each package: the tuple
kernel's plain version and torch_scoring in the port (on the CPU), the XLA
functions in the reference package. The runs are parametrized over the read
flow, the same in both packages: "native", each package's default open_bam
(the C++ decode and pileup pass), and "python", open_bam(prefer_native=False)
in both (the pure-Python reader, read events and the count build: torch in
the port, the JAX scatter in the reference package).

VCF and gVCF bodies must agree on every field except the reference-line
strand bias. The port takes it from the tuple kernel's fixed 64-term series
(the Pallas kernel's math), the reference package from XLA's f32 igamma,
which underflows to -inf (written -100.0000) on deep-bias loci where the
series still holds the f64 value. So the reference-line SB is held against
the f64 host oracle (-backend numpy): within 1e-3 dB above -40 dB and 5%
below, the Pallas kernel's own tolerances (tests/test_pallas_scoring.py).
With -backend numpy both packages are all-host f64 and must be
byte-equal.

-MeshDevices N runs are held the same way against the reference package's
-MeshDevices N (its shard_map step on conftest's 8 virtual XLA CPU
devices), and must be byte-equal to the port's own single-device run: the
mesh's counts kernel and the single-device tuple kernel run the same f32
math on the same integer sums. entry() and dryrun_multichip, the port's
counterparts of the reference package's __graft_entry__, are held against
it.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import conftest  # noqa: F401  (keeps JAX on the CPU)
import pisces_tpu.calling.fast_gvcf as jax_fast_gvcf
import pisces_tpu.io.native as jax_native
from pisces_tpu.apps.pisces import main as jax_main
import numpy as np

import pisces_tpu_torch.apps.pisces as torch_app
import pisces_tpu_torch.calling.fast_gvcf as torch_fast_gvcf
import pisces_tpu_torch.io.native as torch_native
from pisces_tpu_torch import entry as torch_entry
from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.synthetic import write_synthetic_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("e2e"))
    bam, genome = write_synthetic_workload(tmp, 2, 20_000, 6_000, seed=1)
    intervals = os.path.join(tmp, "regions.picard")
    with open(intervals, "w") as f:
        f.write("@HD\tVN:1.6\n")
        f.write("chr1\t1500\t4200\nchr1\t9000\t9050\nchr2\t100\t2500\n")
    return tmp, bam, genome, intervals


@pytest.fixture
def device_everywhere(monkeypatch):
    monkeypatch.setenv("PISCES_DEVICE_BATCH_THRESHOLD", "1")
    monkeypatch.setattr(jax_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    monkeypatch.setattr(torch_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)


@pytest.fixture(params=["native", "python"])
def flow(request, monkeypatch):
    """Both packages on one read flow: "native" leaves each package's
    default open_bam; "python" opens with prefer_native=False in both."""
    if request.param == "python":
        jax_open = jax_native.open_bam
        monkeypatch.setattr(
            jax_native, "open_bam",
            lambda path, prefer_native=True, lazy=False:
            jax_open(path, prefer_native=False, lazy=lazy))
        monkeypatch.setattr(
            torch_app, "open_bam",
            lambda path: torch_native.open_bam(path, prefer_native=False))
    return request.param


@pytest.fixture
def flow_counts(monkeypatch):
    """Calls of the port's native pileup pass and of its Python event
    build during a test."""
    calls = {"native_pileup": 0, "build_base_events": 0}
    for name in calls:
        fn = getattr(torch_app, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(torch_app, name, counted)
    return calls


def _run(main, bam, genome, out, gvcf, extra=()):
    assert main(["-bam", bam, "-g", genome, "-o", out, "-gVCF", gvcf,
                 *extra]) == 0
    stem = os.path.basename(bam)[:-len(".bam")]
    name = f"{stem}.genome.vcf" if gvcf == "true" else f"{stem}.vcf"
    with open(os.path.join(out, name)) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("#")]


def _split_sb(line):
    """(line without the reference-line SB value, that SB or None)."""
    f = line.split("\t")
    if f[4] != "." or not f[8].endswith(":SB"):
        return line, None
    head, _, sb = line.rpartition(":")
    return head, float(sb)


def _assert_same_calls(port, ref, host):
    """Every field of `port` equal to `ref`'s, except the reference-line SB,
    which is held against the f64 `host` run (1e-3 dB above -40 dB, 5%
    below)."""
    assert len(port) == len(ref) == len(host) > 0
    for a, b, h in zip(port, ref, host):
        (ha, sa), (hb, _), (hh, sh) = _split_sb(a), _split_sb(b), _split_sb(h)
        assert ha == hb == hh, (a, b, h)
        if sa is not None:
            tol = 1e-3 if sh > -40.0 else 0.05 * abs(sh)
            assert abs(sa - sh) <= tol, (a, h)


@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_torch_backend_matches_jax(workload, device_everywhere, flow, gvcf):
    tmp, bam, genome, _ = workload
    tag = f"{flow}{gvcf}"
    port = _run(torch_main, bam, genome, os.path.join(tmp, f"t{tag}"), gvcf,
                ["-backend", "torch", "-device", "cpu"])
    ref = _run(jax_main, bam, genome, os.path.join(tmp, f"j{tag}"), gvcf,
               ["-backend", "jax"])
    host = _run(jax_main, bam, genome, os.path.join(tmp, f"jh{tag}"), gvcf,
                ["-backend", "numpy"])
    _assert_same_calls(port, ref, host)
    if gvcf == "false":
        assert port == ref   # variant lines carry host-f64 SB on both sides


@pytest.mark.parametrize("with_intervals", [False, True])
@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_numpy_backends_byte_equal(workload, flow, gvcf, with_intervals):
    tmp, bam, genome, intervals = workload
    iv = ["-IntervalPaths", intervals] if with_intervals else []
    tag = f"{flow}{gvcf}{int(with_intervals)}"
    port = _run(torch_main, bam, genome, os.path.join(tmp, f"tn{tag}"),
                gvcf, ["-backend", "numpy", "-device", "cpu", *iv])
    ref = _run(jax_main, bam, genome, os.path.join(tmp, f"jn{tag}"),
               gvcf, ["-backend", "numpy", *iv])
    assert port == ref


@pytest.mark.parametrize("gvcf", ["true", "false"])
@pytest.mark.parametrize("with_intervals", [False, True])
def test_native_flow_byte_equal_to_python_flow(workload, monkeypatch,
                                               with_intervals, gvcf):
    """The port's native flow against its own Python flow, -backend
    numpy: every VCF and gVCF body byte-equal."""
    tmp, bam, genome, intervals = workload
    iv = ["-IntervalPaths", intervals] if with_intervals else []
    args = [gvcf, ["-backend", "numpy", "-device", "cpu", *iv]]
    tag = f"{gvcf}{int(with_intervals)}"
    nat = _run(torch_main, bam, genome, os.path.join(tmp, f"fn{tag}"), *args)
    monkeypatch.setattr(
        torch_app, "open_bam",
        lambda path: torch_native.open_bam(path, prefer_native=False))
    py = _run(torch_main, bam, genome, os.path.join(tmp, f"fp{tag}"), *args)
    assert nat == py


def test_intervals_match_jax(workload, device_everywhere, flow):
    tmp, bam, genome, intervals = workload
    port = _run(torch_main, bam, genome, os.path.join(tmp, f"ti{flow}"),
                "true", ["-device", "cpu", "-IntervalPaths", intervals])
    ref = _run(jax_main, bam, genome, os.path.join(tmp, f"ji{flow}"), "true",
               ["-IntervalPaths", intervals])
    host = _run(jax_main, bam, genome, os.path.join(tmp, f"jhi{flow}"),
                "true", ["-backend", "numpy", "-IntervalPaths", intervals])
    _assert_same_calls(port, ref, host)
    # interval padding: every interval position has a line, chr2 included
    assert sum(ln.startswith("chr1\t") for ln in port) == 2701 + 51
    assert sum(ln.startswith("chr2\t") for ln in port) == 2401


@pytest.fixture(scope="module")
def reference_runs():
    """Runs shared by the mesh cases: (package, intervals) -> VCF body."""
    return {}


@pytest.mark.parametrize("with_intervals", [False, True])
@pytest.mark.parametrize("mesh", ["2", "8"])
def test_mesh_matches_jax_mesh_and_single_device(workload, device_everywhere,
                                                 flow, reference_runs,
                                                 monkeypatch, mesh,
                                                 with_intervals):
    from pisces_tpu_torch.parallel import sharding
    tmp, bam, genome, intervals = workload
    iv = ["-IntervalPaths", intervals] if with_intervals else []
    tag = f"m{mesh}{'i' if with_intervals else ''}{flow}"
    calls = []
    for name in ("sharded_score_reference_positions",
                 "sharded_score_snv_tuples"):
        fn = getattr(sharding, name)
        monkeypatch.setattr(sharding, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    port = _run(torch_main, bam, genome, os.path.join(tmp, f"t{tag}"),
                "true", ["-device", "cpu", "-MeshDevices", mesh, *iv])
    # both chromosomes' reference loci and candidates crossed the mesh
    assert calls.count("sharded_score_reference_positions") == 2
    assert calls.count("sharded_score_snv_tuples") >= 2
    ref = _run(jax_main, bam, genome, os.path.join(tmp, f"j{tag}"), "true",
               ["-backend", "jax", "-MeshDevices", mesh, *iv])
    for name, main, extra in (
            ("host", jax_main, ["-backend", "numpy"]),
            ("single", torch_main, ["-device", "cpu"])):
        key = (name, with_intervals, flow)
        if key not in reference_runs:
            reference_runs[key] = _run(
                main, bam, genome,
                os.path.join(tmp, f"{name}{int(with_intervals)}{flow}"),
                "true", [*extra, *iv])
    _assert_same_calls(port, ref,
                       reference_runs[("host", with_intervals, flow)])
    assert port == reference_runs[("single", with_intervals, flow)]


def test_default_run_takes_the_native_flow(workload, flow_counts):
    from pisces_tpu_torch.utils.metrics import metrics
    tmp, bam, genome, _ = workload
    metrics.reset()
    port = _run(torch_main, bam, genome, os.path.join(tmp, "dflt"), "true",
                ["-device", "cpu"])
    assert len(port) > 0
    # once per chromosome, and no Python events; the pileup stage's calls
    # count the native passes (chip_smoke.py's WGS phase reads them so)
    assert flow_counts == {"native_pileup": 2, "build_base_events": 0}
    assert metrics.snapshot()["stages"]["pileup"]["calls"] == 2


def test_mesh_takes_python_events_on_the_native_batch(workload, flow_counts,
                                                      monkeypatch):
    tmp, bam, genome, _ = workload
    batches = []
    events = torch_app.build_base_events

    def recording(batch, *a, **k):
        batches.append(batch)
        return events(batch, *a, **k)

    monkeypatch.setattr(torch_app, "build_base_events", recording)
    mesh = _run(torch_main, bam, genome, os.path.join(tmp, "mesh2"), "true",
                ["-device", "cpu", "-MeshDevices", "2"])
    assert flow_counts == {"native_pileup": 0, "build_base_events": 2}
    assert all(b._from_native_handle for b in batches) and len(batches) == 2
    single = _run(torch_main, bam, genome, os.path.join(tmp, "mesh1"),
                  "true", ["-device", "cpu"])
    assert flow_counts["native_pileup"] == 2
    assert mesh == single


def test_entry_matches_jax_entry():
    import __graft_entry__
    jfn, (jcounts, jref) = __graft_entry__.entry()
    want = jfn(jcounts, jref)
    fn, (counts, ref_code) = torch_entry.entry("cpu")
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    np.testing.assert_array_equal(ref_code.numpy(), jref)
    got = fn(counts, ref_code)
    for k in ("total_coverage", "support", "num_no_calls", "variant_qscore",
              "genotype", "gq", "filter_bits", "coverage_by_dir",
              "support_by_dir"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    sb_w = np.asarray(want["sb_gatk"])
    keep = np.isfinite(sb_w)
    np.testing.assert_allclose(np.clip(got["sb_gatk"].numpy()[keep], -100, 0),
                               np.clip(sb_w[keep], -100, 0), atol=1e-3)


def test_dryrun_multichip_on_cpu(capsys):
    torch_entry.dryrun_multichip(8, "cpu")
    out = capsys.readouterr().out
    assert "mesh={'dp': 2, 'sp': 4}" in out
    assert "mesh_devices=8" in out and "equal=True" in out


def test_compare_vcf_bodies_catches_differences():
    line = ("chr1\t5\t.\tA\t.\t100\tPASS\tDP=50\tGT:GQ:AD:DP:VF:NL:SB\t"
            "0/0:100:50:50:0.000:20:-10.0000")
    assert torch_entry.compare_vcf_bodies([line], [line]) == 1
    near = line.replace("-10.0000", "-10.0005")
    assert torch_entry.compare_vcf_bodies([near], [line]) == 1
    for bad in ([line.replace("-10.0000", "-10.0100")],
                [line.replace("PASS", "q30")], [line, line], []):
        with pytest.raises(AssertionError):
            torch_entry.compare_vcf_bodies(bad, [line])


def test_compare_vcf_files_catches_differences(tmp_path):
    """The streamed file comparison (chip_smoke.py's WGS phase) holds the
    same rule as compare_vcf_bodies across its steps of lines."""
    line = ("chr1\t5\t.\tA\t.\t100\tPASS\tDP=50\tGT:GQ:AD:DP:VF:NL:SB\t"
            "0/0:100:50:50:0.000:20:-10.0000\n")

    def vcf(name, body, header="##fileformat=VCFv4.1\n#CHROM\n"):
        path = tmp_path / name
        path.write_text(header + "".join(body))
        return str(path)

    want = vcf("want", [line] * 10)
    near = [line] * 9 + [line.replace("-10.0000", "-10.0005")]
    assert torch_entry.compare_vcf_files(
        vcf("near", near, "##other\n#CHROM\n"), want, lines_per_step=3) == 10
    for bad in ([line] * 9, [line] * 11,
                [line] * 9 + [line.replace("PASS", "q30")],
                [line] * 9 + [line.replace("-10.0000", "-10.0100")], []):
        with pytest.raises(AssertionError):
            torch_entry.compare_vcf_files(vcf("bad", bad), want,
                                          lines_per_step=4)


def _port_sources():
    pkg = os.path.join(REPO, "pisces_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_and_no_reference_package():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "pisces_tpu"):
                    bad.append(f"{path}:{node.lineno} {n}")
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, pisces_tpu_torch.apps.pisces, "
            "pisces_tpu_torch.ops.scoring_kernels, "
            "pisces_tpu_torch.parallel.sharding, pisces_tpu_torch.entry, "
            "pisces_tpu_torch.io.bai, pisces_tpu_torch.parallel.scheduler, "
            "pisces_tpu_torch.synthetic, pisces_tpu_torch.parallel.multihost, "
            "pisces_tpu_torch.genotype.diploid, "
            "pisces_tpu_torch.genotype.adaptive, pisces_tpu_torch.io.vcf_read, "
            "pisces_tpu_torch.satellites.adaptive_gt, "
            "pisces_tpu_torch.apps.titration, pisces_tpu_torch.apps.accuracy, "
            "pisces_tpu_torch.pileup.directions, "
            "pisces_tpu_torch.pileup.collapsed, "
            "pisces_tpu_torch.pileup.amplicons, "
            "pisces_tpu_torch.ops.amplicon_bias, "
            "pisces_tpu_torch.ops.exact_coverage, "
            "pisces_tpu_torch.io.bias_writers, "
            "pisces_tpu_torch.preprocessing.gemini, "
            "pisces_tpu_torch.preprocessing.bins, "
            "pisces_tpu_torch.preprocessing.classify, "
            "pisces_tpu_torch.io.pair_filter, "
            "pisces_tpu_torch.phasing.scylla; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'pisces_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_main_without_cuda_raises_unless_cpu(workload, monkeypatch):
    tmp, bam, genome, _ = workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("torch", "numpy"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main(["-bam", bam, "-g", genome, "-o",
                        os.path.join(tmp, "nocuda"), "-backend", backend])
