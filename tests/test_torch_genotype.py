"""The port's diploid, haploid and adaptive-GT genotyping against the
reference package.

- The three genotypers (pisces_tpu_torch/genotype/diploid.py and
  adaptive.py) on the allele sets of tests/test_genotypers.py: equal
  genotype, GQ, GP and prune list.
- The torch EM (adaptive.fit_mixture_model_torch) on seeded binomial
  mixtures: within 1e-4 of the JAX EM (fit_mixture_model_jax: f32 both,
  but the two lgamma forms differ in the last bits) and within 5e-3 of the
  f64 numpy EM, the reference's own bound (tests/test_genotypers.py).
- The diploid reference-line twin (fast_gvcf._score_host_tuples_diploid):
  equal on seeded tuples.
- The CLI with -ploidy diploid, -ploidy adaptive and -ploidy diploid
  -gender male on a workload with a chrX, both read flows, VCF and gVCF,
  every dispatch threshold at 1 so the port's device code runs: bodies
  byte-equal to pisces_tpu -backend jax.
- apps/accuracy.run_germline (thresholding and adaptive) and
  satellites/adaptive_gt.recalibrate (backend torch on the CPU) against
  the reference's.

Tests marked cuda run the EM and one ploidy run on the card and skip
elsewhere. JAX is imported only inside the tests that run it.
"""
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (keeps JAX on the CPU)
import pisces_tpu.calling.fast_gvcf as jax_fast_gvcf
import pisces_tpu.io.native as jax_native
from pisces_tpu.calling.alleles import CalledAllele as JAllele
from pisces_tpu.domain.types import AlleleCategory as JCategory
from pisces_tpu.domain.types import Genotype as JGenotype
from pisces_tpu.genotype import adaptive as jax_adaptive
from pisces_tpu.genotype import diploid as jax_diploid

import pisces_tpu_torch.apps.pisces as torch_app
import pisces_tpu_torch.calling.fast_gvcf as torch_fast_gvcf
import pisces_tpu_torch.io.native as torch_native
from pisces_tpu_torch.calling.alleles import CalledAllele
from pisces_tpu_torch.domain.types import AlleleCategory, Genotype
from pisces_tpu_torch.genotype import adaptive, diploid
from pisces_tpu_torch.ops.scoring_params import ScoringParams
from pisces_tpu_torch.options import DiploidThresholdingParameters
from pisces_tpu_torch.synthetic import write_synthetic_workload


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the torch EM and the kernels run "
                    "there")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# genotypers
# ---------------------------------------------------------------------------

class _Cfg:
    min_gq_score = 0
    max_gq_score = 100
    min_depth_to_genotype = 10
    diploid_snv_parameters = None
    diploid_indel_parameters = None
    adaptive_parameters = None


# (name, [(support, coverage, category, alt, reference support)]): the
# allele sets of tests/test_genotypers.py, plus deep and indel loci
ALLELE_SETS = [
    ("hom_ref", [(95, 100, "ref", "A", 95)]),
    ("het", [(45, 100, "snv", "T", 55)]),
    ("hom_alt", [(95, 100, "snv", "T", 5)]),
    ("low_freq", [(5, 100, "snv", "T", 95)]),
    ("alt1_alt2", [(55, 100, "snv", "T", 3), (42, 100, "snv", "G", 3)]),
    ("low_depth", [(4, 8, "snv", "T", 4)]),
    ("hemi_alt", [(90, 100, "snv", "T", 10)]),
    ("ambiguous", [(50, 100, "snv", "T", 50)]),
    ("adaptive_het", [(48, 100, "snv", "T", 52)]),
    ("adaptive_hom_alt", [(98, 100, "snv", "T", 2)]),
    ("deep_het", [(1200, 2500, "snv", "T", 1300)]),
    ("insertion", [(30, 80, "ins", "AT", 50)]),
    ("zero_coverage", [(0, 0, "snv", "T", 0)]),
]


def _alleles(spec, allele_cls, category_cls, genotype_cls):
    out = []
    for support, coverage, kind, alt, ref_support in spec:
        category = {"ref": category_cls.REFERENCE, "snv": category_cls.SNV,
                    "ins": category_cls.INSERTION}[kind]
        a = allele_cls("chr1", 100, "A", alt, category)
        a.allele_support = support
        a.total_coverage = coverage
        a.reference_support = ref_support
        a.genotype = genotype_cls.HETEROZYGOUS_ALT_REF
        a.variant_qscore = 100
        out.append(a)
    return out


GENOTYPERS = {
    "thresholding": (diploid.DiploidThresholdingGenotyper,
                     jax_diploid.DiploidThresholdingGenotyper),
    "haploid": (diploid.HaploidGenotyper, jax_diploid.HaploidGenotyper),
    "adaptive": (adaptive.DiploidAdaptiveGenotyper,
                 jax_adaptive.DiploidAdaptiveGenotyper),
}


@pytest.mark.parametrize("kind", sorted(GENOTYPERS))
@pytest.mark.parametrize("name,spec", ALLELE_SETS,
                         ids=[n for n, _ in ALLELE_SETS])
def test_genotypers_match_reference(kind, name, spec):
    port_cls, ref_cls = GENOTYPERS[kind]
    port = _alleles(spec, CalledAllele, AlleleCategory, Genotype)
    ref = _alleles(spec, JAllele, JCategory, JGenotype)
    port_prune = port_cls(_Cfg()).set_genotypes(port)
    ref_prune = ref_cls(_Cfg()).set_genotypes(ref)
    assert [port.index(a) for a in port_prune] == \
        [ref.index(a) for a in ref_prune]
    for a, b in zip(port, ref):
        assert int(a.genotype) == int(b.genotype)
        assert a.genotype_qscore == b.genotype_qscore
        gp_a = getattr(a, "genotype_posteriors", None)
        gp_b = getattr(b, "genotype_posteriors", None)
        if gp_b is None:
            assert gp_a is None
        else:
            np.testing.assert_array_equal(gp_a, gp_b)
        assert getattr(a, "phase_set_index", None) == \
            getattr(b, "phase_set_index", None)


@pytest.mark.parametrize("gt", ["HOMOZYGOUS_REF", "HETEROZYGOUS_ALT_REF",
                                "HOMOZYGOUS_ALT", "REF_LIKE_NOCALL"])
@pytest.mark.parametrize("depth", [100, 1000])
def test_diploid_gq_matches_reference(gt, depth):
    """diploid_gq over a grid of frequencies (the goldens' depths)."""
    for freq in np.linspace(0.0, 1.0, 41):
        support = int(depth * freq)
        a = _alleles([(support, depth, "snv", "T", depth - support)],
                     CalledAllele, AlleleCategory, Genotype)[0]
        b = _alleles([(support, depth, "snv", "T", depth - support)],
                     JAllele, JCategory, JGenotype)[0]
        a.genotype = Genotype[gt]
        b.genotype = JGenotype[gt]
        assert diploid.diploid_gq(a, 0, 2 ** 31 - 1) == \
            jax_diploid.diploid_gq(b, 0, 2 ** 31 - 1), (gt, depth, freq)


# ---------------------------------------------------------------------------
# the EM
# ---------------------------------------------------------------------------

def _mixture(n, seed, means=(0.01, 0.45, 0.95), p=(0.6, 0.3, 0.1),
             dp=(50, 300)):
    rng = np.random.default_rng(seed)
    comps = rng.choice(3, size=n, p=list(p))
    depth = rng.integers(dp[0], dp[1], size=n)
    return rng.binomial(depth, np.asarray(means)[comps]), depth


@pytest.mark.parametrize("case", [
    dict(n=2000, seed=1),
    dict(n=5000, seed=3, means=(0.02, 0.5, 0.98), p=(0.5, 0.35, 0.15),
         dp=(20, 300)),
    dict(n=3000, seed=4, start=(0.05, 0.4, 0.9)),
])
def test_torch_em_matches_jax_and_numpy(case):
    case = dict(case)
    start = case.pop("start", None)
    ad, dp = _mixture(**case)
    means, weights = adaptive.fit_mixture_model_torch(
        ad, dp, starting_means=start, device="cpu")
    means_j, weights_j = jax_adaptive.fit_mixture_model_jax(
        ad, dp, starting_means=start)
    np.testing.assert_allclose(means, means_j, atol=1e-4)
    np.testing.assert_allclose(weights, weights_j, atol=1e-4)
    fit = adaptive.fit_mixture_model(ad, dp, starting_means=start)
    np.testing.assert_allclose(means, fit.means, atol=5e-3)
    np.testing.assert_allclose(weights, fit.weights, atol=5e-3)
    # the port's f64 EM is the reference's
    ref_fit = jax_adaptive.fit_mixture_model(ad, dp, starting_means=start)
    np.testing.assert_array_equal(fit.means, ref_fit.means)
    np.testing.assert_array_equal(fit.weights, ref_fit.weights)
    np.testing.assert_array_equal(fit.qscores, ref_fit.qscores)


def test_torch_em_needs_cuda_unless_cpu(monkeypatch):
    from pisces_tpu_torch.satellites import adaptive_gt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ad, dp = _mixture(100, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adaptive.fit_mixture_model_torch(ad, dp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adaptive_gt.recalibrate("unused.vcf", backend="torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adaptive_gt.main(["-vcf", "unused.vcf"])  # the CLI's default: torch


@pytest.mark.cuda
def test_torch_em_on_card_matches_cpu(cuda_device):
    """The card's EM against the CPU's torch EM and the f64 numpy EM, each
    on the same observations."""
    ad, dp = _mixture(200_000, 7, dp=(20, 300))
    means, weights = adaptive.fit_mixture_model_torch(ad, dp,
                                                      device=cuda_device)
    means_c, weights_c = adaptive.fit_mixture_model_torch(ad, dp,
                                                          device="cpu")
    np.testing.assert_allclose(means, means_c, atol=1e-4)
    np.testing.assert_allclose(weights, weights_c, atol=1e-4)
    fit = adaptive.fit_mixture_model(ad, dp)
    np.testing.assert_allclose(means, fit.means, atol=5e-3)
    np.testing.assert_allclose(weights, fit.weights, atol=5e-3)


# ---------------------------------------------------------------------------
# the diploid reference-line twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,hi", [(0, 60), (1, 400), (2, 3000)])
def test_score_host_tuples_diploid_matches_reference(seed, hi):
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, hi, size=(4000, 3))
    sup = (cov * rng.choice([0.0, 0.5, 0.85, 0.97, 1.0],
                            size=(4000, 3))).astype(np.int64)
    cov[:20] = 0
    sup[:20] = 0
    params = ScoringParams()
    snv = DiploidThresholdingParameters()
    got = torch_fast_gvcf._score_host_tuples_diploid(sup, cov, params, snv)
    from pisces_tpu.ops.scoring_params import ScoringParams as JParams
    from pisces_tpu.options import DiploidThresholdingParameters as JSnv
    want = jax_fast_gvcf._score_host_tuples_diploid(sup, cov, JParams(),
                                                    JSnv())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(np.unique(got["genotype"])) >= 2


# ---------------------------------------------------------------------------
# the CLI, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ploidy"))
    bam, genome = write_synthetic_workload(tmp, 2, 20_000, 6_000, seed=1,
                                           chrom_names=["chr1", "chrX"])
    return tmp, bam, genome


def test_adaptive_gvcf_in_intervals_matches_jax(workload, device_everywhere,
                                                flow, tmp_path):
    """-ploidy adaptive -gVCF true inside -IntervalPaths (the object path's
    reference candidates and the RegionMapper padding)."""
    from pisces_tpu.apps.pisces import main as jax_main
    tmp, bam, genome = workload
    intervals = str(tmp_path / "regions.picard")
    with open(intervals, "w") as f:
        f.write("@HD\tVN:1.6\nchr1\t1500\t4200\nchrX\t100\t2500\n")
    flags = ["-ploidy", "adaptive", "-IntervalPaths", intervals]
    port = _body(torch_app.main, bam, genome, str(tmp_path / "t"), "true",
                 [*flags, "-device", "cpu"])
    ref = _body(jax_main, bam, genome, str(tmp_path / "j"), "true",
                [*flags, "-backend", "jax"])
    assert port == ref
    assert sum(ln.startswith("chr1\t") for ln in port) >= 2701
    assert sum(ln.startswith("chrX\t") for ln in port) >= 2401


@pytest.fixture
def device_everywhere(monkeypatch):
    from test_torch_e2e import candidate_batches_on_device
    candidate_batches_on_device(monkeypatch)
    monkeypatch.setattr(jax_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    monkeypatch.setattr(torch_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)


@pytest.fixture(params=["native", "python"])
def flow(request, monkeypatch):
    """Both packages on one read flow, as in tests/test_torch_e2e.py."""
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


def _body(main, bam, genome, out, gvcf, extra):
    assert main(["-bam", bam, "-g", genome, "-o", out, "-gVCF", gvcf,
                 *extra]) == 0
    name = "b.genome.vcf" if gvcf == "true" else "b.vcf"
    with open(os.path.join(out, name)) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("#")]


PLOIDIES = {
    "diploid": ["-ploidy", "diploid"],
    "adaptive": ["-ploidy", "adaptive"],
    "male": ["-ploidy", "diploid", "-gender", "male"],
}


@pytest.mark.parametrize("gvcf", ["true", "false"])
@pytest.mark.parametrize("ploidy", sorted(PLOIDIES))
def test_ploidy_cli_matches_jax(workload, device_everywhere, flow, ploidy,
                                gvcf):
    from pisces_tpu.apps.pisces import main as jax_main
    tmp, bam, genome = workload
    tag = f"{ploidy}{flow}{gvcf}"
    flags = PLOIDIES[ploidy]
    port = _body(torch_app.main, bam, genome, os.path.join(tmp, f"t{tag}"),
                 gvcf, [*flags, "-device", "cpu"])
    ref = _body(jax_main, bam, genome, os.path.join(tmp, f"j{tag}"), gvcf,
                [*flags, "-backend", "jax"])
    assert len(port) > 0
    assert port == ref
    gts = {ln.split("\t")[9].split(":")[0] for ln in port}
    assert gts & {"0/1", "1/1"}
    if ploidy == "male":
        # chrX is haploid: one allele in each of its genotypes
        x = [ln.split("\t")[9].split(":")[0] for ln in port
             if ln.startswith("chrX\t")]
        assert all("/" not in g for g in x)
        assert len(x) > 1000 or gvcf == "false"


def test_ploidy_numpy_backend_byte_equal(workload):
    """-backend numpy on both sides, diploid gVCF with -gender male."""
    from pisces_tpu.apps.pisces import main as jax_main
    tmp, bam, genome = workload
    flags = [*PLOIDIES["male"], "-backend", "numpy"]
    port = _body(torch_app.main, bam, genome, os.path.join(tmp, "tnum"),
                 "true", [*flags, "-device", "cpu"])
    ref = _body(jax_main, bam, genome, os.path.join(tmp, "jnum"), "true",
                flags)
    assert port == ref


def test_diploid_reference_lines_stay_on_host(workload, device_everywhere,
                                              monkeypatch):
    """Diploid reference lines never reach the tuple kernel's wrapper: they
    take the f64 host twin even with every threshold at 1."""
    from pisces_tpu_torch.ops import scoring_kernels as K
    calls = []
    wrapper = K.score_reference_tuples
    monkeypatch.setattr(K, "score_reference_tuples",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    tmp, bam, genome = workload
    _body(torch_app.main, bam, genome, os.path.join(tmp, "dhost"), "true",
          [*PLOIDIES["diploid"], "-device", "cpu"])
    assert calls == []
    _body(torch_app.main, bam, genome, os.path.join(tmp, "shost"), "true",
          ["-device", "cpu"])
    assert len(calls) == 2


def test_device_candidate_batches_counted(workload, device_everywhere):
    from pisces_tpu_torch.utils.metrics import metrics
    tmp, bam, genome = workload
    metrics.reset()
    _body(torch_app.main, bam, genome, os.path.join(tmp, "cnt"), "false",
          ["-device", "cpu"])
    counters = metrics.snapshot()["counters"]
    assert counters["candidate_batches_on_device"] >= 2
    assert counters["candidates_on_device"] >= \
        counters["candidate_batches_on_device"]
    metrics.reset()
    _body(torch_app.main, bam, genome, os.path.join(tmp, "cntn"), "false",
          ["-device", "cpu", "-backend", "numpy"])
    assert "candidate_batches_on_device" not in \
        metrics.snapshot()["counters"]


@pytest.mark.cuda
def test_ploidy_cli_on_card_matches_numpy(workload, cuda_device):
    tmp, bam, genome = workload
    flags = PLOIDIES["male"]
    card = _body(torch_app.main, bam, genome, os.path.join(tmp, "card"),
                 "true", [*flags, "-device", "cuda"])
    host = _body(torch_app.main, bam, genome, os.path.join(tmp, "cardh"),
                 "true", [*flags, "-device", "cuda", "-backend", "numpy"])
    assert card == host and len(card) > 0


# ---------------------------------------------------------------------------
# the germline harness and the AdaptiveGT satellite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("is_adaptive", [False, True],
                         ids=["thresholding", "adaptive"])
def test_run_germline_matches_reference(tmp_path, is_adaptive):
    from pisces_tpu.apps.accuracy import run_germline as jax_run_germline
    from pisces_tpu_torch.apps.accuracy import run_germline
    kw = dict(sites_per_zyg=30, depth=120, chrom_len=20_000, seed=11,
              adaptive=is_adaptive)
    res = run_germline(str(tmp_path / "t"), device="cpu", **kw)
    ref = jax_run_germline(str(tmp_path / "j"), use_device=True, **kw)
    for z in ("het", "hom"):
        assert vars(res[z]) == vars(ref[z])
        assert res[z].recall >= 0.95 and res[z].precision >= 0.95
        assert res[z].gt_concordance >= 0.95
    bodies = []
    for d in ("t", "j"):
        with open(tmp_path / d / "titration.vcf") as f:
            bodies.append([ln for ln in f if not ln.startswith("#")])
    assert bodies[0] == bodies[1] and len(bodies[0]) > 0


def test_run_titration_matches_reference(tmp_path):
    from pisces_tpu.apps.titration import run_titration as jax_run_titration
    from pisces_tpu.apps.titration import wilson_ci as jax_wilson_ci
    from pisces_tpu_torch.apps.titration import run_titration, wilson_ci
    kw = dict(vf_points=(0.05, 0.08), sites_per_point=10, depth=400,
              chrom_len=20_000, seed=7)
    res = run_titration(str(tmp_path / "t"), device="cpu", **kw)
    ref = jax_run_titration(str(tmp_path / "j"), use_device=True, **kw)
    assert {vf: vars(p) for vf, p in res.items()} == \
        {vf: vars(p) for vf, p in ref.items()}
    assert all(p.recall >= 0.9 for p in res.values())
    for name in ("titration_summary.csv", "titration.vcf"):
        got = (tmp_path / "t" / name).read_text().splitlines()
        want = (tmp_path / "j" / name).read_text().splitlines()
        assert [ln for ln in got if not ln.startswith("##")] == \
            [ln for ln in want if not ln.startswith("##")]
    for k, n in ((0, 0), (3, 10), (40, 40), (7, 15)):
        assert wilson_ci(k, n) == jax_wilson_ci(k, n)
    # the VQR arm: VQR on the caller's VCF, then scoring of its .recal
    res = run_titration(str(tmp_path / "tr"), recalibrate=True, device="cpu",
                        **kw)
    ref = jax_run_titration(str(tmp_path / "jr"), recalibrate=True,
                            use_device=True, **kw)
    assert {vf: vars(p) for vf, p in res.items()} == \
        {vf: vars(p) for vf, p in ref.items()}
    for name in ("titration_summary.csv", "titration.counts"):
        assert (tmp_path / "tr" / name).read_text() == \
            (tmp_path / "jr" / name).read_text(), name
    bodies = [[ln for ln in (tmp_path / d / "titration.vcf.recal")
               .read_text().splitlines() if not ln.startswith("#")]
              for d in ("tr", "jr")]
    assert bodies[0] == bodies[1] and len(bodies[0]) > 0


HEADER = """##fileformat=VCFv4.1
##source=Pisces 5.2.11.163
##INFO=<ID=DP,Number=1,Type=Integer,Description="Total Depth">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">
##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Allele Depth">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Total Depth">
##FORMAT=<ID=VF,Number=.,Type=Float,Description="Variant Frequency">
##FORMAT=<ID=NL,Number=1,Type=Integer,Description="Noise Level">
##FORMAT=<ID=SB,Number=1,Type=Float,Description="StrandBias">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1
"""


def _germline_vcf(path, seed, n=600, means=(0.01, 0.47, 0.97)):
    """A diploid VCF of n loci drawn from a 3-component binomial mixture,
    with a run of indels (the indel fit starts from the SNV means)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write(HEADER)
        for k in range(n):
            comp = int(rng.choice(3, p=[0.5, 0.35, 0.15]))
            dp = int(rng.integers(80, 300))
            ad = int(rng.binomial(dp, means[comp]))
            alt = "AT" if k % 7 == 0 else "T"
            if ad < 2:
                alt, ad_s, gt = ".", str(dp - ad), "0/0"
            else:
                ad_s = f"{dp - ad},{ad}"
                gt = "1/1" if comp == 2 else "0/1"
            f.write(f"chr1\t{100 + 3 * k}\t.\tA\t{alt}\t100\tPASS\tDP={dp}\t"
                    f"GT:GQ:AD:DP:VF:NL:SB\t{gt}:100:{ad_s}:{dp}:"
                    f"{ad / dp:.3f}:20:-100.0000\n")


@pytest.mark.parametrize("seed", [5, 6])
def test_recalibrate_matches_reference(tmp_path, seed):
    from pisces_tpu.satellites import adaptive_gt as jax_adaptive_gt
    from pisces_tpu_torch.satellites import adaptive_gt
    bodies = {}
    for name, fn in (
            ("torch", lambda v, d: adaptive_gt.recalibrate(
                v, d, backend="torch", device="cpu")),
            ("numpy", lambda v, d: adaptive_gt.recalibrate(
                v, d, backend="numpy")),
            ("jax", lambda v, d: jax_adaptive_gt.recalibrate(
                v, d, use_jax=True)),
            ("jax_numpy", lambda v, d: jax_adaptive_gt.recalibrate(v, d))):
        d = tmp_path / name
        d.mkdir()
        vcf = str(d / "g.vcf")
        _germline_vcf(vcf, seed)
        with open(fn(vcf, str(d))) as f:
            bodies[name] = [ln for ln in f if not ln.startswith("#")]
    assert len(bodies["torch"]) > 200
    for name in ("numpy", "jax", "jax_numpy"):
        assert bodies["torch"] == bodies[name], name


def test_adaptive_gt_cli_torch_backend(tmp_path):
    """The CLI fits with the torch EM unless asked for numpy; both give
    the same recalibrated body."""
    from pisces_tpu_torch.satellites import adaptive_gt
    vcf = str(tmp_path / "g.vcf")
    _germline_vcf(vcf, 7)
    bodies = []
    for out, flags in (("o", []), ("o_numpy", ["-backend", "numpy"])):
        assert adaptive_gt.main(["-vcf", vcf, "-o", str(tmp_path / out),
                                 "-device", "cpu", *flags]) == 0
        with open(tmp_path / out / "g.recal.vcf") as f:
            bodies.append([ln for ln in f if not ln.startswith("#")])
    models = adaptive_gt.read_model_file(str(tmp_path / "o" / "g.model"))
    np.testing.assert_allclose(models[0][0], [0.01, 0.47, 0.97], atol=0.05)
    assert bodies[0] == bodies[1] and len(bodies[0]) > 200
