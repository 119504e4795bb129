"""The port's caller options against the reference package: forced alleles,
priors, the bias tables, amplicon bias and exact coverage (ROADMAP Queue 1
item 7).

End to end, each option runs through both packages' CLIs on the same BAM
and on both read flows (test_torch_e2e's `flow` fixture), with every
dispatch threshold at 1 so that the device code of each package runs (the
tuple kernel's plain version and torch_scoring in the port, on the CPU;
the XLA functions in the reference package). The port's -backend torch
body must equal the f64 host body (-backend numpy) on every field but the
reference-line strand bias (test_torch_e2e._assert_same_calls says why and
holds it within the Pallas kernel's tolerances), and the reference's
-backend jax body on every field but the reference-line strand bias and
genotype quality: XLA's f32 igamma in the reference's tuple scoring also
gives GQ 4 where its f64 oracle, its Pallas kernel and the port give 8 (a
locus of about 195 reads with one non-reference base; ROADMAP Queue 3), so
a reference-line GQ may differ from the reference's only where the
reference differs from its own f64 run. The -backend numpy bodies of both
packages must be byte-equal. Module by module, the port's copies give the
reference's outputs on the same inputs.
"""
import filecmp
import os

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from test_torch_e2e import (  # noqa: F401  (fixtures)
    _run, device_everywhere, flow,
)
from pisces_tpu.apps.pisces import main as jax_main

import pisces_tpu_torch.apps.pisces as torch_app
from pisces_tpu_torch import synthetic
from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.io.fasta import Genome


def _split_ref_line(line):
    """(line with the reference-line GQ and SB blanked, that GQ, that SB);
    (line, None, None) for a variant line."""
    f = line.split("\t")
    if f[4] != "." or not f[8].endswith(":SB"):
        return line, None, None
    keys, vals = f[8].split(":"), f[9].split(":")
    gq, sb = vals[keys.index("GQ")], float(vals[-1])
    vals[keys.index("GQ")], vals[-1] = "", ""
    return "\t".join(f[:9] + [":".join(vals)]), gq, sb


def assert_port_calls(port, ref, host):
    """`port` against the reference package's device run `ref` and the f64
    host run `host`, as the module docstring says. Returns the number of
    reference lines whose GQ differs from `ref`'s."""
    assert len(port) == len(ref) == len(host) > 0
    n_gq = 0
    for a, b, h in zip(port, ref, host):
        (ha, gqa, sa), (hb, gqb, _), (hh, gqh, sh) = (
            _split_ref_line(a), _split_ref_line(b), _split_ref_line(h))
        assert ha == hb == hh, (a, b, h)
        assert gqa == gqh, (a, h)
        n_gq += gqa != gqb
        if sa is not None:
            tol = 1e-3 if sh > -40.0 else 0.05 * abs(sh)
            assert abs(sa - sh) <= tol, (a, h)
    return n_gq


def _four_runs(tmp, tag, bam, genome, gvcf, flags):
    """The port (-backend torch and numpy, -device cpu) and the reference
    package (-backend jax and numpy) on one BAM; holds them as the module
    docstring says and returns the port's -backend torch body."""
    port = _run(torch_main, bam, genome, os.path.join(tmp, f"t{tag}"), gvcf,
                ["-device", "cpu", *flags])
    port_host = _run(torch_main, bam, genome, os.path.join(tmp, f"tn{tag}"),
                     gvcf, ["-device", "cpu", "-backend", "numpy", *flags])
    ref = _run(jax_main, bam, genome, os.path.join(tmp, f"j{tag}"), gvcf,
               ["-backend", "jax", *flags])
    ref_host = _run(jax_main, bam, genome, os.path.join(tmp, f"jn{tag}"),
                    gvcf, ["-backend", "numpy", *flags])
    assert port_host == ref_host
    assert_port_calls(port, ref, port_host)
    if gvcf == "false":
        assert port == ref
    return port


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Two 20 kb chromosomes of the messy workload, indexed, with a
    forced-allele VCF (called SNVs, reference loci without support, one
    locus with two alts), a priors VCF (called SNVs, padded MNVs) and a
    forced-allele VCF holding both the forced sites and the padded
    MNVs."""
    tmp = str(tmp_path_factory.mktemp("opts"))
    bam, genome = synthetic.write_synthetic_workload(tmp, 2, 20_000, 6_000,
                                                     seed=1, index=True)
    body = _run(torch_main, bam, genome, os.path.join(tmp, "calls"), "false",
                ["-device", "cpu", "-backend", "numpy"])
    g = Genome(genome)
    forced, priors = [], []
    for k, chrom in enumerate(("chr1", "chr2")):
        f, p = synthetic.forced_and_prior_sites(
            body, g.get_chr_reference(chrom).sequence, chrom, 24, seed=k)
        forced += f
        priors += p
    mnvs = [p for p in priors if len(p[2]) > 1]
    return dict(
        tmp=tmp, bam=bam, genome=genome,
        forced=synthetic.write_sites_vcf(os.path.join(tmp, "forced.vcf"),
                                         forced),
        priors=synthetic.write_sites_vcf(os.path.join(tmp, "priors.vcf"),
                                         priors),
        mnvs=mnvs,
        forced_mnvs=synthetic.write_sites_vcf(
            os.path.join(tmp, "forced_mnvs.vcf"), sorted(forced + mnvs)))


@pytest.fixture(scope="module")
def phased(tmp_path_factory):
    """The MNV accuracy workload cut to 8 haplotypes at 60x over 6 kb."""
    from pisces_tpu_torch.apps.accuracy import generate_mnv_workload
    tmp = str(tmp_path_factory.mktemp("phased"))
    bam, genome, _truth = generate_mnv_workload(tmp, n_haplotypes=8,
                                                depth=60, chrom_len=6_000)
    return tmp, bam, genome


@pytest.fixture(scope="module")
def amplicons(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("amp"))
    bam, genome = synthetic.write_amplicon_workload(tmp, 24, depth=300,
                                                    seed=3)
    return tmp, bam, genome


def _assert_forced_reported(body):
    assert any("ForcedReport" in ln for ln in body), \
        "no forced allele reported"


@pytest.mark.parametrize("crush", ["false", "true"])
@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_forced_alleles_match_jax(panel, device_everywhere, flow, gvcf,
                                  crush):
    """-ForcedAlleles, one line a locus (-CrushVcf true: crushed loci take
    the object gVCF path) or several (the fast gVCF path splices the
    reference line beside forced-only alleles)."""
    port = _four_runs(panel["tmp"], f"f{gvcf}{crush}{flow}", panel["bam"],
                      panel["genome"], gvcf,
                      ["-ForcedAlleles", panel["forced"], "-CrushVcf", crush])
    _assert_forced_reported(port)


@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_forced_mnvs_match_jax(panel, device_everywhere, monkeypatch, gvcf):
    """-ForcedAlleles with padded MNVs beside the SNV forced sites, on the
    native flow: a forced MNV makes the caller take the native flow's SNV
    rows as objects (MNV triage reads every SNV allele), and the forced
    MNVs are reported."""
    from pisces_tpu_torch.pileup.candidates_fast import SnvCandidateBatch
    as_objects = []
    to_candidates = SnvCandidateBatch.to_candidates

    def spy(self):
        as_objects.append(len(self))
        return to_candidates(self)

    monkeypatch.setattr(SnvCandidateBatch, "to_candidates", spy)
    port = _four_runs(panel["tmp"], f"fm{gvcf}", panel["bam"],
                      panel["genome"], gvcf,
                      ["-ForcedAlleles", panel["forced_mnvs"]])
    _assert_forced_reported(port)
    # both port runs, each chromosome's rows
    assert len(as_objects) == 4 and min(as_objects) > 0
    reported = {(f[0], int(f[1]), f[3], f[4])
                for f in (ln.split("\t") for ln in port)
                if "ForcedReport" in f[6]}
    assert reported & set(panel["mnvs"])


@pytest.mark.parametrize("trim", ["true", "false"])
def test_priors_match_jax(panel, device_everywhere, flow, trim):
    _four_runs(panel["tmp"], f"p{trim}{flow}", panel["bam"], panel["genome"],
               "true", ["-PriorsPath", panel["priors"], "-TrimMnvPriors",
                        trim])


@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_bias_files_match_jax(panel, device_everywhere, flow, gvcf):
    tmp = panel["tmp"]
    tag = f"b{gvcf}{flow}"
    _four_runs(tmp, tag, panel["bam"], panel["genome"], gvcf,
               ["-OutputBiasFiles", "true"])
    stem = "b.genome" if gvcf == "true" else "b"
    for table in ("ReadStrandBias", "AmpliconBias"):
        name = f"{stem}.{table}.txt"
        for a, b in (("t", "j"), ("tn", "jn"), ("t", "tn")):
            assert filecmp.cmp(os.path.join(tmp, a + tag, name),
                               os.path.join(tmp, b + tag, name),
                               shallow=False), (a, b, name)
    with open(os.path.join(tmp, "t" + tag, f"{stem}.ReadStrandBias.txt")) as f:
        assert len(f.read().splitlines()) > 10


def test_exact_coverage_on_the_fast_path_matches_jax(panel, device_everywhere,
                                                   flow):
    _four_runs(panel["tmp"], f"x{flow}", panel["bam"], panel["genome"],
               "true", ["-CoverageMethod", "exact"])


@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_exact_coverage_of_mnvs_matches_jax(phased, device_everywhere, flow,
                                            gvcf):
    """-CoverageMethod exact counts the reads that span each MNV
    (ops/exact_coverage), which moves their depths off the approximate
    method's."""
    tmp, bam, genome = phased
    flags = ["-CallMNVs", "true"]
    port = _four_runs(tmp, f"x{gvcf}{flow}", bam, genome, gvcf,
                      [*flags, "-CoverageMethod", "exact"])
    approx = _run(torch_main, bam, genome, os.path.join(tmp, f"xa{gvcf}{flow}"),
                  gvcf, ["-device", "cpu", *flags])
    moved = [a for a, b in zip(port, approx) if a != b]
    assert len(port) == len(approx) and moved
    assert all(len(ln.split("\t")[3]) > 1 for ln in moved)


@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_amplicon_bias_matches_jax(amplicons, device_everywhere, flow, gvcf):
    tmp, bam, genome = amplicons
    tag = f"a{gvcf}{flow}"
    port = _four_runs(tmp, tag, bam, genome, gvcf,
                      ["-abfilter", "0.01", "-OutputBiasFiles", "true"])
    flagged = [ln for ln in port if "AB" in ln.split("\t")[6].split(";")]
    assert flagged and any("\tPASS\t" in ln and ln.split("\t")[4] != "."
                           for ln in port)
    stem = "b.genome" if gvcf == "true" else "b"
    assert filecmp.cmp(os.path.join(tmp, "t" + tag, f"{stem}.AmpliconBias.txt"),
                       os.path.join(tmp, "j" + tag, f"{stem}.AmpliconBias.txt"),
                       shallow=False)


def test_forced_alleles_through_threads_and_windows(panel, device_everywhere):
    """The forced alleles reach every chromosome job of -MaxThreads 2 and
    every window of -WindowSize, as in the reference's scheduler and
    windowed run; both bodies equal the serial one."""
    tmp, bam, genome = panel["tmp"], panel["bam"], panel["genome"]
    flags = ["-ForcedAlleles", panel["forced"]]
    serial = _run(torch_main, bam, genome, os.path.join(tmp, "fs"), "true",
                  ["-device", "cpu", *flags])
    _assert_forced_reported(serial)
    for name, extra in (("threads", ["-MaxThreads", "2"]),
                        ("windows", ["-WindowSize", "7000"])):
        port = _run(torch_main, bam, genome, os.path.join(tmp, f"f{name}"),
                    "true", ["-device", "cpu", *flags, *extra])
        ref = _run(jax_main, bam, genome, os.path.join(tmp, f"fj{name}"),
                   "true", ["-backend", "numpy", *flags, *extra])
        assert port == serial, name
        assert_port_calls(port, ref, ref)


@pytest.mark.parametrize("scheduler", [["-MaxThreads", "2"],
                                       ["-WindowSize", "7000"]],
                         ids=["threads", "windows"])
@pytest.mark.parametrize("option", [
    ["-PriorsPath", "PRIORS", "-TrimMnvPriors", "true"],
    ["-OutputBiasFiles", "true"], ["-CoverageMethod", "exact"],
    ["-CallMNVs", "true", "-gVCF", "false"]],
    ids=["priors", "bias", "exact", "mnv"])
def test_options_through_a_scheduler_match_jax(panel, option, scheduler):
    """Each option through -MaxThreads 2 and through -WindowSize against
    the reference's same scheduler (whose threaded jobs, like the port's,
    take no priors and write no bias tables) and the port's -backend numpy
    run; windowed bias tables are byte-equal to the reference's."""
    tmp, bam, genome = panel["tmp"], panel["bam"], panel["genome"]
    flags = [panel["priors"] if f == "PRIORS" else f for f in option]
    gvcf = "false" if "-gVCF" in flags else "true"
    if "-gVCF" in flags:
        flags = flags[:-2]
    tag = f"s{option[0]}{scheduler[0]}"
    port = _run(torch_main, bam, genome, os.path.join(tmp, "t" + tag), gvcf,
                ["-device", "cpu", *flags, *scheduler])
    host = _run(torch_main, bam, genome, os.path.join(tmp, "tn" + tag), gvcf,
                ["-device", "cpu", "-backend", "numpy", *flags, *scheduler])
    ref = _run(jax_main, bam, genome, os.path.join(tmp, "jn" + tag), gvcf,
               ["-backend", "numpy", *flags, *scheduler])
    assert host == ref
    assert_port_calls(port, ref, host)
    if option[0] == "-OutputBiasFiles" and scheduler[0] == "-WindowSize":
        name = "b.genome.ReadStrandBias.txt"
        assert filecmp.cmp(os.path.join(tmp, "t" + tag, name),
                           os.path.join(tmp, "jn" + tag, name),
                           shallow=False)


def test_fast_gvcf_eligibility_agrees_with_jax():
    """The port's rule and the reference's on the whole grid of the
    options it reads (tests/test_fast_gvcf_paths.py's cases among them)."""
    import itertools

    from pisces_tpu.apps.pisces import _fast_gvcf_eligible as jax_rule
    from pisces_tpu.domain.types import PloidyModel as JP
    from pisces_tpu.options import PiscesApplicationOptions as JO
    from pisces_tpu_torch.domain.types import PloidyModel as TP
    from pisces_tpu_torch.options import PiscesApplicationOptions as TO

    n = 0
    for (gvcf, fast, mnv, rc, ploidy, gq, crush, forced) in itertools.product(
            (True, False), (True, False), (True, False), (True, False),
            ("SOMATIC", "DIPLOID_BY_THRESHOLDING", "DIPLOID_BY_ADAPTIVE_GT",
             "HAPLOID"), (None, 20), (True, False),
            (None, set(), {("chr1", 5, "A", "C")})):
        got = []
        for Opts, Ploidy, rule in ((TO, TP, torch_app._fast_gvcf_eligible),
                                   (JO, JP, jax_rule)):
            o = Opts()
            o.vcf_writing_parameters.output_gvcf_file = gvcf
            o.vcf_writing_parameters.report_rc_counts = rc
            o.vcf_writing_parameters.force_crush = crush
            o.use_fast_gvcf = fast
            o.call_mnvs = mnv
            o.variant_calling_parameters.ploidy_model = getattr(Ploidy,
                                                                ploidy)
            o.validate()
            o.variant_calling_parameters.low_genotype_quality_filter = gq
            got.append(bool(rule(o, forced)))
        assert got[0] == got[1], (gvcf, fast, mnv, rc, ploidy, gq, crush,
                                  forced)
        n += got[0]
    assert 0 < n < 768


def test_load_forced_alleles_and_priors_match_jax(panel, tmp_path):
    from pisces_tpu.apps import pisces as jax_app
    messy = synthetic.write_sites_vcf(str(tmp_path / "messy.vcf"), [
        ("chr1", 10, "A", "C,G"), ("chr1", 12, "a", "t"),
        ("chr1", 14, "A", "A"), ("chr1", 16, "A", "N"),
        ("chr1", 18, "A", "<M>"), ("chr1", 20, "AC", "A"),
        ("chr2", 30, "G", "GTT"), ("chr2", 40, "ACG", "ATT"),
        ("chr2", 50, "AC", "*")])
    for paths in ([panel["forced"]], [panel["forced"], messy]):
        assert (torch_app.load_forced_alleles(paths)
                == jax_app.load_forced_alleles(paths))

    def flat(by_chrom):
        return {c: [(x.chromosome, x.position, x.ref_allele, x.alt_allele,
                     int(x.category)) for x in v]
                for c, v in by_chrom.items()}

    for path in (panel["priors"], messy):
        for trim in (False, True):
            assert (flat(torch_app.load_priors(path, trim))
                    == flat(jax_app.load_priors(path, trim)))


def test_amplicon_modules_match_jax(amplicons):
    from pisces_tpu.io.bam import BamReader as JReader
    from pisces_tpu.ops.amplicon_bias import calculate_amplicon_bias as jab
    from pisces_tpu.pileup.amplicons import amplicon_coverage as jcov
    from pisces_tpu_torch.io.bam import filter_batch
    from pisces_tpu_torch.io.native import open_bam
    from pisces_tpu_torch.ops.amplicon_bias import calculate_amplicon_bias
    from pisces_tpu_torch.pileup.amplicons import amplicon_coverage

    _tmp, bam, _genome = amplicons
    batch = open_bam(bam).fetch(0, parse_tags=True)
    keep = filter_batch(batch)
    jbatch = JReader(bam).fetch(0, parse_tags=True)
    got = amplicon_coverage(batch, keep, 20)
    assert got == jcov(jbatch, keep, 20) and len(got) > 1000
    rng = np.random.default_rng(0)
    for pos in sorted(got)[::37]:
        cov = got[pos]
        sup = {k: int(rng.integers(0, v + 1)) for k, v in cov.items()}
        for crit in (0.01, 0.5):
            assert (calculate_amplicon_bias(sup, cov, crit, 100)
                    == jab(sup, cov, crit, 100))


def test_exact_coverage_modules_match_jax(panel):
    from pisces_tpu.calling.source import AlleleSource as JSource
    from pisces_tpu.io.bam import BamReader as JReader
    from pisces_tpu.ops import exact_coverage as jx
    from pisces_tpu.pileup.counts import build_counts_host as jcounts
    from pisces_tpu.pileup.events import build_base_events as jevents
    from pisces_tpu_torch.calling.source import AlleleSource
    from pisces_tpu_torch.domain.types import AlleleCategory
    from pisces_tpu_torch.io.bam import BamReader, filter_batch
    from pisces_tpu_torch.ops import exact_coverage as tx
    from pisces_tpu_torch.pileup.counts import build_counts_host
    from pisces_tpu_torch.pileup.events import build_base_events

    batch = BamReader(panel["bam"]).fetch(0)
    keep = filter_batch(batch)
    jbatch = JReader(panel["bam"]).fetch(0)
    got = tx.build_read_summaries(batch, keep)
    want = jx.build_read_summaries(jbatch, keep)
    for name in ("clip_start", "clip_end", "starts_with_ins", "ends_with_ins"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for a, b in zip(got.pos_maps + got.dir_maps, want.pos_maps + want.dir_maps):
        np.testing.assert_array_equal(a, b)
    src = AlleleSource(build_counts_host(build_base_events(batch, keep, 20, 5)))
    jsrc = JSource(jcounts(jevents(jbatch, keep, 20, 5)))
    for cat, pos, length, sup in ((AlleleCategory.DELETION, 5_000, 2, 3),
                                  (AlleleCategory.INSERTION, 9_000, 2, 1),
                                  (AlleleCategory.MNV, 12_345, 3, 2),
                                  (AlleleCategory.DELETION, 19_990, 4, 0)):
        cov, total, ref_sup, bq = tx.exact_spanning_coverage(
            src, got, cat, pos, length, sup)
        jcov, jtotal, jref, jbq = jx.exact_spanning_coverage(
            jsrc, want, cat, pos, length, sup)
        np.testing.assert_array_equal(cov, jcov)
        assert (total, ref_sup, bq) == (jtotal, jref, jbq)
