"""The port's satellite tools against pisces_tpu's, on the CPU.

VQR, VennVcf, Psara, ReformatVcf and CreateGenomeSizeFile are host Python
in both packages. The same inputs go through `pisces_tpu.X` and
`pisces_tpu_torch.X` and every output file must be byte-equal. The inputs
are the hand-built VCFs of tests/test_satellites.py (HEADER, vcf_line) and
the VCF and gVCF that the port's caller writes on the CPU from
synthetic.write_synthetic_workload (one 20 kb chromosome, 30,000 reads,
seed 0).

Both packages read the same input path, so headers are equal too. The one
line skipped is ReformatVcf's `##fileDate`, which carries the day of the
run. VQR's `##VQR_cmdline` carries the input path, which is the same for
both here; CreateGenomeSizeFile's XML names the folder, given the same
basename in both runs.
"""
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from test_satellites import vcf_line, write_vcf
from pisces_tpu_torch.apps import create_genome_size
from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.satellites import psara, reformat, vennvcf, vqr
from pisces_tpu_torch.synthetic import write_synthetic_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATE_LINE = "##fileDate"


def _reference(tool):
    """pisces_tpu's module of the port's `tool`."""
    import importlib
    return importlib.import_module(tool.__name__.replace(
        "pisces_tpu_torch.", "pisces_tpu."))


def _lines(path, skip=()):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith(skip)]


def _body(path):
    return [ln for ln in _lines(path) if not ln.startswith("#")]


def _assert_dirs_equal(got, want, skip=()):
    """Every file of two output folders byte-equal (lines starting with
    `skip` aside); returns the file names."""
    names = sorted(os.listdir(got))
    assert names == sorted(os.listdir(want))
    for name in names:
        assert _lines(os.path.join(got, name), skip) == \
            _lines(os.path.join(want, name), skip), name
    return names


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def caller(tmp_path_factory):
    """The port's VCF and gVCF of one 20 kb chromosome, on the CPU."""
    tmp = str(tmp_path_factory.mktemp("caller"))
    bam, genome = write_synthetic_workload(tmp, 1, 20_000, 30_000, seed=0)
    out = {"genome": genome}
    for kind, gvcf in (("vcf", "false"), ("gvcf", "true")):
        d = os.path.join(tmp, kind)
        assert torch_main(["-bam", bam, "-g", genome, "-o", d, "-gVCF", gvcf,
                           "-device", "cpu"]) == 0
        out[kind] = os.path.join(
            d, "b.genome.vcf" if gvcf == "true" else "b.vcf")
    assert len(_body(out["vcf"])) > 10
    assert len(_body(out["gvcf"])) > 19_000
    return out


def _hand_psara(d):
    vcf = os.path.join(d, "in.vcf")
    write_vcf(vcf, [vcf_line("chr1", 100, "A", "T"),
                    vcf_line("chr1", 200, "C", "G"),
                    vcf_line("chr1", 300, "G", "A")])
    return vcf


def _hand_spanning(d):
    vcf = os.path.join(d, "in.vcf")
    write_vcf(vcf, [vcf_line("chr1", 140, "ACCCCCCCCCCCCC", "A"),
                    vcf_line("chr1", 300, "G", "A")])
    return vcf


def _hand_multiallelic(d):
    vcf = os.path.join(d, "in.vcf")
    write_vcf(vcf, [vcf_line("chr1", 100, "A", "T", ad="10,45", vf="0.450"),
                    vcf_line("chr1", 100, "A", "G", ad="10,40", vf="0.400"),
                    vcf_line("chr1", 200, "C", "G")])
    return vcf


def _hand_inflated(d):
    """test_satellites.TestVqr's input: 300 C>T calls over a background of
    each other substitution and 2,000 reference lines."""
    lines, pos = [], 1000
    for _ in range(300):
        pos += 10
        lines.append(vcf_line("chr1", pos, "C", "T", dp=500, ad="490,10",
                              vf="0.020"))
    for r, a in [("A", "C"), ("A", "G"), ("A", "T"), ("C", "A"), ("C", "G"),
                 ("G", "A"), ("G", "C"), ("G", "T"), ("T", "A"), ("T", "C"),
                 ("T", "G")]:
        pos += 10
        lines.append(vcf_line("chr1", pos, r, a, dp=500, ad="490,10",
                              vf="0.020"))
    for _ in range(2000):
        pos += 1
        lines.append(vcf_line("chr1", pos, "A", ".", gt="0/0", ad="500",
                              vf="0.000"))
    vcf = os.path.join(d, "noisy.vcf")
    write_vcf(vcf, lines)
    return vcf


def _input(case, caller, d):
    os.makedirs(d, exist_ok=True)
    if case in ("vcf", "gvcf"):
        return caller[case]
    return {"psara": _hand_psara, "spanning": _hand_spanning,
            "multiallelic": _hand_multiallelic,
            "inflated": _hand_inflated}[case](d)


def _planted(src, dst, seed):
    """A second VCF from `src` with one-sided calls: a third of the variant
    lines dropped, a sixth given another alt, every depth scaled, and an
    SNV call planted on one reference line in 200 and between variant
    lines."""
    rng = np.random.default_rng(seed)
    out = []
    for ln in _lines(src):
        if ln.startswith("#"):
            out.append(ln)
            continue
        f = ln.rstrip("\n").split("\t")
        chrom, pos, ref, alt = f[0], int(f[1]), f[3], f[4]
        dp = max(20, int(f[7][3:]) * int(rng.integers(80, 120)) // 100)
        if alt == ".":
            if rng.random() < 0.005 and len(ref) == 1:
                other = "ACGT"[("ACGT".index(ref) + 1) % 4]
                n_alt = int(rng.integers(3, dp // 2))
                out.append(vcf_line(chrom, pos, ref, other, dp=dp,
                                    ad=f"{dp - n_alt},{n_alt}",
                                    vf=f"{n_alt / dp:.3f}") + "\n")
            else:
                out.append(vcf_line(chrom, pos, ref, ".", gt="0/0", dp=dp,
                                    ad=str(dp), vf="0.000") + "\n")
            continue
        r = rng.random()
        if r < 1 / 3:
            continue
        n_alt = max(1, dp * int(rng.integers(10, 60)) // 100)
        if r < 1 / 2 and len(ref) == len(alt) == 1:
            alt = "ACGT"[("ACGT".index(alt) + 1) % 4]
            if alt == ref:
                alt = "ACGT"[("ACGT".index(alt) + 1) % 4]
        out.append(vcf_line(chrom, pos, ref, alt, dp=dp,
                            ad=f"{dp - n_alt},{n_alt}",
                            vf=f"{n_alt / dp:.3f}") + "\n")
        if rng.random() < 0.5:
            # a call one base on, where the source may have nothing
            out.append(vcf_line(chrom, pos + 1, "A", "C", dp=dp,
                                ad=f"{dp - n_alt},{n_alt}",
                                vf=f"{n_alt / dp:.3f}") + "\n")
    with open(dst, "w") as fh:
        fh.writelines(out)
    return dst


# ---------------------------------------------------------------------------
# Psara
# ---------------------------------------------------------------------------

ROIS = {  # the same intervals: BED is 0-based half-open, Picard 1-based
    "hand": {"bed": "chr1\t149\t250\n", "picard": "chr1\t150\t250\n"},
    "caller": {"bed": "chr1\t1999\t9000\nchr1\t11999\t15000\n",
               "picard": "chr1\t2000\t9000\nchr1\t12000\t15000\n"},
}


@pytest.mark.parametrize("roi_kind", ["bed", "picard"])
@pytest.mark.parametrize("mode", ["start", "expanded"])
@pytest.mark.parametrize("case", ["psara", "spanning", "vcf", "gvcf"])
def test_psara_matches_reference(tmp_path, caller, case, mode, roi_kind):
    vcf = _input(case, caller, str(tmp_path / "in"))
    roi = str(tmp_path / f"roi.{roi_kind}")
    with open(roi, "w") as f:
        f.write(ROIS["caller" if case in ("vcf", "gvcf") else "hand"]
                [roi_kind])
    outs = []
    for pkg in (psara, _reference(psara)):
        out = str(tmp_path / f"{pkg.__name__}.vcf")
        pkg.filter_vcf(vcf, out, roi, mode)
        outs.append(_lines(out))
    assert outs[0] == outs[1]
    if case != "spanning" or mode == "expanded":
        assert any(not ln.startswith("#") for ln in outs[0])


# ---------------------------------------------------------------------------
# ReformatVcf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crush", [True, False], ids=["crush", "uncrush"])
@pytest.mark.parametrize("case", ["multiallelic", "vcf", "gvcf"])
def test_reformat_matches_reference(tmp_path, caller, case, crush):
    """One pass, then the other on its output (crush then uncrush, or the
    reverse)."""
    vcf = _input(case, caller, str(tmp_path / "in"))
    for pkg in (reformat, _reference(reformat)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        first = pkg.reformat(vcf, str(d / "first.vcf"), crush=crush)
        pkg.reformat(first, str(d / "second.vcf"), crush=not crush)
    _assert_dirs_equal(str(tmp_path / reformat.__name__),
                       str(tmp_path / _reference(reformat).__name__),
                       skip=DATE_LINE)
    first = _body(str(tmp_path / reformat.__name__ / "first.vcf"))
    if case == "multiallelic":
        assert len(first) == (2 if crush else 3)
    else:
        assert len(first) == len(_body(vcf))


# ---------------------------------------------------------------------------
# VQR
# ---------------------------------------------------------------------------

VQR_MODES = {
    "basic": {},
    "edge": {"do_edge": True},
    "locicount": {"do_edge": True, "loci_count": 5000},
}


@pytest.mark.parametrize("mode", sorted(VQR_MODES))
@pytest.mark.parametrize("case", ["inflated", "vcf", "gvcf"])
def test_vqr_matches_reference(tmp_path, caller, case, mode):
    vcf = _input(case, caller, str(tmp_path / "in"))
    for pkg in (vqr, _reference(vqr)):
        pkg.recalibrate_vcf(vcf, str(tmp_path / pkg.__name__),
                            **VQR_MODES[mode])
    names = _assert_dirs_equal(str(tmp_path / vqr.__name__),
                               str(tmp_path / _reference(vqr).__name__))
    stem = os.path.basename(vcf)[:-len(".vcf")]
    want = {stem + ".counts", stem + ".vcf.recal"}
    if mode != "basic":
        want.add(stem + ".edgecounts")
    assert set(names) == want
    recal = os.path.join(tmp_path, vqr.__name__, stem + ".vcf.recal")
    if case == "inflated":
        # the C>T category is z-scored above baseline: its lines are
        # rewritten, so the recal path ran
        changed = [a for a, b in zip(_body(recal), _body(vcf)) if a != b]
        assert len(_body(recal)) == len(_body(vcf))
        assert changed and all("\tC\tT\t" in ln for ln in changed)


@pytest.mark.parametrize("case", ["inflated", "vcf", "gvcf"])
def test_vqr_with_counts_matches_reference(tmp_path, caller, case):
    """recalibrate_with_counts over the input's own .counts (written by
    pisces_tpu), at the reference's diploid-test settings (z 0, max Q 66,
    baseline Q 30): every category above the trimmed mean is rewritten."""
    vcf = _input(case, caller, str(tmp_path / "in"))
    _reference(vqr).recalibrate_vcf(vcf, str(tmp_path / "counts"))
    counts = str(tmp_path / "counts" /
                 os.path.basename(vcf).replace(".vcf", ".counts"))
    for pkg in (vqr, _reference(vqr)):
        pkg.recalibrate_with_counts(vcf, counts, str(tmp_path / pkg.__name__),
                                    z_factor=0, max_q=66, filter_q=30,
                                    baseline_q=30)
    _assert_dirs_equal(str(tmp_path / vqr.__name__),
                       str(tmp_path / _reference(vqr).__name__))
    recal = os.path.join(tmp_path, vqr.__name__,
                         os.path.basename(vcf) + ".recal")
    assert _body(recal) != _body(vcf)


def test_vqr_counts_and_rates_match_reference(tmp_path):
    """The counters, the counts-file round trip and both rate tables."""
    ref = _reference(vqr)
    vcf = _hand_inflated(str(tmp_path))
    got = vqr.strain_vcf(vcf, extent=2)
    want = ref.strain_vcf(vcf, extent=2)
    for g, w in zip(got, want):
        assert g.counts_by_category == w.counts_by_category
        assert g.num_possible_variants == w.num_possible_variants
    assert got[1].suspects == want[1].suspects
    for z in (0.0, 2.0):
        assert vqr.get_phred_scaled_calibrated_rates(20, z, got[0]) == \
            ref.get_phred_scaled_calibrated_rates(20, z, want[0])
    assert vqr.get_edge_risk_rates(20, 10.0, *got) == \
        ref.get_edge_risk_rates(20, 10.0, *want)
    vqr.write_counts_file(str(tmp_path / "t.counts"), got[0])
    back = vqr.read_counts_file(str(tmp_path / "t.counts"))
    assert back.counts_by_category == got[0].counts_by_category
    for ref_alt in (("C", "T"), ("c", "t"), ("A", "."), ("AC", "A"),
                    ("A", "AT"), ("AC", "GT")):
        assert vqr.mutation_category(*ref_alt) == \
            ref.mutation_category(*ref_alt)
    assert vqr.mutation_category("C", "T", "ForcedReport") == "Other"


# ---------------------------------------------------------------------------
# VennVcf
# ---------------------------------------------------------------------------

def _venn_inputs(case, caller, d):
    os.makedirs(d, exist_ok=True)
    if case == "hand":
        a, b = os.path.join(d, "a.vcf"), os.path.join(d, "b.vcf")
        write_vcf(a, [
            vcf_line("chr1", 100, "A", "T", ad="500,500", vf="0.500"),
            vcf_line("chr1", 200, "C", ".", gt="0/0", ad="1000",
                     vf="0.000")])
        write_vcf(b, [
            vcf_line("chr1", 100, "A", "T", ad="500,500", vf="0.500"),
            vcf_line("chr1", 300, "G", "A", ad="500,500", vf="0.500")])
        return a, b
    src = caller["vcf" if case == "vcf" else "gvcf"]
    return src, _planted(src, os.path.join(d, "planted_S2.vcf"), seed=3)


@pytest.mark.parametrize("debug", [False, True], ids=["plain", "debug"])
@pytest.mark.parametrize("case", ["hand", "vcf", "gvcf"])
def test_venn_matches_reference(tmp_path, caller, case, debug):
    a, b = _venn_inputs(case, caller, str(tmp_path / "in"))
    outs = {}
    for pkg in (vennvcf, _reference(vennvcf)):
        paths = pkg.do_pairwise_venn(a, b, str(tmp_path / pkg.__name__),
                                     consensus=True, debug=debug)
        outs[pkg.__name__] = {k: os.path.basename(p)
                              for k, p in paths.items()}
    assert outs[vennvcf.__name__] == outs[_reference(vennvcf).__name__]
    names = _assert_dirs_equal(str(tmp_path / vennvcf.__name__),
                               str(tmp_path / _reference(vennvcf).__name__))
    assert len(names) == 5
    got = {k: _body(str(tmp_path / vennvcf.__name__ / n))
           for k, n in outs[vennvcf.__name__].items()}
    assert got["consensus"] and got["both"]
    if case != "hand":
        # the planted second VCF has calls of its own and lacks some
        assert got["a_only"] and got["b_only"]


def test_venn_helpers_match_reference():
    ref = _reference(vennvcf)
    for name in ("a_S1.vcf", "x_S12.genome.vcf.gz", "plain.genome.vcf",
                 "b.vcf"):
        assert vennvcf.guess_sample_name(name) == ref.guess_sample_name(name)
    for names, nums in ((("a", "a"), ("S1", "S2")), (("a", "a"), ("S1", "S1")),
                        (("a", "b"), ("S1", "S1"))):
        for i, j in ((0, 1), (1, 0)):
            assert vennvcf._venn_file_name("o", "and", names, nums, i, j) == \
                ref._venn_file_name("o", "and", names, nums, i, j)
    assert vennvcf.ConsensusBuilder().min_frequency_filter == -1.0


# ---------------------------------------------------------------------------
# CreateGenomeSizeFile
# ---------------------------------------------------------------------------

def test_create_genome_size_matches_reference(tmp_path, caller):
    """Both tools on copies of the caller's FASTA (no .fai, no XML): the
    .fai and XML byte-equal, and the XML the workload writer's own with the
    FASTA's md5 in place of its "x"."""
    for pkg in (create_genome_size, _reference(create_genome_size)):
        d = tmp_path / pkg.__name__ / "genome"
        d.mkdir(parents=True)
        shutil.copy(os.path.join(caller["genome"], "chr1.fa"), d)
        assert pkg.main([str(d), "b"]) == 0
    names = _assert_dirs_equal(
        str(tmp_path / create_genome_size.__name__ / "genome"),
        str(tmp_path / _reference(create_genome_size).__name__ / "genome"))
    assert names == ["GenomeSize.xml", "chr1.fa", "chr1.fa.fai"]
    with open(os.path.join(caller["genome"], "chr1.fa"), "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    got = tmp_path / create_genome_size.__name__ / "genome"
    with open(os.path.join(caller["genome"], "GenomeSize.xml")) as f:
        assert (got / "GenomeSize.xml").read_text() == \
            f.read().replace('md5="x"', f'md5="{md5}"')
    with open(os.path.join(caller["genome"], "chr1.fa.fai")) as f:
        assert (got / "chr1.fa.fai").read_text() == f.read()


# ---------------------------------------------------------------------------
# The command lines
# ---------------------------------------------------------------------------

def _cli_args(tool, caller, d):
    """The argv of one run of `tool` into folder `d` (flags in the
    reference's spellings, VQR's in mixed case)."""
    os.makedirs(d, exist_ok=True)
    if tool == "vqr":
        return ["-VCF", caller["gvcf"], "-O", d, "-DoAmpliconPositionChecks",
                "true", "-LociCount", "30000", "-z", "1.5"]
    if tool == "vennvcf":
        return ["-if", f"[{caller['vcf']},{caller['venn_b']}]", "-o", d,
                "-debug", "true"]
    if tool == "psara":
        return ["-vcf", caller["gvcf"], "-roi", caller["roi"],
                "-inclusionmodel", "expanded", "-o", d]
    if tool == "reformat":
        return ["-vcf", caller["vcf"], "-crush", "false", "-o", d]
    shutil.copy(os.path.join(caller["genome"], "chr1.fa"), d)
    return [d, "-out", os.path.join(d, "sizes.xml")]


CLI_MODULES = {"vqr": "satellites.vqr", "vennvcf": "satellites.vennvcf",
               "psara": "satellites.psara", "reformat": "satellites.reformat",
               "create_genome_size": "apps.create_genome_size"}


@pytest.mark.parametrize("tool", sorted(CLI_MODULES))
def test_cli_matches_reference(tmp_path, caller, tool):
    """`python -m pisces_tpu_torch.<tool>` against pisces_tpu's main() on
    the same argv: the same files, byte-equal."""
    import importlib
    inputs = dict(caller, venn_b=_planted(caller["vcf"],
                                          str(tmp_path / "b_S2.vcf"), 5),
                  roi=str(tmp_path / "roi.bed"))
    with open(inputs["roi"], "w") as f:
        f.write(ROIS["caller"]["bed"])
    got, want = str(tmp_path / "t" / "out"), str(tmp_path / "j" / "out")
    r = subprocess.run(
        [sys.executable, "-m", f"pisces_tpu_torch.{CLI_MODULES[tool]}",
         *_cli_args(tool, inputs, got)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = importlib.import_module(f"pisces_tpu.{CLI_MODULES[tool]}")
    assert ref.main(_cli_args(tool, inputs, want)) == 0
    names = _assert_dirs_equal(got, want, skip=DATE_LINE)
    assert names
    if tool == "vqr":
        # the cmdline line names the input, the same for both runs
        recal = _lines(os.path.join(got, "b.genome.vcf.recal"))
        assert any(ln.startswith("##VQR_cmdline") for ln in recal)
        assert "b.genome.edgecounts" in names
    if tool == "create_genome_size":
        assert r.stdout.strip() == os.path.join(got, "sizes.xml")


def test_satellites_import_no_reference_package():
    """The new modules are the port's own: a fresh interpreter that imports
    them has loaded neither JAX nor pisces_tpu."""
    code = ("import sys\n"
            + "".join(f"import pisces_tpu_torch.{m}\n"
                      for m in CLI_MODULES.values())
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'pisces_tpu.')) or m == 'pisces_tpu']\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
