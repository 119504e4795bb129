"""Germline (hap.py-analog) and MNV/phasing accuracy harnesses.

The reference's paper analysis has two accuracy arms
(the reference's docker/ExamplePiscesPaperAnalysis/run_analysis.sh):
the som.py somatic titration (:84-135, covered by apps/titration.py) and a
hap.py germline comparison (:142+ — ``-ploidy diploid`` against an
NA12878-style het/hom truth set, scored genotype-aware). The truth sets
are external downloads, so that flow cannot run hermetically; this module
reproduces both *measurements* on planted truth:

* ``run_germline`` — plant het (VF 0.5) and hom (VF 1.0) SNV/indel sites,
  call with the diploid ploidy models
  (DiploidThresholdingGenotyper.cs:53-138 semantics, or the adaptive-GT
  model), and score hap.py-style: a TP requires the exact allele AND the
  exact genotype (0/1 for het, 1/1 for hom) on a PASS line.

* ``run_mnv_accuracy`` — plant multi-site haplotypes (2-3 nearby SNVs
  carried on the same reads), call directly with ``-CallMNVs``
  (CandidateVariantFinder MNV build-up), and score phased-MNV
  recall/precision by exact (chrom,pos,ref,alt) match. Its Scylla mode
  (VariantPhaser.cs:44-157, PhasedVariantExtractor.cs:40-233) needs
  ``phasing/`` and is not yet ported (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.apps.titration import (
    TruthSite, _write_genome, generate_titration_workload,
)
from pisces_tpu_torch.utils.logger import log


# ---------------------------------------------------------------------------
# germline arm
# ---------------------------------------------------------------------------

@dataclass
class GermlineResult:
    zygosity: str           # "het" | "hom"
    n_sites: int = 0
    tp: int = 0             # allele + genotype both correct, PASS
    gt_err: int = 0         # allele called PASS but wrong genotype
    fn: int = 0
    fp: int = 0             # PASS variant alleles not in truth

    @property
    def recall(self) -> float:
        return self.tp / max(1, self.n_sites)

    @property
    def precision(self) -> float:
        return self.tp / max(1, self.tp + self.fp)

    @property
    def gt_concordance(self) -> float:
        found = self.tp + self.gt_err
        return self.tp / max(1, found)


def _expected_gt(vf: float) -> str:
    return "0/1" if vf < 0.75 else "1/1"


def score_germline(vcf_path: str, truth: List[TruthSite]
                   ) -> Dict[str, GermlineResult]:
    """hap.py-style genotype-aware scoring: allele match on
    (chrom,pos,ref,alt) over PASS lines, then GT must equal the planted
    zygosity. Crushed diploid output can carry two alts on one line
    (GT 1/2); those count as genotype errors for a planted het/hom."""
    res = {"het": GermlineResult("het"), "hom": GermlineResult("hom")}
    tkey = {}
    for t in truth:
        z = "het" if t.vf < 0.75 else "hom"
        tkey[(t.chrom, t.position, t.ref, t.alt)] = (t, z)
        res[z].n_sites += 1
    seen: Dict[Tuple, str] = {}
    fp = 0
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if f[6] != "PASS" or f[4] in (".", "<M>"):
                continue
            fmt = f[8].split(":")
            smp = f[9].split(":")
            try:
                gt = smp[fmt.index("GT")]
            except (ValueError, IndexError):
                gt = "./."
            alts = f[4].split(",")
            for ai, alt in enumerate(alts):
                key = (f[0], int(f[1]), f[3], alt)
                if key in tkey:
                    # normalize the GT against THIS alt's index: for a
                    # single-alt line 0/1 or 1/1 is direct; for 1/2 lines
                    # each alt appears once -> het-like per allele
                    idx = str(ai + 1)
                    counts = gt.replace("|", "/").split("/")
                    n_alt = sum(1 for g in counts if g == idx)
                    norm = ("1/1" if n_alt >= 2
                            else ("0/1" if n_alt == 1 else "./."))
                    seen[key] = norm
                else:
                    fp += 1
    for key, (t, z) in tkey.items():
        if key not in seen:
            res[z].fn += 1
        elif seen[key] == _expected_gt(t.vf):
            res[z].tp += 1
        else:
            res[z].gt_err += 1
    # FPs are not zygosity-attributable; charge them to both rows'
    # precision denominators via a shared count
    res["het"].fp = fp
    res["hom"].fp = fp
    return res


def run_germline(outdir: str,
                 sites_per_zyg: int = 60,
                 depth: int = 150,
                 adaptive: bool = False,
                 device="cuda",
                 backend: str = "torch",
                 seed: int = 11,
                 chrom_len: int = 36_000) -> Dict[str, GermlineResult]:
    """Generate het/hom truth → call diploid → genotype-aware score.
    Writes ``germline_summary.csv`` (one row per zygosity) next to the
    VCF. ``adaptive=True`` uses the adaptive-GT ploidy model instead of
    thresholding (run_analysis.sh:142+ calls both). `device` and `backend`
    as apps/pisces.process_bam takes them."""
    from pisces_tpu_torch.apps.pisces import process_bam
    from pisces_tpu_torch.domain.types import PloidyModel
    from pisces_tpu_torch.io.fasta import Genome
    from pisces_tpu_torch.options import PiscesApplicationOptions

    bam, gdir, truth = generate_titration_workload(
        outdir, vf_points=(0.5, 1.0), sites_per_point=sites_per_zyg,
        depth=depth, seed=seed, chrom_len=chrom_len)
    o = PiscesApplicationOptions()
    o.output_directory = outdir
    o.call_mnvs = False
    o.vcf_writing_parameters.output_gvcf_file = False
    o.variant_calling_parameters.ploidy_model = (
        PloidyModel.DIPLOID_BY_ADAPTIVE_GT if adaptive
        else PloidyModel.DIPLOID_BY_THRESHOLDING)
    o.validate()
    vcf = process_bam(o, bam, Genome(gdir), device=device, backend=backend)
    res = score_germline(vcf, truth)
    csv = os.path.join(outdir, "germline_summary.csv")
    with open(csv, "w") as f:
        f.write("model,zygosity,n_sites,tp,gt_err,fn,fp,recall,precision,"
                "gt_concordance\n")
        model = "adaptive" if adaptive else "thresholding"
        for z in ("het", "hom"):
            r = res[z]
            f.write(f"{model},{z},{r.n_sites},{r.tp},{r.gt_err},{r.fn},"
                    f"{r.fp},{r.recall:.4f},{r.precision:.4f},"
                    f"{r.gt_concordance:.4f}\n")
    log(f"germline summary written to {csv}")
    return res


# ---------------------------------------------------------------------------
# MNV / phasing arm
# ---------------------------------------------------------------------------

@dataclass
class MnvResult:
    n_truth: int = 0
    tp: int = 0
    fp: int = 0   # called MNVs (len(ref)==len(alt)>1) not in truth
    fn: int = 0

    @property
    def recall(self) -> float:
        return self.tp / max(1, self.tp + self.fn)

    @property
    def precision(self) -> float:
        return self.tp / max(1, self.tp + self.fp)


def generate_mnv_workload(outdir: str,
                          n_haplotypes: int = 40,
                          depth: int = 300,
                          vf: float = 0.25,
                          read_len: int = 100,
                          chrom_len: int = 30_000,
                          base_error_rate: float = 0.001,
                          seed: int = 13
                          ) -> Tuple[str, str, List[TruthSite]]:
    """Plant multi-site haplotypes: each is 2-3 SNVs within a <=7bp span,
    ALL carried on the same ``vf`` fraction of spanning reads (so they are
    physically phased, the property Scylla recovers from read evidence).
    Truth is the combined MNV allele — reference bases between the SNVs
    are included, the reference's phased-MNV representation
    (PhasedVariantExtractor.cs:40-233)."""
    from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter, \
        parse_cigar_string

    rng = np.random.default_rng(seed)
    shutil.rmtree(outdir, ignore_errors=True)
    gdir = os.path.join(outdir, "genome")
    chrom = "chrM2"
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bases[rng.integers(0, 4, chrom_len)]
    _write_genome(gdir, chrom, seq)

    spacing = (chrom_len - 4 * read_len) // (n_haplotypes + 1)
    assert spacing >= 2 * read_len, "chrom too short for haplotype count"
    slots = (np.arange(1, n_haplotypes + 1) * spacing
             + read_len).astype(np.int64)
    # offset patterns: adjacent pairs/triples and gapped pairs/triples
    patterns = ([0, 1], [0, 2], [0, 1, 2], [0, 3], [0, 2, 4], [0, 3, 6])
    truth: List[TruthSite] = []
    hap_alt: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for hi, s in enumerate(slots.tolist()):
        offs = np.array(patterns[hi % len(patterns)], np.int64)
        span = int(offs[-1]) + 1
        ref_str = seq[s - 1:s - 1 + span].tobytes().decode()
        alt = list(ref_str)
        for off in offs.tolist():
            b = seq[s - 1 + off]
            alt[off] = chr(bases[(int(np.searchsorted(bases, b)) + 1) % 4])
        truth.append(TruthSite(chrom, s, ref_str, "".join(alt), vf))
        hap_alt[s] = (offs, np.frombuffer(
            "".join(alt).encode(), np.uint8)[offs])
    truth.sort(key=lambda t: t.position)
    t_pos = np.array([t.position for t in truth])

    n_reads = depth * chrom_len // read_len
    w = BamWriter(os.path.join(outdir, "mnv.bam"), [chrom], [chrom_len])
    cig = parse_cigar_string(f"{read_len}M")
    q30 = [30] * read_len
    starts = np.sort(rng.integers(1, chrom_len - read_len, n_reads))
    n_err = int(rng.binomial(n_reads * read_len, base_error_rate))
    flat = np.sort(rng.integers(0, n_reads * read_len, n_err))
    err_rows, err_cols = flat // read_len, flat % read_len
    err_starts = np.searchsorted(err_rows, np.arange(n_reads + 1))
    carrier = rng.random(n_reads)
    for i in range(n_reads):
        p = int(starts[i])
        rseq = bytearray(seq[p - 1:p - 1 + read_len].tobytes())
        for off in err_cols[err_starts[i]:err_starts[i + 1]]:
            rseq[off] = ord("ACGT"[(rseq[off] + 1) % 4])
        j = int(np.searchsorted(t_pos, p))
        site = truth[j] if j < len(truth) else None
        # eligible carriers must span the whole haplotype with >=8bp
        # margins; scale the carrier probability by the eligible-offset
        # fraction so realized VF matches the label (same scheme as the
        # titration generator)
        if (site is not None
                and site.position + len(site.ref) - 1 < p + read_len - 8
                and site.position - p >= 8
                and carrier[i] < site.vf * read_len
                / max(1, read_len - 16 - (len(site.ref) - 1))):
            offs, alt_b = hap_alt[site.position]
            base_off = site.position - p
            for off, ab in zip(offs.tolist(), alt_b.tolist()):
                rseq[base_off + off] = ab
        w.records.append(BamRecord(
            f"m{i}", 0, p - 1, 60, 0x10 if i & 1 else 0, cig,
            rseq.decode(), q30))
    w.write()
    return os.path.join(outdir, "mnv.bam"), gdir, truth


def score_mnvs(vcf_path: str, truth: List[TruthSite]) -> MnvResult:
    """Exact (chrom,pos,ref,alt) matching of PASS multi-nucleotide calls.
    Precision counts only MNV-shaped calls (len(ref)==len(alt)>1) as FP
    candidates — isolated SNV lines (unphased leftovers) are not MNV
    false positives."""
    res = MnvResult(n_truth=len(truth))
    tkeys = {(t.chrom, t.position, t.ref, t.alt) for t in truth}
    seen = set()
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if f[6] != "PASS" or f[4] in (".", "<M>"):
                continue
            for alt in f[4].split(","):
                key = (f[0], int(f[1]), f[3], alt)
                if key in tkeys:
                    seen.add(key)
                elif len(f[3]) > 1 and len(alt) == len(f[3]):
                    res.fp += 1
    res.tp = len(seen)
    res.fn = res.n_truth - res.tp
    return res


def run_mnv_accuracy(outdir: str,
                     mode: str = "mnv",
                     n_haplotypes: int = 40,
                     depth: int = 300,
                     vf: float = 0.25,
                     device="cuda",
                     backend: str = "torch",
                     seed: int = 13) -> MnvResult:
    """Generate phased-haplotype truth → call → score.

    mode="mnv":    direct ``-CallMNVs true`` calling (MaxSizeMNV 100,
                   MaxGapBetweenMNV 10 — run_analysis.sh MNV classes).
    mode="scylla": SNV calls phased by Scylla; needs phasing/, not yet
                   ported (ROADMAP Queue 1 item 11).
    `device` and `backend` as apps/pisces.process_bam takes them."""
    if mode != "mnv":
        raise NotImplementedError(
            f"the {mode!r} arm of the MNV accuracy run needs phasing/ "
            "(Scylla), not yet ported (ROADMAP Queue 1 item 11)")
    from pisces_tpu_torch.apps.pisces import process_bam
    from pisces_tpu_torch.io.fasta import Genome
    from pisces_tpu_torch.options import PiscesApplicationOptions

    bam, gdir, truth = generate_mnv_workload(
        outdir, n_haplotypes=n_haplotypes, depth=depth, vf=vf, seed=seed)
    o = PiscesApplicationOptions()
    o.output_directory = outdir
    o.vcf_writing_parameters.output_gvcf_file = False
    o.call_mnvs = True
    o.max_size_mnv = 100
    o.max_gap_between_mnv = 10
    o.validate()
    vcf = process_bam(o, bam, Genome(gdir), device=device, backend=backend)
    res = score_mnvs(vcf, truth)
    csv = os.path.join(outdir, f"mnv_summary_{mode}.csv")
    with open(csv, "w") as f:
        f.write("mode,n_truth,tp,fp,fn,recall,precision\n")
        f.write(f"{mode},{res.n_truth},{res.tp},{res.fp},{res.fn},"
                f"{res.recall:.4f},{res.precision:.4f}\n")
    log(f"mnv summary written to {csv}")
    return res


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="pisces_tpu_torch.accuracy",
        description="germline (hap.py-analog) and MNV accuracy harnesses")
    p.add_argument("arm", choices=["germline", "mnv", "scylla"])
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("-backend", default="torch", choices=["torch", "numpy"])
    a = p.parse_args(argv)
    if a.arm != "germline":
        r = run_mnv_accuracy(a.out, mode=a.arm, device=a.device,
                             backend=a.backend, seed=a.seed)
        print(f"{a.arm}: R {r.recall:.3f} P {r.precision:.3f} "
              f"(tp={r.tp} fp={r.fp} fn={r.fn})")
        return 0
    res = run_germline(a.out, adaptive=a.adaptive, device=a.device,
                       backend=a.backend, seed=a.seed)
    for z, r in res.items():
        print(f"{z}: R {r.recall:.3f} P {r.precision:.3f} "
              f"GTconc {r.gt_concordance:.3f} "
              f"(tp={r.tp} gt_err={r.gt_err} fn={r.fn} fp={r.fp})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
