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

* ``run_mnv_accuracy`` — the MNV / phasing arm (-CallMNVs calling or the
  Scylla flow); not yet ported (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from pisces_tpu_torch.apps.titration import (
    TruthSite, generate_titration_workload,
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

def run_mnv_accuracy(outdir: str, mode: str = "mnv", **kwargs):
    """The MNV / phasing arm (direct -CallMNVs calling or the Scylla flow)
    is not yet ported (ROADMAP Queue 1 item 7)."""
    raise NotImplementedError("the MNV accuracy arm is not yet ported "
                              "(ROADMAP Queue 1 item 7)")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="pisces_tpu_torch.accuracy",
        description="germline (hap.py-analog) accuracy harness")
    p.add_argument("arm", choices=["germline", "mnv", "scylla"])
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("-backend", default="torch", choices=["torch", "numpy"])
    a = p.parse_args(argv)
    if a.arm != "germline":
        run_mnv_accuracy(a.out, mode=a.arm)
    res = run_germline(a.out, adaptive=a.adaptive, device=a.device,
                       backend=a.backend, seed=a.seed)
    for z, r in res.items():
        print(f"{z}: R {r.recall:.3f} P {r.precision:.3f} "
              f"GTconc {r.gt_concordance:.3f} "
              f"(tp={r.tp} gt_err={r.gt_err} fn={r.fn} fp={r.fp})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
