"""Scoring arithmetic of the plain reference, at a chosen precision.

Frozen copy of pisces_tpu_torch/ops/stats.py (Poisson q-score, strand bias,
somatic genotype and GQ), of the diploid genotyper and its GQ
(pisces_tpu_torch/genotype/diploid.py) and of the Python RMxN scan
(pisces_tpu_torch/calling/repeats.py), all at commit 68f5a3446fa7, with the
port's imports replaced by the constants below. Those files follow the
reference caller's C# line by line (cited there); this copy adds only the
`Precision` argument: F64 is the copied arithmetic, F32 the same formulas
with every float in float32 and the regularized incomplete gamma and log
gamma taken from torch's float32 kernels, which is the control of the
correctness check.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

# scipy and torch are imported where they are used: the read layouts take
# this module's constants into the generator's child process, which runs
# while the measured process starts, and importing them there cost that
# set-up about 10 s on the card's machine

# pisces_tpu_torch/domain/types.py
A, G, C, T, N, DEL = range(6)
BASE_TO_ALLELE = np.full(256, N, np.int8)
for _b, _a in zip(b"AGCT", (A, G, C, T)):
    BASE_TO_ALLELE[_b] = _a
ALLELE_CHARS = "AGCTN"
COVERAGE_ALLELES = (A, C, G, T, DEL)
FORWARD, REVERSE, STITCHED = 0, 1, 2
GT_HET_ALT1_ALT2, GT_ALT12_NOCALL, GT_HET, GT_HOM_ALT, GT_HOM_REF, \
    GT_REF_NOCALL, GT_ALT_NOCALL, GT_REF_AND_NOCALL, GT_ALT_AND_NOCALL = range(9)
GT_STRINGS = {GT_HET_ALT1_ALT2: "1/2", GT_ALT12_NOCALL: "./.", GT_HET: "0/1",
              GT_HOM_ALT: "1/1", GT_HOM_REF: "0/0", GT_REF_NOCALL: "./.",
              GT_ALT_NOCALL: "./.", GT_REF_AND_NOCALL: "0/.",
              GT_ALT_AND_NOCALL: "1/."}


class Precision:
    """The float type of the arithmetic and its special functions."""

    def __init__(self, name: str):
        self.name = name
        self.f = np.float64 if name == "f64" else np.float32

    def gammaincc(self, a, x):
        if self.f is np.float64:
            from scipy import special as sp
            return sp.gammaincc(a, x)
        import torch
        return torch.special.gammaincc(
            torch.from_numpy(np.asarray(a, np.float32)),
            torch.from_numpy(np.asarray(x, np.float32))).numpy()

    def gammaln(self, x):
        if self.f is np.float64:
            from scipy import special as sp
            return sp.gammaln(x)
        import torch
        return torch.special.gammaln(
            torch.from_numpy(np.asarray(x, np.float32))).numpy()

    def arr(self, x):
        return np.asarray(x, dtype=self.f)


F64 = Precision("f64")
F32 = Precision("f32")


def q_to_p(q, pr: Precision):
    return np.power(pr.f(10.0), -pr.arr(q) / pr.f(10.0))


def p_to_q(p, pr: Precision):
    return pr.f(-10.0) * np.log10(pr.arr(p))


def poisson_cdf(k, lam, pr: Precision):
    k = pr.arr(k)
    lam = pr.arr(lam)
    a = np.trunc(k + pr.f(1.0))
    out = pr.arr(pr.gammaincc(np.maximum(a, pr.f(1e-30)),
                              np.maximum(lam, pr.f(0.0))))
    return np.where(a <= 0, pr.f(-1.0), out)


def variant_qscores(call_count, coverage, noise_q, max_q, pr: Precision):
    """VariantQualityCalculator.Compute (stats.assign_poisson_qscore and
    compute_variant_qscores): int q-scores."""
    cc = pr.arr(call_count)
    cov = pr.arr(coverage)
    lam = q_to_p(noise_q, pr) * cov
    cdf = pr.arr(pr.gammaincc(np.maximum(cc, pr.f(1e-30)), lam))
    p = pr.f(1.0) - cdf
    with np.errstate(divide="ignore", invalid="ignore"):
        q_direct = np.where(p > 0, p_to_q(np.where(p > 0, p, pr.f(1.0)), pr),
                            pr.f(0.0))
        k = cc - pr.f(1.0)
        log_pmf = (k * np.log(np.maximum(lam, pr.f(1e-30))) - lam
                   - pr.arr(pr.gammaln(k + pr.f(1.0))))
        corr = (cc - lam) / np.maximum(cc, pr.f(1e-30))
        q_fb = (pr.f(-10.0) * (log_pmf - np.log(np.maximum(pr.f(2.0) * corr,
                                                           pr.f(1e-30))))
                / pr.f(math.log(10.0)))
    raw = np.where(p > 0, q_direct, q_fb)
    q = np.maximum(np.minimum(pr.f(max_q), raw), pr.f(0.0))
    iq = np.round(q).astype(np.int64)
    iq = np.where((np.asarray(call_count) <= 0) | (np.asarray(coverage) <= 0),
                  0, iq)
    return np.where(np.asarray(coverage) == 0, 0, iq)


def _populate_stats(support, coverage, noise_freq, min_detectable,
                    pr: Precision):
    """StrandBiasCalculator.PopulateStats, Extended model."""
    support = pr.arr(support)
    coverage = pr.arr(coverage)
    zero = support == 0
    z_cvfgz = np.power(pr.f(1.0) - min_detectable, coverage)
    nz_cvfgz = np.maximum(pr.f(0.0), poisson_cdf(support - pr.f(1.0),
                                                 coverage * noise_freq, pr))
    nz_cfp = np.maximum(pr.f(0.0), pr.f(1.0) - nz_cvfgz)
    cvfgz = np.where(zero, z_cvfgz, nz_cvfgz)
    cfp = np.where(zero, pr.f(1.0) - z_cvfgz, nz_cfp)
    return cfp, cvfgz


def strand_bias(sup_by_dir, cov_by_dir, noise_q, acceptance, pr: Precision):
    """StrandBiasCalculator.CalculateStrandBiasResults (Extended model):
    (gatk score in dB, bias acceptable)."""
    s = np.asarray(sup_by_dir, np.int64)
    c = np.asarray(cov_by_dir, np.int64)
    fs, rs, ss = s[..., FORWARD], s[..., REVERSE], s[..., STITCHED]
    fc, rc, sc = c[..., FORWARD], c[..., REVERSE], c[..., STITCHED]
    err = q_to_p(noise_q, pr)
    ov_cfp, ov_cvfgz = _populate_stats(fs + rs + ss, fc + rc + sc, err, err, pr)
    fw_cfp, fw_cvfgz = _populate_stats(fs + ss // 2, fc + sc // 2, err, err, pr)
    rv_cfp, rv_cvfgz = _populate_stats(rs + ss // 2, rc + sc // 2, err, err, pr)
    with np.errstate(divide="ignore", invalid="ignore"):
        fb = fw_cvfgz * rv_cfp / ov_cvfgz
        rb = rv_cvfgz * fw_cfp / ov_cvfgz
    degenerate = ov_cvfgz == 0
    fb = np.where(degenerate, pr.f(1.0), fb)
    rb = np.where(degenerate, pr.f(1.0), rb)
    bias = np.maximum(fb, rb)
    with np.errstate(divide="ignore"):
        gatk = pr.f(10.0) * np.log10(bias)
    cov_both = (fc + sc // 2 > 0) & (rc + sc // 2 > 0)
    bias = np.where(cov_both, bias, pr.f(0.0))
    gatk = np.where(cov_both, gatk, -np.inf)
    return gatk, bias < acceptance


def frequency(support, total):
    """CalledAllele.Frequency: min(f32 support / f32 total, 1); 0 without
    coverage."""
    support = np.asarray(support)
    total = np.asarray(total)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.minimum(support.astype(np.float32)
                       / np.maximum(total, 1).astype(np.float32),
                       np.float32(1.0))
    return np.where(total == 0, np.float32(0.0), f).astype(np.float32)


def somatic_genotypes(is_reference, freq, ref_freq, total, min_freq_filter,
                      min_depth):
    """SomaticGenotyper.CalculateSomaticGenotype, vectorized."""
    is_reference = np.asarray(is_reference, bool)
    freq = np.asarray(freq, np.float32)
    ref_freq = np.asarray(ref_freq, np.float32)
    total = np.asarray(total)
    fmin = np.float32(min_freq_filter)
    gt = np.full(freq.shape, GT_HOM_REF, np.int64)
    homalt = (ref_freq < fmin) & ~((1 - freq) > fmin)
    altnc = (ref_freq < fmin) & ((1 - freq) > fmin)
    gt = np.where(~is_reference, np.where(altnc, GT_ALT_AND_NOCALL,
                                          np.where(homalt, GT_HOM_ALT,
                                                   GT_HET)), gt)
    gt = np.where(is_reference & (freq < fmin), GT_REF_NOCALL, gt)
    gt = np.where(is_reference & ~(freq < fmin) & ((1 - freq) > fmin),
                  GT_REF_AND_NOCALL, gt)
    low = total < min_depth
    gt = np.where(low & is_reference, GT_REF_NOCALL, gt)
    return np.where(low & ~is_reference, GT_ALT_NOCALL, gt)


def somatic_gq(gt, q, freq, total, target_lod, min_gq, max_gq,
               pr: Precision):
    """SomaticGenotypeQualityCalculator.Compute, vectorized."""
    gt = np.asarray(gt)
    qf = pr.arr(q)
    freq = np.asarray(freq, np.float32)
    total = np.asarray(total)
    is_hom = (gt == GT_HOM_REF) | (gt == GT_HOM_ALT)
    non_allele = (np.float32(1.0) - freq) * total.astype(np.float32)
    expected = np.float32(target_lod) * total.astype(np.float32)
    p1 = q_to_p(qf, pr)
    p2 = poisson_cdf(non_allele.astype(pr.f), expected.astype(pr.f), pr)
    hom_q = p_to_q(np.maximum(p1 + p2, pr.f(1e-30)), pr)
    hom_q = np.where(non_allele >= expected, pr.f(min_gq), hom_q)
    raw = np.where(is_hom, hom_q, qf)
    out = np.round(np.maximum(np.minimum(pr.f(max_gq), raw),
                              pr.f(min_gq))).astype(np.int64)
    nocall = np.isin(gt, (GT_ALT12_NOCALL, GT_ALT_NOCALL, GT_REF_NOCALL))
    return np.where((total == 0) | nocall, min_gq, out)


# ---------------------------------------------------------------------------
# diploid thresholding genotyper (pisces_tpu_torch/genotype/diploid.py)
# ---------------------------------------------------------------------------

def _poisson_logpmf(k, lam, pr: Precision):
    if lam <= 0:
        return 0.0 if k == 0 else -np.inf
    if pr.f is np.float64:
        return float(k * math.log(lam) - lam - math.lgamma(k + 1))
    f = np.float32
    return float(f(k) * np.log(f(lam)) - f(lam)
                 - f(pr.gammaln(np.float32(k + 1))))


def _binom_logpmf(k, n, p, pr: Precision):
    if pr.f is np.float64:
        from scipy import stats as sps
        return float(sps.binom.logpmf(k, n, p))
    f = np.float32
    if k < 0 or k > n:
        return -np.inf
    lg = pr.gammaln(np.array([n + 1, k + 1, n - k + 1], np.float32))
    with np.errstate(divide="ignore"):
        return float(f(lg[0]) - f(lg[1]) - f(lg[2]) + f(k) * np.log(f(p))
                     + f(n - k) * np.log1p(f(-p)))


def diploid_gq(gt, total, support, freq, min_q, max_q, pr: Precision):
    """DiploidGenotypeQualityCalculator.Compute for one allele."""
    if total == 0:
        return min_q
    f32 = np.float32
    depth = total
    non_allele = max(total - support, 0)
    if gt == GT_HOM_REF:
        h0 = _poisson_logpmf(non_allele, float(f32(0.05)) * depth, pr)
        h1 = _binom_logpmf(non_allele, depth, float(f32(0.40)), pr)
    elif gt == GT_HOM_ALT:
        h0 = _poisson_logpmf(non_allele, float(f32(0.075)) * depth, pr)
        h1 = _binom_logpmf(support, depth, float(f32(0.40)), pr)
    elif gt in (GT_HET_ALT1_ALT2, GT_HET):
        k = int(depth * f32(freq))
        h0 = _binom_logpmf(k, depth, float(f32(0.40)), pr)
        if freq >= 0.50:
            h1 = _binom_logpmf(k, depth, float(1 - f32(0.10)), pr)
        else:
            h1 = _binom_logpmf(k, depth, float(f32(0.10)), pr)
    else:
        return min_q
    if np.isfinite(h0 - h1):
        q = math.floor(10.0 * math.log10(math.e) * (h0 - h1))
    else:
        q = max_q if h0 > h1 else min_q
    return max(min(int(q), max_q), min_q)


def diploid_genotype(alleles: List[dict], minor_vf: float, major_vf: float,
                     sum_vf_multi: float, min_depth: int) -> Tuple[int, list]:
    """DiploidThresholdingGenotyper.SetGenotypes over the variant alleles
    (dicts with category 'snv', freq, ref_freq, total) of one locus, with
    no reference allele among them: (genotype, kept alleles ordered by
    frequency)."""
    ordered = sorted((a for a in alleles if a["freq"] >= minor_vf),
                     key=lambda a: (-a["freq"], a["pos"], a["ref"], a["alt"]))
    if len(alleles) == 1:
        ref_freq = alleles[0]["ref_freq"]
    else:
        ref_freq = max(next((a["ref_freq"] for a in reversed(alleles)),
                            0.0), 0.0)
    ref_exists = ref_freq >= minor_vf
    depth_issue = any(a["total"] < min_depth for a in alleles)
    ref_call = (not ordered) or ordered[0]["freq"] < minor_vf
    if ref_call:
        pre = 0
    elif minor_vf <= ordered[0]["freq"] <= major_vf:
        pre = 1
    elif ordered[0]["freq"] > major_vf:
        pre = 2
    else:
        pre = 0
    multi = False
    if depth_issue:
        gt = GT_REF_NOCALL if ref_call else GT_ALT_NOCALL
    elif pre == 0:
        gt = GT_HOM_REF if ref_exists else GT_REF_NOCALL
    elif pre == 1:
        if len(ordered) == 1:
            gt = GT_HET if ref_exists else GT_ALT_AND_NOCALL
        else:
            tri = ((ref_exists and ordered[0]["freq"] + ref_freq
                    < sum_vf_multi)
                   or ordered[0]["freq"] + ordered[1]["freq"] < sum_vf_multi)
            if tri:
                multi = True
                gt = GT_ALT_NOCALL if ref_exists else GT_ALT12_NOCALL
            else:
                gt = GT_HET if ref_exists else GT_HET_ALT1_ALT2
    else:
        gt = GT_HOM_ALT
    allowed = (1 if gt in (GT_ALT_AND_NOCALL, GT_ALT_NOCALL, GT_HOM_ALT,
                           GT_HET)
               else 2 if gt in (GT_ALT12_NOCALL, GT_HET_ALT1_ALT2) else 0)
    kept = ordered[:allowed]
    for a in kept:
        a["multi"] = multi
    return gt, kept


# ---------------------------------------------------------------------------
# RMxN (pisces_tpu_torch/calling/repeats.py)
# ---------------------------------------------------------------------------

def _rmxn_for_indel(variant_position: int, variant_bases: str, ref: str,
                    max_unit_len: int) -> int:
    max_found = 0
    length = len(variant_bases)
    bookends = []
    for i in range(length - min(max_unit_len, length), length):
        bookends.append(variant_bases[:length - i])
        bookends.append(variant_bases[i:])
    for unit in bookends:
        n = len(unit)
        back = variant_position
        while back - n >= 0 and ref[back - n:back] == unit:
            back -= n
        count, cur = 0, back
        while cur + n <= len(ref) and ref[cur:cur + n] == unit:
            count += 1
            cur += n
        max_found = max(max_found, count)
    return max_found


def rmxn_filtered(position: int, ref_allele: str, alt_allele: str,
                  freq: float, ref: str, max_len: int, min_reps: int,
                  freq_limit: float) -> bool:
    """RMxNCalculator.ShouldFilter for an SNV."""
    if np.float32(freq) >= np.float32(freq_limit):
        return False
    c1 = _rmxn_for_indel(position - 1, ref_allele, ref, max_len)
    c2 = max(_rmxn_for_indel(position + len(ref_allele) - 1, alt_allele, ref,
                             max_len),
             _rmxn_for_indel(position - 1, alt_allele, ref, max_len))
    return min(c1, c2) >= min_reps
