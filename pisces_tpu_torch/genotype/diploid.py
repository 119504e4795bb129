"""Diploid-by-thresholding and haploid genotypers.

Ports of Thresholding/DiploidThresholdingGenotyper.cs,
Thresholding/DiploidGenotypeQualityCalculator.cs,
Haploid/HaploidGenotyper.cs + HaploidGenotypeQualityCalculator.cs and
GenotypeCalculatorUtilities.cs.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
from scipy import stats as sps

from pisces_tpu_torch.domain.types import AlleleCategory, FilterType, Genotype


def _poisson_logpmf(k: int, lam: float) -> float:
    if lam <= 0:
        return 0.0 if k == 0 else -np.inf
    return float(k * math.log(lam) - lam - math.lgamma(k + 1))


def _binom_logpmf(k: int, n: int, p: float) -> float:
    return float(sps.binom.logpmf(k, n, p))


def filter_and_order_by_frequency(alleles: List, prune: List,
                                  min_freq: float) -> List:
    """GenotypeCalculatorUtilities.FilterAndOrderAllelesByFrequency."""
    variants = []
    for a in alleles:
        if a.category != AlleleCategory.REFERENCE:
            if a.frequency >= min_freq:
                variants.append(a)
            else:
                prune.append(a)
    variants.sort(key=lambda a: (-a.frequency, a.chromosome, a.position,
                                 a.ref_allele, a.alt_allele))
    return variants


def get_reference_frequency(alleles: List, minor_vf: float) -> float:
    """GenotypeCalculatorUtilities.GetReferenceFrequency."""
    if not alleles:
        return 0.0
    if len(alleles) == 1:
        return alleles[0].ref_frequency
    ref_by_snp = 0.0
    indel_freq = 0.0
    for a in alleles:
        if a.category == AlleleCategory.REFERENCE:
            return a.frequency
        if a.category == AlleleCategory.SNV:
            ref_by_snp = a.ref_frequency
        else:
            indel_freq += a.frequency
    return max(ref_by_snp - indel_freq, 0.0)


def check_depth_issue(alleles: List, min_depth: int) -> bool:
    return any(a.total_coverage < min_depth for a in alleles)


def check_tri_allelic_issue(has_reference: bool, reference_freq: float,
                            variants: List, threshold: float) -> bool:
    if variants[-1].category != AlleleCategory.SNV:
        return False
    if has_reference and (variants[0].frequency + reference_freq) < threshold:
        return True
    return (variants[0].frequency + variants[1].frequency) < threshold


def get_alleles_to_prune(gt: Genotype, ordered_variants: List,
                         prune: List) -> List:
    allowed = 0
    if gt in (Genotype.ALT_AND_NOCALL, Genotype.ALT_LIKE_NOCALL,
              Genotype.HOMOZYGOUS_ALT, Genotype.HETEROZYGOUS_ALT_REF,
              Genotype.HEMIZYGOUS_ALT):
        allowed = 1
    elif gt in (Genotype.ALT12_LIKE_NOCALL, Genotype.HETEROZYGOUS_ALT1_ALT2):
        allowed = 2
    for i, v in enumerate(ordered_variants):
        if i >= allowed:
            prune.append(v)
    return prune


def convert_simple_to_complex(alleles: List, ordered_variants: List,
                              reference_frequency: float, ref_exists: bool,
                              depth_issue: bool, ref_call: bool,
                              min_var_freq: float, sum_vf_multiallelic: float,
                              preliminary: int) -> Genotype:
    """GenotypeCalculatorUtilities.ConvertSimpleGenotypeToComplexGenotype.
    preliminary: 0=HomRef, 1=HetAltRef, 2=HomAlt."""
    if depth_issue:
        return Genotype.REF_LIKE_NOCALL if ref_call else Genotype.ALT_LIKE_NOCALL
    if preliminary == 0:
        if not ref_exists:
            return Genotype.REF_LIKE_NOCALL
        first = alleles[0]
        if (first.category == AlleleCategory.REFERENCE
                and (1 - first.frequency) > min_var_freq):
            return Genotype.REF_AND_NOCALL
        return Genotype.HOMOZYGOUS_REF
    if preliminary == 1:
        if len(ordered_variants) == 1:
            return (Genotype.HETEROZYGOUS_ALT_REF if ref_exists
                    else Genotype.ALT_AND_NOCALL)
        if check_tri_allelic_issue(ref_exists, reference_frequency,
                                   ordered_variants, sum_vf_multiallelic):
            for a in alleles:
                a.filters.append(FilterType.MULTI_ALLELIC_SITE)
            return (Genotype.ALT_LIKE_NOCALL if ref_exists
                    else Genotype.ALT12_LIKE_NOCALL)
        return (Genotype.HETEROZYGOUS_ALT_REF if ref_exists
                else Genotype.HETEROZYGOUS_ALT1_ALT2)
    return Genotype.HOMOZYGOUS_ALT


def diploid_gq(allele, min_q: int, max_q: int) -> int:
    """DiploidGenotypeQualityCalculator.Compute."""
    if allele.total_coverage == 0:
        return min_q
    gt = allele.genotype
    noise_hom_ref = np.float32(0.05)
    noise_hom_alt = np.float32(0.075)
    noise_het_alt = np.float32(0.10)
    expected_het = np.float32(0.40)
    depth = allele.total_coverage
    non_allele = max(allele.total_coverage - allele.allele_support, 0)

    if gt == Genotype.HOMOZYGOUS_REF:
        h0 = _poisson_logpmf(non_allele, float(noise_hom_ref) * depth)
        h1 = _binom_logpmf(non_allele, depth, float(expected_het))
    elif gt == Genotype.HOMOZYGOUS_ALT:
        h0 = _poisson_logpmf(non_allele, float(noise_hom_alt) * depth)
        h1 = _binom_logpmf(allele.allele_support, depth, float(expected_het))
    elif gt in (Genotype.HETEROZYGOUS_ALT1_ALT2, Genotype.HETEROZYGOUS_ALT_REF):
        k = int(depth * np.float32(allele.frequency))
        h0 = _binom_logpmf(k, depth, float(expected_het))
        if allele.frequency >= 0.50:
            h1 = _binom_logpmf(k, depth, float(1 - noise_het_alt))
        else:
            h1 = _binom_logpmf(k, depth, float(noise_het_alt))
    else:
        return min_q

    q = math.floor(10.0 * math.log10(math.e) * (h0 - h1)) if np.isfinite(h0 - h1) \
        else (max_q if h0 > h1 else min_q)
    int_min = -(2 ** 31)
    if h1 <= int_min and h0 > h1:
        return max_q
    if h0 <= int_min and h0 < h1:
        return min_q
    return max(min(int(q), max_q), min_q)


def haploid_gq(allele, min_q: int, max_q: int) -> int:
    """HaploidGenotypeQualityCalculator.Compute."""
    if allele.total_coverage == 0:
        return min_q
    gt = allele.genotype
    depth = allele.total_coverage
    non_allele = max(allele.total_coverage - allele.allele_support, 0)
    if gt == Genotype.HEMIZYGOUS_REF:
        h0 = _poisson_logpmf(non_allele, 0.05 * depth)
        h1 = _binom_logpmf(non_allele, depth, 0.40)
    elif gt == Genotype.HEMIZYGOUS_ALT:
        h0 = _poisson_logpmf(non_allele, 0.075 * depth)
        h1 = _binom_logpmf(allele.allele_support, depth, 0.40)
    else:
        return min_q
    q = math.floor(10.0 * math.log10(math.e) * (h0 - h1))
    return max(min(int(q), max_q), min_q)


class DiploidThresholdingGenotyper:
    def __init__(self, config):
        from pisces_tpu_torch.options import DiploidThresholdingParameters
        self.snv = getattr(config, "diploid_snv_parameters", None) or \
            DiploidThresholdingParameters()
        self.indel = getattr(config, "diploid_indel_parameters", None) or \
            DiploidThresholdingParameters()
        self.min_gq = config.min_gq_score
        self.max_gq = config.max_gq_score
        self.min_depth = config.min_depth_to_genotype

    def set_genotypes(self, alleles: List) -> List:
        if not alleles:
            return []
        prune: List = []
        ordered = filter_and_order_by_frequency(alleles, prune, self.snv.minor_vf)
        reference_freq = get_reference_frequency(alleles, self.snv.minor_vf)
        ref_exists = reference_freq >= self.snv.minor_vf
        depth_issue = check_depth_issue(alleles, self.min_depth)
        ref_call = (not ordered) or ordered[0].frequency < self.snv.minor_vf

        if ref_call or ordered[0].category == AlleleCategory.SNV:
            params = self.snv
        else:
            params = self.indel

        if ref_call:
            preliminary = 0
        elif params.minor_vf <= ordered[0].frequency <= params.major_vf:
            preliminary = 1
        elif ordered[0].frequency > params.major_vf:
            preliminary = 2
        else:
            preliminary = 0

        gt = convert_simple_to_complex(alleles, ordered, reference_freq,
                                       ref_exists, depth_issue, ref_call,
                                       params.minor_vf,
                                       params.sum_vf_for_multi_allelic_site,
                                       preliminary)
        prune = get_alleles_to_prune(gt, ordered, prune)

        phase_set = 1
        for a in alleles:
            a.genotype = gt
            a.genotype_qscore = diploid_gq(a, self.min_gq, self.max_gq)
            if a.is_ref_type:
                a.phase_set_index = 0
            else:
                a.phase_set_index = phase_set
                phase_set += 1
        return prune


class HaploidGenotyper:
    def __init__(self, config, minor_vf: float = 0.70, major_vf: float = 0.70):
        self.min_gq = config.min_gq_score
        self.max_gq = config.max_gq_score
        self.min_depth = config.min_depth_to_genotype
        self.minor_vf = minor_vf
        self.major_vf = major_vf

    def set_genotypes(self, alleles: List) -> List:
        if not alleles:
            return []
        prune: List = []
        ordered = filter_and_order_by_frequency(alleles, prune, self.minor_vf)
        reference_freq = get_reference_frequency(alleles, self.minor_vf)
        ref_exists = reference_freq >= self.minor_vf
        depth_issue = check_depth_issue(alleles, self.min_depth)
        ref_call = (not ordered) or ordered[0].frequency < self.minor_vf

        gt = Genotype.HEMIZYGOUS_NOCALL
        if not depth_issue and ref_call and ref_exists and reference_freq > self.major_vf:
            gt = Genotype.HEMIZYGOUS_REF
        if (not depth_issue and not ref_call and not ref_exists
                and ordered[0].frequency > self.major_vf):
            gt = Genotype.HEMIZYGOUS_ALT

        prune = get_alleles_to_prune(gt, ordered, prune)
        for a in alleles:
            a.genotype = gt
            a.genotype_qscore = haploid_gq(a, self.min_gq, self.max_gq)
        return prune
