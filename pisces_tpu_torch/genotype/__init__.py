"""Ploidy-dispatched genotype calculators.

Reference: src/lib/Pisces.Genotyping/GenotypeCreator.cs:8-68 (dispatch),
Somatic/SomaticGenotyper.cs (somatic), Thresholding/ and Adaptive/ (diploid),
Haploid/HaploidGenotyper.cs.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from pisces_tpu_torch.domain.types import AlleleCategory, Genotype, PloidyModel
from pisces_tpu_torch.ops import stats


class SomaticGenotyper:
    """SomaticGenotyper + SomaticGenotypeQualityCalculator."""

    def __init__(self, min_variant_frequency_filter: float, min_depth: int,
                 min_gq: int, max_gq: int, target_lod_frequency: float):
        self.min_variant_frequency_filter = min_variant_frequency_filter
        self.min_depth = min_depth
        self.min_gq = min_gq
        self.max_gq = max_gq
        self.target_lod_frequency = target_lod_frequency

    def set_genotypes(self, alleles: List) -> List:
        if not alleles:
            return []
        is_ref = np.array([a.category == AlleleCategory.REFERENCE for a in alleles])
        freq = np.array([a.frequency for a in alleles], dtype=np.float32)
        ref_freq = np.array([a.ref_frequency for a in alleles], dtype=np.float32)
        cov = np.array([a.total_coverage for a in alleles])
        q = np.array([a.variant_qscore for a in alleles])

        gts = stats.somatic_genotypes(is_ref, freq, ref_freq, cov,
                                      self.min_variant_frequency_filter,
                                      self.min_depth)
        gqs = stats.somatic_genotype_qscores(gts, q, freq, cov,
                                             self.target_lod_frequency,
                                             self.min_gq, self.max_gq)
        for a, gt, gq in zip(alleles, gts, gqs):
            a.genotype = Genotype(int(gt))
            a.genotype_qscore = int(gq)
        return []  # somatic prunes nothing


def get_ploidy_for_chr(sample_ploidy: PloidyModel, is_male: Optional[bool],
                       ref_name: Optional[str]) -> PloidyModel:
    """GenotypeCreator.GetPloidyForThisChr."""
    if sample_ploidy == PloidyModel.SOMATIC or ref_name in ("chrM", "M"):
        return PloidyModel.SOMATIC
    if sample_ploidy == PloidyModel.HAPLOID:
        return PloidyModel.HAPLOID
    if is_male is None:
        return sample_ploidy
    if is_male and ref_name in ("chrY", "chrX", "Y", "X"):
        return PloidyModel.HAPLOID
    if not is_male and ref_name in ("chrY", "Y"):
        return PloidyModel.HAPLOID
    return sample_ploidy


def create_genotype_calculator(config, ref_name: Optional[str] = None,
                               is_male: Optional[bool] = None):
    ploidy = get_ploidy_for_chr(config.ploidy_model, is_male, ref_name)
    if ploidy == PloidyModel.SOMATIC:
        return SomaticGenotyper(config.min_frequency_filter,
                                config.min_depth_to_genotype,
                                config.min_gq_score, config.max_gq_score,
                                config.target_lod_frequency)
    if ploidy == PloidyModel.DIPLOID_BY_THRESHOLDING:
        from pisces_tpu_torch.genotype.diploid import DiploidThresholdingGenotyper
        return DiploidThresholdingGenotyper(config)
    if ploidy == PloidyModel.HAPLOID:
        from pisces_tpu_torch.genotype.diploid import HaploidGenotyper
        return HaploidGenotyper(config)
    if ploidy == PloidyModel.DIPLOID_BY_ADAPTIVE_GT:
        from pisces_tpu_torch.genotype.adaptive import DiploidAdaptiveGenotyper
        return DiploidAdaptiveGenotyper(config)
    raise ValueError(f"unsupported ploidy model {ploidy}")
