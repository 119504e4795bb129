"""Allele calling orchestration for one chromosome batch.

Port of the AlleleCaller pipeline (exe/Pisces/Logic/VariantCalling/
AlleleCaller.cs:50-264): collapse -> MNV triage/reallocation -> per-candidate
scoring (coverage, Poisson q-score, strand bias) -> filters -> per-locus
genotyping -> deterministic ordering.

This module operates in batch mode: one call covers a whole chromosome or
window, so the reference's streaming block protocol (RegionStateManager's
upToPosition, and the MNV pieces and collapse targets it carries into the
next block) has no counterpart. Large candidate batches score their
Poisson q on a torch device (ops/torch_scoring.score_snv_loci).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from pisces_tpu_torch.parallel.sharding import Mesh

from pisces_tpu_torch.domain.types import (
    BASE_TO_ALLELE, NUM_DIRECTION_TYPES, AlleleCategory, AlleleType,
    CoverageMethod, FilterType, Genotype, NoiseModel, PloidyModel,
    StrandBiasModel,
)
from pisces_tpu_torch.options import PiscesApplicationOptions
from pisces_tpu_torch.calling.alleles import CalledAllele, map_candidate
from pisces_tpu_torch.calling.collapser import VariantCollapser
from pisces_tpu_torch.calling.mnv_realloc import (
    get_ref_support_from_gapped_mnvs, reallocate_failed_mnvs,
)
from pisces_tpu_torch.calling.repeats import (
    RefSeqStr, compute_indel_repeat_length, rmxn_should_filter,
)
from pisces_tpu_torch.calling.source import AlleleSource
from pisces_tpu_torch.ops import stats
from pisces_tpu_torch.ops.coverage import (
    SpanningColumns, spanning_coverage_columns,
)
from pisces_tpu_torch.pileup.candidates import Candidate
from pisces_tpu_torch.pileup.candidates_fast import SnvCandidateBatch
from pisces_tpu_torch.pileup.counts import PileupCounts
from pisces_tpu_torch.utils.metrics import metrics

# candidate batches of at least this many alleles score their q on the
# device (CallerConfig.device_batch_threshold)
DEVICE_BATCH_THRESHOLD = 4096


@dataclass
class CallerConfig:
    """VariantCallerConfig equivalent (AlleleCaller.cs:267-292)."""

    include_reference_calls: bool = True
    min_coverage: int = 10
    min_frequency: float = 0.01
    max_variant_qscore: int = 100
    min_variant_qscore: int = 20
    variant_qscore_filter_threshold: Optional[int] = 30
    no_call_filter_threshold: Optional[float] = 0.6
    amplicon_bias_filter_threshold: Optional[float] = None
    noise_level_used_for_q_scoring: int = 20
    strand_bias_filter_threshold: float = 0.5
    filter_single_strand_variants: bool = False
    strand_bias_model: StrandBiasModel = StrandBiasModel.EXTENDED
    variant_freq_filter: Optional[float] = 0.01
    low_gtq_filter: Optional[int] = None
    indel_repeat_filter: Optional[int] = None
    low_depth_filter: Optional[int] = 10
    rmxn_max_length_repeat: Optional[int] = 5
    rmxn_min_repetitions: Optional[int] = 9
    rmxn_frequency_limit: Optional[float] = 0.35
    noise_model: NoiseModel = NoiseModel.FLAT
    ploidy_model: PloidyModel = PloidyModel.SOMATIC
    # somatic genotyper params
    min_frequency_filter: float = 0.01
    target_lod_frequency: float = 0.01
    min_gq_score: int = 0
    max_gq_score: int = 100
    min_depth_to_genotype: int = 10
    consider_anchor_information: bool = True
    expect_stitched_source: bool = False
    coverage_method: "CoverageMethod" = None  # CoverageMethod.EXACT enables read-spanning coverage
    # device routing for the batched candidate-scoring pass: with a torch
    # device, batches at or above the threshold score their q on it
    # (ops/torch_scoring.score_snv_loci); smaller batches, and every batch
    # when device is None (-backend numpy), stay on the vectorized f64 host
    # path. The threshold is the reference package's, kept for output
    # parity; integer q outputs are exact either way.
    device: Optional[torch.device] = None
    device_batch_threshold: int = DEVICE_BATCH_THRESHOLD
    # a parallel/sharding.Mesh (-MeshDevices > 1): device candidate batches
    # shard over its devices (sharded_score_snv_tuples)
    mesh: Optional[Mesh] = None
    # -gender: drives per-chromosome ploidy dispatch (sex chromosomes go
    # haploid, GenotypeCreator.GetPloidyForThisChr)
    is_male: Optional[bool] = None
    # per-allele strand-bias component tables (forward/reverse/overall
    # ChanceFalsePos etc.) are only materialized when the bias side files
    # are requested (StrandBiasFileWriter columns)
    need_sb_detail: bool = False

    @classmethod
    def from_options(cls, options: PiscesApplicationOptions) -> "CallerConfig":
        v = options.variant_calling_parameters
        return cls(
            include_reference_calls=options.vcf_writing_parameters.output_gvcf_file,
            min_coverage=v.minimum_coverage,
            min_frequency=v.minimum_frequency,
            max_variant_qscore=v.maximum_variant_qscore,
            min_variant_qscore=v.minimum_variant_qscore,
            variant_qscore_filter_threshold=v.minimum_variant_qscore_filter,
            no_call_filter_threshold=v.no_call_filter_threshold,
            amplicon_bias_filter_threshold=v.amplicon_bias_filter_threshold,
            noise_level_used_for_q_scoring=v.noise_level_used_for_q_scoring,
            strand_bias_filter_threshold=v.strand_bias_acceptance_criteria,
            filter_single_strand_variants=v.filter_out_variants_present_only_one_strand,
            strand_bias_model=v.strand_bias_model,
            variant_freq_filter=max(v.minimum_frequency_filter, v.minimum_frequency),
            low_gtq_filter=v.low_genotype_quality_filter,
            indel_repeat_filter=v.indel_repeat_filter,
            low_depth_filter=v.low_depth_filter,
            rmxn_max_length_repeat=v.rmxn_filter_max_length_repeat,
            rmxn_min_repetitions=v.rmxn_filter_min_repetitions,
            rmxn_frequency_limit=v.rmxn_filter_frequency_limit,
            noise_model=v.noise_model,
            coverage_method=options.coverage_method,
            need_sb_detail=options.output_bias_files,
            device_batch_threshold=DEVICE_BATCH_THRESHOLD,
            is_male=v.is_male,
            ploidy_model=v.ploidy_model,
            min_frequency_filter=max(v.minimum_frequency_filter, v.minimum_frequency),
            target_lod_frequency=max(v.target_lod_frequency,
                                     max(v.minimum_frequency_filter, v.minimum_frequency)),
            min_gq_score=v.minimum_genotype_qscore,
            max_gq_score=v.maximum_genotype_qscore,
            min_depth_to_genotype=v.minimum_coverage,
            consider_anchor_information=options.tracked_anchor_size > 0,
        )


_SPANNING = (AlleleCategory.DELETION, AlleleCategory.MNV,
             AlleleCategory.INSERTION)


class _SbSliceView:
    """Per-allele view into a batched strand-bias result dict (the
    StrandBiasFileWriter reads sb[group][stat][0] per allele)."""

    __slots__ = ("_batch", "_i")

    def __init__(self, batch: dict, i: int):
        self._batch = batch
        self._i = i

    def __getitem__(self, key):
        v = self._batch[key]
        if isinstance(v, dict):
            return {k: arr[self._i:self._i + 1] for k, arr in v.items()}
        return v[self._i:self._i + 1]


class AlleleCaller:
    def __init__(self, config: CallerConfig, refseq: np.ndarray,
                 collapser: Optional[VariantCollapser] = None,
                 interval_set=None, read_summaries=None):
        self.config = config
        self.refseq = refseq
        self.refseq_str = RefSeqStr(refseq)
        self.collapser = collapser
        self.interval_set = interval_set
        self.read_summaries = read_summaries
        self.forced_alleles: set = set()
        self.total_num_called = 0
        # loci whose reference allele was suppressed by a coexisting
        # variant (even one later pruned by genotyping) — consumed by the
        # fast-gVCF splice
        self.ref_suppressed_positions: set = set()

    @property
    def total_num_collapsed(self) -> int:
        return 0 if self.collapser is None else self.collapser.total_num_collapsed

    # -- coverage, scoring, filters (ProcessVariant, AlleleCaller.cs:208-234)
    #
    # The reference scores one allele at a time inside the per-candidate
    # loop; this build phases the same math so that a batch of SNV rows and
    # candidate alleles hits the vectorized kernels once:
    #   coverage  point coverage gathered as columns for the SNV rows and
    #             the SNV/reference alleles, spanning coverage in one column
    #             pass over the indels and MNVs
    #   scoring   q-score + strand bias over the whole batch (host f64
    #             vectorized, or the torch device for large batches), then
    #             amplicon bias
    #   filters   per-allele filters on the alleles, callability as masks on
    #             the rows; the rows reported or forced become CalledAlleles

    def _score_and_filter(self, source: AlleleSource,
                          objects: List[CalledAllele],
                          snvs: Optional[SnvCandidateBatch] = None
                          ) -> List[CalledAllele]:
        """Steps coverage, scoring and filters on SNV rows (None: none) and
        alleles. Returns the rows that are callable and reported, or
        forced, as CalledAlleles, then `objects`: the order the reference
        scores them in. Callable rows left out count as called, as call's
        loop would count them."""
        rows = _no_snvs() if snvs is None else snvs
        n = len(rows)
        if not objects and not n:
            return []
        cfg = self.config
        with metrics.stage("allele_calling.coverage"):
            self._coverage(source, objects)
            cov_cols, _ = _point_coverage(
                source, rows.position,
                BASE_TO_ALLELE[rows.ref_base].astype(np.int64), True)
            cov_by_dir, cov, num_nc, sum_bq, ref_sup = cov_cols
            sup_by_dir = rows.support_by_direction
            sup = sup_by_dir.sum(axis=1)

        with metrics.stage("allele_calling.scoring"):
            # one batch, rows first (the device threshold counts both)
            scored_rows = np.nonzero(sup > 0)[0]
            scored = [a for a in objects if a.allele_support > 0]
            q = np.zeros(n, np.int64)
            scores = None
            if len(scored_rows) or scored:
                row_cols = (sup, cov, sup_by_dir, cov_by_dir, ref_sup,
                            num_nc, sum_bq)
                scores = self._score_columns(*(
                    np.concatenate([c[scored_rows], o]) for c, o in
                    zip(row_cols, _allele_columns(scored))))
                k = len(scored_rows)
                self._set_scores(scored, scores, range(k, k + len(scored)))
                q[scored_rows] = scores[1][:k]
            score_row = np.full(n, -1, np.int64)
            score_row[scored_rows] = np.arange(len(scored_rows))
            if cfg.amplicon_bias_filter_threshold is not None:
                from pisces_tpu_torch.ops.amplicon_bias import (
                    calculate_amplicon_bias,
                )
                for a in scored:
                    if a.category != AlleleCategory.SNV:
                        continue
                    ab = calculate_amplicon_bias(
                        getattr(a, "support_by_amplicon", None) or {},
                        source.get_amplicon_coverage(a.position),
                        cfg.amplicon_bias_filter_threshold,
                        cfg.max_variant_qscore)
                    if ab is not None:
                        a.amplicon_bias_detected = ab["bias_detected"]
                        a.amplicon_bias_results = ab["results"]

        with metrics.stage("allele_calling.filters"):
            for a in objects:
                self._apply_filters(a)
            # _is_callable on the rows; frequency is CalledAllele's f32
            with np.errstate(divide="ignore", invalid="ignore"):
                freq = np.minimum(sup.astype(np.float32)
                                  / cov.astype(np.float32), np.float32(1.0))
            called = (~((cov != 0) & (freq < np.float32(cfg.min_frequency)))
                      & (q >= cfg.min_variant_qscore))
            if not cfg.include_reference_calls:
                called &= cov >= cfg.min_coverage
            reported = called.copy()
            if self.interval_set is not None:
                for i in np.nonzero(called)[0]:
                    reported[i] = self.interval_set.contains(
                        int(rows.position[i]))
            forced = rows.rows_in((p, r, a) for c, p, r, a
                                  in self.forced_alleles
                                  if c == rows.chromosome)
            keep = reported | forced
            self.total_num_called += int(np.count_nonzero(called & ~keep))
            if snvs is not None:
                metrics.count("caller_rows_materialized", int(keep.sum()))
            alleles: List[CalledAllele] = []
            for i in np.nonzero(keep)[0]:
                a = map_candidate(rows.candidate(i))
                _set_point_coverage(a, cov_cols, i)
                if score_row[i] >= 0:
                    self._set_scores([a], scores, [int(score_row[i])])
                self._apply_filters(a)
                alleles.append(a)
        return alleles + objects

    def _coverage(self, source: AlleleSource,
                  alleles: List[CalledAllele]) -> None:
        point: List[CalledAllele] = []
        spanning: List[CalledAllele] = []
        for a in alleles:
            if a.category in _SPANNING:
                spanning.append(a)
            else:
                point.append(a)
        if point:
            self._batch_point_coverage(source, point)
        if not spanning:
            return
        cfg = self.config
        if (cfg.coverage_method == CoverageMethod.EXACT
                and self.read_summaries is not None):
            for a in spanning:
                self._exact_spanning_coverage(source, a)
            return
        cols = _spanning_coverage_columns(source, spanning,
                                          cfg.consider_anchor_information)
        metrics.count("caller_spanning_columnar", len(spanning))
        for i, a in enumerate(spanning):
            _set_spanning_coverage(a, cols, i)

    def _exact_spanning_coverage(self, source: AlleleSource,
                                 a: CalledAllele) -> None:
        from pisces_tpu_torch.ops.exact_coverage import exact_spanning_coverage
        length = (len(a.alt_allele) - 1
                  if a.category == AlleleCategory.INSERTION
                  else len(a.ref_allele) - 1
                  if a.category == AlleleCategory.DELETION
                  else len(a.alt_allele))
        cov_dir, total, ref_sup, sum_bq = exact_spanning_coverage(
            source, self.read_summaries, a.category, a.position, length,
            a.allele_support)
        a.total_coverage = total
        a.coverage_by_direction = cov_dir
        a.reference_support = ref_sup
        a.sum_of_base_quality = sum_bq

    def _batch_point_coverage(self, source: AlleleSource,
                              alleles: List[CalledAllele]) -> None:
        """Columnar CalculateSinglePoint (CoverageCalculator.cs:49-98) over a
        batch of SNV/reference alleles: one gather from the flat count
        tensors instead of 36 scalar lookups per allele."""
        from pisces_tpu_torch.domain.types import get_allele_type
        n = len(alleles)
        cols, held = _point_coverage(
            source, np.fromiter((a.position for a in alleles), np.int64, n),
            np.fromiter((int(get_allele_type(a.ref_allele[0]))
                         for a in alleles), np.int64, n),
            np.fromiter((a.category == AlleleCategory.SNV for a in alleles),
                        bool, n))
        for i, a in enumerate(alleles):
            _set_point_coverage(a, cols, i)
            if a.category == AlleleCategory.REFERENCE and held[i]:
                a.allele_support -= min(int(held[i]), a.allele_support)

    def _score_columns(self, sup, cov, sup_by_dir, cov_by_dir, ref_sup,
                       num_nc, sum_bq):
        """Q and strand bias of a batch given as columns (_allele_columns'
        order). Returns (per-row noise, or None for the flat level; q;
        the strand-bias dict)."""
        cfg = self.config
        n = len(sup)
        flat_noise = cfg.noise_level_used_for_q_scoring
        if cfg.noise_model == NoiseModel.WINDOW:
            noise = np.full(n, flat_noise, np.int64)
            for i in np.nonzero(cov > 0)[0]:
                noise[i] = int(stats.p_to_q(float(sum_bq[i]) / int(cov[i])))
            q = np.zeros(n, np.int64)
            for nz in np.unique(noise):
                m = noise == nz
                q[m] = stats.compute_variant_qscores(
                    sup[m], cov[m], cfg.max_variant_qscore, int(nz))
            per_allele_noise = noise
        else:
            per_allele_noise = None
            q = None  # computed below (host or device)

        # The Poisson q (regularized incomplete gamma — the FLOP-heavy part)
        # routes to the torch device for large batches; its integer output
        # is exact vs the f64 host path (grid-validated in
        # tests/test_torch_scoring.py). Strand bias stays on the host f64
        # path unconditionally: the GATK SB float is emitted verbatim in the
        # VCF and f32 gammainc drifts past 4 decimals in the -30..-80 dB
        # range, which would break byte parity.
        use_device = (cfg.device is not None
                      and n >= cfg.device_batch_threshold
                      and per_allele_noise is None)
        if q is None:
            if use_device:
                q = self._qscore_batch_device(sup_by_dir, cov_by_dir, cov,
                                              flat_noise, n, ref_sup, num_nc)
            else:
                q = stats.compute_variant_qscores(
                    sup, cov, cfg.max_variant_qscore, flat_noise)
        sb = stats.compute_strand_bias(
            sup_by_dir, cov_by_dir, flat_noise, cfg.min_frequency,
            cfg.strand_bias_filter_threshold, int(cfg.strand_bias_model))
        return per_allele_noise, q, sb

    def _set_scores(self, alleles: List[CalledAllele], scores, index) -> None:
        """Give each allele its row of _score_columns' output (`index`: the
        alleles' rows, in order)."""
        per_allele_noise, q, sb = scores
        flat_noise = self.config.noise_level_used_for_q_scoring
        bias_score = sb["bias_score"]
        gatk = sb["gatk_bias_score"]
        acceptable = sb["bias_acceptable"]
        var_both = sb["var_present_on_both_strands"]
        cov_both = sb["cov_present_on_both_strands"]
        need_detail = self.config.need_sb_detail
        for a, i in zip(alleles, index):
            a.noise_level_applied = (int(per_allele_noise[i])
                                     if per_allele_noise is not None
                                     else flat_noise)
            a.variant_qscore = int(q[i])
            a.strand_bias_score = float(bias_score[i])
            a.strand_bias_gatk = float(gatk[i])
            a.strand_bias_acceptable = bool(acceptable[i])
            a.var_present_on_both_strands = bool(var_both[i])
            a.cov_present_on_both_strands = bool(cov_both[i])
            if need_detail:
                a.sb_detail = _SbSliceView(sb, i)

    def _qscore_batch_device(self, sup_by_dir, cov_by_dir, cov, noise_level,
                             n, ref_support, num_no_calls):
        """Score a large candidate batch on the torch device
        (ops/torch_scoring.score_snv_loci); returns the integer q-scores
        (exact vs the host f64 path)."""
        from pisces_tpu_torch.ops.torch_scoring import (
            ScoringParams, score_snv_loci,
        )
        metrics.count("candidate_batches_on_device", 1)
        metrics.count("candidates_on_device", n)
        cfg = self.config
        params = ScoringParams(
            noise_level=noise_level,
            max_variant_qscore=cfg.max_variant_qscore,
            min_variant_qscore=cfg.min_variant_qscore,
            variant_qscore_filter=cfg.variant_qscore_filter_threshold or 0,
            min_frequency=cfg.min_frequency,
            min_frequency_filter=cfg.min_frequency_filter,
            target_lod=cfg.target_lod_frequency,
            min_depth=cfg.min_depth_to_genotype,
            low_depth_filter=cfg.low_depth_filter or 0,
            min_gq=cfg.min_gq_score, max_gq=cfg.max_gq_score,
            sb_acceptance=cfg.strand_bias_filter_threshold,
            no_call_filter=cfg.no_call_filter_threshold or 1.0)
        if cfg.mesh is not None:
            # shard the candidate batch over the mesh — the mesh analog of
            # per-candidate scoring inside each (bam, chr) job
            from pisces_tpu_torch.parallel.sharding import (
                sharded_score_snv_tuples,
            )
            out = sharded_score_snv_tuples(
                sup_by_dir, cov_by_dir, ref_support, num_no_calls, cov,
                params, cfg.mesh)
            return out["variant_qscore"].astype(np.int64)

        def dev(x):
            return torch.from_numpy(
                np.ascontiguousarray(x, dtype=np.int32)).to(cfg.device)

        with metrics.stage("card_round_trip"):
            out = score_snv_loci(dev(sup_by_dir), dev(cov_by_dir),
                                 dev(ref_support), dev(num_no_calls),
                                 dev(cov), params)
            q = out["variant_qscore"].cpu().numpy()
        return q.astype(np.int64)

    def _apply_filters(self, a: CalledAllele) -> None:
        """AlleleProcessor.Process/ApplyFilters (AlleleProcessor.cs:16-71)."""
        cfg = self.config
        a.set_fraction_no_calls()
        a.filters = []
        if cfg.low_depth_filter is not None and a.total_coverage < cfg.low_depth_filter:
            a.add_filter(FilterType.LOW_DEPTH)
        if (cfg.variant_qscore_filter_threshold is not None
                and a.variant_qscore < cfg.variant_qscore_filter_threshold
                and a.total_coverage != 0):
            a.add_filter(FilterType.LOW_VARIANT_QSCORE)
        if a.category != AlleleCategory.REFERENCE:
            if (cfg.no_call_filter_threshold is not None
                    and a.fraction_no_calls > cfg.no_call_filter_threshold):
                a.add_filter(FilterType.NO_CALL)
            if (not a.strand_bias_acceptable
                    or (cfg.filter_single_strand_variants
                        and not a.var_present_on_both_strands)):
                a.add_filter(FilterType.STRAND_BIAS)
            if (a.amplicon_bias_detected
                    and cfg.amplicon_bias_filter_threshold is not None):
                a.add_filter(FilterType.AMPLICON_BIAS)
            if cfg.indel_repeat_filter is not None and cfg.indel_repeat_filter > 0:
                rep = compute_indel_repeat_length(a.category, a.position,
                                                  a.ref_allele, a.alt_allele,
                                                  self.refseq)
                if cfg.indel_repeat_filter <= rep:
                    a.add_filter(FilterType.INDEL_REPEAT_LENGTH)
            if rmxn_should_filter(a.category, a.position, a.ref_allele, a.alt_allele,
                                  a.frequency, self.refseq_str,
                                  cfg.rmxn_max_length_repeat,
                                  cfg.rmxn_min_repetitions,
                                  cfg.rmxn_frequency_limit):
                a.add_filter(FilterType.RMXN)
            if (cfg.variant_freq_filter is not None
                    and np.float32(a.frequency) < np.float32(cfg.variant_freq_filter)):
                a.add_filter(FilterType.LOW_VARIANT_FREQUENCY)
            if cfg.expect_stitched_source and "N" in a.alt_allele:
                a.add_filter(FilterType.STRAND_BIAS)

    # -- callability (AlleleCaller.cs:236-258) -------------------------------

    def _is_callable(self, a: CalledAllele) -> bool:
        cfg = self.config
        if a.category == AlleleCategory.REFERENCE:
            self.total_num_called += 1
            return True
        if a.total_coverage < cfg.min_coverage and not cfg.include_reference_calls:
            return False
        if (a.total_coverage != 0
                and np.float32(a.frequency) < np.float32(cfg.min_frequency)):
            return False
        if a.variant_qscore < cfg.min_variant_qscore:
            return False
        self.total_num_called += 1
        return True

    def _should_report(self, a: CalledAllele) -> bool:
        if self.interval_set is None:
            return True
        return self.interval_set.contains(a.position)

    def _is_forced(self, a: CalledAllele) -> bool:
        return (a.chromosome, a.position, a.ref_allele, a.alt_allele) in self.forced_alleles

    # -- genotyping (somatic; diploid/haploid/adaptive in genotype/) ---------

    def _set_genotypes(self, alleles: List[CalledAllele]) -> List[CalledAllele]:
        from pisces_tpu_torch.genotype import create_genotype_calculator
        calc = create_genotype_calculator(self.config, alleles[0].chromosome
                                          if alleles else None,
                                          is_male=self.config.is_male)
        return calc.set_genotypes(alleles)

    # -- main entry -----------------------------------------------------------

    def call(self, candidates: List[Candidate], source: AlleleSource,
             snvs: Optional[SnvCandidateBatch] = None
             ) -> Dict[int, List[CalledAllele]]:
        """CallForPositions: returns {position: [alleles sorted by ref,alt]}.

        `snvs` holds more SNV candidates as columns; in the reference's
        order they come before `candidates` (the native flow passes its
        SNVs so, and its indels, forced and reference candidates as
        objects). Only the rows reported or forced become CalledAlleles,
        unless a step reads every SNV allele: MNVs do (failed ones are
        reallocated into SNV alleles, called ones take reference support),
        and so does amplicon bias (each SNV's support by amplicon). Then
        the rows join `candidates` as objects."""
        cfg = self.config
        if snvs is not None and (
                cfg.amplicon_bias_filter_threshold is not None
                or any(c.category == AlleleCategory.MNV for c in candidates)):
            candidates = snvs.to_candidates() + list(candidates)
            snvs = None
        # five steps, each a stage, that together tile the call: prepare,
        # coverage, scoring and filters (_process), the callable/report/
        # forced pass (filters again) and genotype
        callable_alleles = self._process(snvs, candidates, source)

        by_position: Dict[int, List[CalledAllele]] = {}
        with metrics.stage("allele_calling.filters"):
            for a in callable_alleles:
                if self._is_forced(a) and not (self._is_callable(a)
                                               and self._should_report(a)):
                    a.is_forced_to_report = True
                    a.add_filter(FilterType.FORCED_REPORT)
                if ((self._is_callable(a) and self._should_report(a))
                        or self._is_forced(a)):
                    by_position.setdefault(a.position, []).append(a)

        with metrics.stage("allele_calling.genotype"):
            # somatic GT/GQ is elementwise per allele (SomaticGenotyper
            # never prunes and has no cross-allele state), so one batched
            # numpy pass over every locus replaces 1-allele-per-call
            # dispatch; diploid models keep the per-locus path
            # (multi-allelic pruning is locus-coupled)
            batched_gt = (cfg.ploidy_model == PloidyModel.SOMATIC
                          and bool(by_position))
            if batched_gt:
                flat = [a for pos in by_position for a in by_position[pos]
                        if not a.is_forced_to_report]
                if flat:
                    self._set_genotypes(flat)
            for pos in by_position:
                alleles_at_pos = by_position[pos]
                self._compute_genotype_and_filter(alleles_at_pos,
                                                  gt_precomputed=batched_gt)
                self._locus_process(alleles_at_pos)

            return dict(sorted(by_position.items()))

    def _process(self, snvs: Optional[SnvCandidateBatch],
                 candidates: List[Candidate],
                 source: AlleleSource) -> List[CalledAllele]:
        """Steps prepare, coverage, scoring and filters on the SNV rows
        (None: none) and the candidates. Prepare collapses them, maps the
        candidates to alleles, scores the MNVs (_score_and_filter) to
        reallocate those not callable, and counts the reference support
        that the gapped MNVs hold; the rows and the alleles left then go
        through _score_and_filter together."""
        with metrics.stage("allele_calling.prepare"):
            if self.collapser is not None:
                snvs, candidates = self._collapse(snvs, candidates, source)
            if snvs is not None:
                metrics.count("caller_rows_columnar", len(snvs))
            objects = [map_candidate(cand) for cand in candidates]
            mnvs = [a for a in objects if a.category == AlleleCategory.MNV]
        self._score_and_filter(source, mnvs)
        with metrics.stage("allele_calling.prepare"):
            callable_alleles: List[CalledAllele] = []
            failed_mnvs: List[CalledAllele] = []
            for a in objects:
                if a.category != AlleleCategory.MNV or self._is_callable(a):
                    callable_alleles.append(a)
                else:
                    failed_mnvs.append(a)
            reallocate_failed_mnvs(failed_mnvs, callable_alleles)
            source.add_gapped_mnv_ref_counts(
                get_ref_support_from_gapped_mnvs(callable_alleles))
            callable_alleles += [a for a in failed_mnvs if self._is_forced(a)]
        return self._score_and_filter(source, callable_alleles, snvs)

    def _collapse(self, snvs: Optional[SnvCandidateBatch],
                  candidates: List[Candidate], source: AlleleSource):
        """VariantCollapser.collapse over the rows (None: none) and the
        objects. With no MNV present (call hands MNVs the rows as objects)
        an open-ended SNV merges only into an SNV at its own position, and
        indels only into indels (collapser._can_collapse): so only the rows
        at positions that hold an open-ended row become Candidates. Their
        merged supports go back into the columns, and the rows merged away
        drop out."""
        if snvs is None:
            return None, self.collapser.collapse(list(candidates), source)
        open_rows = snvs.open_on_left | snvs.open_on_right
        rows = np.nonzero(np.isin(snvs.position, snvs.position[open_rows]))[0]
        objs = [snvs.candidate(i) for i in rows]
        kept = self.collapser.collapse(objs + list(candidates), source)
        row_of = {id(c): i for c, i in zip(objs, rows)}
        keep = np.ones(len(snvs), dtype=bool)
        keep[rows] = False
        sup = snvs.support_by_direction.copy()
        wa = snvs.well_anchored_by_direction.copy()
        rest: List[Candidate] = []
        for c in kept:
            i = row_of.get(id(c))
            if i is None:
                rest.append(c)
                continue
            keep[i] = True
            sup[i] = c.support_by_direction
            wa[i] = c.well_anchored_by_direction
        merged = dataclasses.replace(snvs, support_by_direction=sup,
                                     well_anchored_by_direction=wa)
        return merged.take(keep), rest

    def _compute_genotype_and_filter(self, alleles: List[CalledAllele],
                                     gt_precomputed: bool = False) -> None:
        """ComputeGenotypeAndFilterAllele (AlleleCaller.cs:143-180)."""
        if any(a.category != AlleleCategory.REFERENCE and not a.is_forced_to_report
               for a in alleles):
            # the locus's reference allele is suppressed even if genotyping
            # later prunes every variant here (diploid sub-threshold case):
            # record it so the fast-gVCF splice drops the ref line too
            if alleles:
                self.ref_suppressed_positions.add(alleles[0].position)
            alleles[:] = [a for a in alleles if a.category != AlleleCategory.REFERENCE]

        if not gt_precomputed:
            to_prune = self._set_genotypes(
                [a for a in alleles if not a.is_forced_to_report])
            for p in to_prune:
                key = (p.chromosome, p.position, p.ref_allele, p.alt_allele)
                if key not in self.forced_alleles:
                    alleles.remove(p)

        if self.config.low_gtq_filter is not None:
            for a in alleles:
                if a.genotype_qscore < self.config.low_gtq_filter:
                    a.add_filter(FilterType.LOW_GENOTYPE_QUALITY)

        alleles.sort(key=lambda a: (a.ref_allele, a.alt_allele))

    def _locus_process(self, alleles: List[CalledAllele]) -> None:
        """Somatic locus processor is a no-op; diploid handles forced alleles
        (DiploidLocusProcessor.cs:539-577)."""
        if self.config.ploidy_model != PloidyModel.DIPLOID_BY_THRESHOLDING:
            return
        forced = [a for a in alleles if FilterType.FORCED_REPORT in a.filters]
        non_forced = [a for a in alleles if FilterType.FORCED_REPORT not in a.filters]
        if not forced:
            return
        is_ref = any(a.is_ref_type for a in non_forced)
        is_nocall = (not non_forced) or any(a.is_nocall for a in non_forced)
        gt = (Genotype.ALT_LIKE_NOCALL if is_nocall
              else (Genotype.HOMOZYGOUS_REF if is_ref else Genotype.OTHERS))
        for a in forced:
            a.genotype = gt
        min_gq = 0 if not non_forced else min(a.genotype_qscore for a in non_forced)
        for a in alleles:
            a.genotype_qscore = min_gq


def _point_coverage_columns(source: AlleleSource, pos: np.ndarray,
                            ref_types: np.ndarray):
    """CalculateSinglePoint as columns: (coverage by direction [n, 3],
    total coverage, no-calls, sum of base qualities, reference support
    before the gapped-MNV adjustment) at 1-based `pos`, `ref_types` being
    each position's reference AlleleType code."""
    from pisces_tpu_torch.domain.types import COVERAGE_CONTRIBUTING_ALLELES
    cov_alleles = np.array([int(x) for x in COVERAGE_CONTRIBUTING_ALLELES])
    n = len(pos)
    c, qv = source.flat_columns(pos)
    cov_by_dir = c[:, cov_alleles, :].sum(axis=1)   # [n, 3]
    total = cov_by_dir.sum(axis=1)
    # base-quality sums folded in the reference's accumulation order
    # (direction-major, then allele) so f64 rounding matches the scalar
    # path bit for bit (WINDOW noise model consumes this)
    qflat = qv[:, cov_alleles, :].transpose(0, 2, 1).reshape(
        n, len(cov_alleles) * NUM_DIRECTION_TYPES)
    sum_bq = np.zeros(n, np.float64)
    for j in range(qflat.shape[1]):
        sum_bq += qflat[:, j]
    num_nc = c[:, int(AlleleType.N), :].sum(axis=1)
    ref_sup = c[np.arange(n), ref_types, :].sum(axis=1)
    return cov_by_dir, total, num_nc, sum_bq, ref_sup


def _point_coverage(source: AlleleSource, pos: np.ndarray,
                    ref_types: np.ndarray, snv):
    """_point_coverage_columns with the reference support that gapped MNVs
    hold at each position (source.gapped_mnv_ref_counts) taken off that of
    the SNVs (`snv`: a row mask, or True for all), floored at 0. Returns
    the columns and that support, which a reference allele at the position
    gives up from its own."""
    cov_by_dir, total, num_nc, sum_bq, ref_sup = _point_coverage_columns(
        source, pos, ref_types)
    gapped = source.gapped_mnv_ref_counts
    held = np.zeros(len(pos), np.int64)
    if gapped:
        held = np.fromiter((gapped.get(int(p), 0) for p in pos), np.int64,
                           len(pos))
        ref_sup = np.where(snv, np.maximum(0, ref_sup - held), ref_sup)
    return (cov_by_dir, total, num_nc, sum_bq, ref_sup), held


def _set_point_coverage(a: CalledAllele, cols, i: int) -> None:
    """An allele's point coverage from row i of _point_coverage's
    columns."""
    cov_by_dir, total, num_nc, sum_bq, ref_sup = cols
    t = int(total[i])
    a.total_coverage = t
    a.coverage_by_direction = cov_by_dir[i].astype(np.int64)
    a.num_no_calls = int(num_nc[i])
    a.sum_of_base_quality = float(sum_bq[i])
    a.confident_coverage_start = t
    a.confident_coverage_end = t
    a.reference_support = int(ref_sup[i])


def _spanning_coverage_columns(source: AlleleSource,
                               alleles: List[CalledAllele],
                               consider_anchor_information: bool):
    """spanning_coverage_columns over spanning alleles."""
    n = len(alleles)
    n_type = int(AlleleType.N)

    def col(values):
        return np.fromiter(values, np.int64, n)

    def inserted(j):
        return col(int(BASE_TO_ALLELE[ord(a.alt_allele[j])])
                   if a.category == AlleleCategory.INSERTION else n_type
                   for a in alleles)

    return spanning_coverage_columns(
        source, col(int(a.category) for a in alleles),
        col(a.position for a in alleles),
        col(len(a.ref_allele) for a in alleles),
        col(len(a.alt_allele) for a in alleles), inserted(1), inserted(-1),
        col(a.allele_support for a in alleles),
        col(a.well_anchored_support for a in alleles),
        consider_anchor_information)


def _set_spanning_coverage(a: CalledAllele, cols: SpanningColumns,
                           i: int) -> None:
    """An allele's spanning coverage from row i of
    spanning_coverage_columns."""
    a.total_coverage = int(cols.total_coverage[i])
    a.coverage_by_direction = cols.coverage_by_direction[i].copy()
    a.reference_support = int(cols.reference_support[i])
    a.num_no_calls = int(cols.num_no_calls[i])
    a.sum_of_base_quality = float(cols.sum_of_base_quality[i])
    a.confident_coverage_start = int(cols.confident_coverage_start[i])
    a.confident_coverage_end = int(cols.confident_coverage_end[i])
    a.suspicious_coverage_start = int(cols.suspicious_coverage_start[i])
    a.suspicious_coverage_end = int(cols.suspicious_coverage_end[i])
    a.unanchored_coverage_weight = float(
        cols.unanchored_coverage_weight[i])


def _allele_columns(alleles: List[CalledAllele]):
    """The columns _score_columns takes, from alleles: support, coverage,
    support and coverage by direction, reference support, no-calls, sum
    of base qualities."""
    n = len(alleles)

    def by_dir(attr):
        if not n:
            return np.zeros((0, NUM_DIRECTION_TYPES), np.int64)
        return np.stack([getattr(a, attr) for a in alleles]).astype(np.int64)

    return (np.fromiter((a.allele_support for a in alleles), np.int64, n),
            np.fromiter((a.total_coverage for a in alleles), np.int64, n),
            by_dir("support_by_direction"), by_dir("coverage_by_direction"),
            np.fromiter((a.reference_support for a in alleles), np.int64, n),
            np.fromiter((a.num_no_calls for a in alleles), np.int64, n),
            np.fromiter((a.sum_of_base_quality for a in alleles),
                        np.float64, n))


def _no_snvs() -> SnvCandidateBatch:
    """A batch of no SNV rows."""
    pos = np.zeros(0, np.int64)
    base = np.zeros(0, np.uint8)
    sup = np.zeros((0, NUM_DIRECTION_TYPES), np.int64)
    flag = np.zeros(0, bool)
    return SnvCandidateBatch("", pos, base, base, sup, sup, flag, flag)


def make_reference_candidates(chrom: str, refseq: np.ndarray, pc: PileupCounts,
                              intervals=None) -> List[Candidate]:
    """gVCF reference-allele synthesis from count tensors
    (RegionState.GetAllCandidates, cs:383-460), vectorized per block."""
    from pisces_tpu_torch.domain.types import BASE_TO_ALLELE
    out: List[Candidate] = []
    nb = len(pc.block_keys)
    if nb == 0:
        return out
    counts_t = pc.counts_t               # [NB, B, 6, 3]
    total_support = counts_t.sum(axis=(2, 3))  # [NB, B]
    for bi in range(nb):
        key = int(pc.block_keys[bi])
        start = (key - 1) * pc.block_size + 1
        end = key * pc.block_size
        if intervals is not None:
            ranges = intervals.clipped_ranges(start, end)
        else:
            ranges = [(start, end)]
        for (rs, re_) in ranges:
            positions = np.arange(rs, re_ + 1, dtype=np.int64)
            positions = positions[positions <= len(refseq)]
            if len(positions) == 0:
                continue
            in_block = positions - start
            ref_bytes = refseq[positions - 1]
            ref_codes = BASE_TO_ALLELE[ref_bytes]
            sup = total_support[bi, in_block]
            if intervals is None:
                sel = sup > 0
            else:
                sel = np.ones(len(positions), dtype=bool)
            for pos, code, rb, ib in zip(positions[sel], ref_codes[sel],
                                         ref_bytes[sel], in_block[sel]):
                c = Candidate(chrom, int(pos), chr(rb), chr(rb),
                              AlleleCategory.REFERENCE)
                c.support_by_direction = counts_t[bi, ib, code, :].astype(np.int64)
                out.append(c)
    return out
