"""Scylla: MNV phasing application.

Port of exe/Scylla + VariantPhasing/Logic: takes a Pisces (g)VCF + BAM,
builds neighborhoods of proximal passing variants (<=50bp), compresses reads
to veads, clusters them, extracts phased MNVs from cluster consensus
(PhasedVariantExtractor), rescores via the shared Poisson q-score machinery,
and merges phased calls back into the VCF stream (VcfMerger).
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import AlleleCategory, FilterType, Genotype
from pisces_tpu_torch.calling.alleles import CalledAllele
from pisces_tpu_torch.ops import stats
from pisces_tpu_torch.io.bam import CIGAR_OPS
from pisces_tpu_torch.io.vcf_read import (
    VcfVariant, iter_colocated, read_header_and_variants, to_called_alleles,
)
from pisces_tpu_torch.phasing.clustering import (
    Cluster, ClusteringParameters, NeighborhoodClusterer, SetOfClusters,
)
from pisces_tpu_torch.phasing.models import (
    Vead, VeadFinder, VeadGroup, VariantSite, depth_at_sites,
)
from pisces_tpu_torch.utils.logger import log

ALLELE_CHARS = np.frombuffer(b"AGCTN-", dtype=np.uint8)


@dataclass
class PhasableVariantCriteria:
    passing_variants_only: bool = True
    het_variants_only: bool = False
    phasing_distance: int = 50
    chrs_to_process: tuple = ()
    min_passing_variants_in_nbhd: int = 0
    # debugging restrictions (PhasingOptions.cs:9-10)
    filtered_nbhd_to_process: Optional[str] = None
    max_num_nbhds_to_process: int = -1


@dataclass
class Neighborhood:
    """VcfNeighborhood + CallableNeighborhood."""

    chrom: str
    sites: List[VariantSite]
    id: str = ""
    reference_substring: str = ""
    first_position_of_interest: int = 0
    last_position_in_vcf: int = 0
    last_position_with_lookahead: int = 0
    accepted: List[CalledAllele] = field(default_factory=list)
    rejected: List[CalledAllele] = field(default_factory=list)
    used_ref_counts: Dict[int, Tuple[int, CalledAllele]] = field(default_factory=dict)
    called_variants: Dict[int, List[CalledAllele]] = field(default_factory=dict)
    called_refs: Dict[int, CalledAllele] = field(default_factory=dict)
    # soft-clip rescue window (VcfNeighborhood.cs:26-27,119-131)
    soft_clip_end_before: int = -1
    soft_clip_pos_after: int = -1
    number_clipped_reads: int = 0

    def set_range_of_interest(self, refseq: Optional[np.ndarray]) -> None:
        self.sites.sort(key=lambda s: s.true_first_base_of_diff)
        self.first_position_of_interest = self.sites[0].position
        self.last_position_in_vcf = self.sites[-1].position
        look = self.sites[0].position
        for vs in self.sites:
            la = vs.position + max(len(vs.alt), len(vs.ref))
            look = max(look, la)
        self.last_position_with_lookahead = look
        # If the first variant is an indel, soft-clipped reads end exactly on
        # its vcf position; for an SNV they end one base before it
        # (VcfNeighborhood.SetRangeOfInterest, VcfNeighborhood.cs:119-131).
        first = self.sites[0]
        if len(first.ref) != len(first.alt):
            self.soft_clip_end_before = first.position
        else:
            self.soft_clip_end_before = first.position - 1
        last = self.sites[-1]
        self.soft_clip_pos_after = last.position + len(last.ref)
        n = self.last_position_with_lookahead - self.first_position_of_interest
        if refseq is None:
            self.reference_substring = "R" * n
        else:
            s = self.first_position_of_interest - 1
            self.reference_substring = refseq[s:s + n].tobytes().decode()

    def original_vcf_variants(self) -> List[CalledAllele]:
        return [s.original_allele for s in self.sites if s.original_allele]


def build_neighborhoods(alleles_stream, criteria: PhasableVariantCriteria
                        ) -> List[Neighborhood]:
    """NeighborhoodBuilder over an iterator of CalledAllele (vcf order)."""
    neighborhoods: List[Neighborhood] = []
    last_site: Optional[VariantSite] = None
    nbhd_count = 0

    def eligible(a: CalledAllele) -> bool:
        if criteria.chrs_to_process and a.chromosome not in criteria.chrs_to_process:
            return False
        if a.is_ref_type or a.is_nocall:
            return False
        if a.category == AlleleCategory.UNSUPPORTED:
            return False
        if criteria.het_variants_only and a.genotype == Genotype.HOMOZYGOUS_ALT:
            return False
        if not criteria.passing_variants_only:
            return True
        return len(a.filters) == 0

    for allele in alleles_stream:
        if FilterType.FORCED_REPORT in allele.filters:
            continue
        site = VariantSite(allele.position, allele.ref_allele,
                           allele.alt_allele, allele.chromosome, allele,
                           is_passing=len(allele.filters) == 0)
        if not eligible(allele):
            # reference/filtered rows never become the chain cursor
            # (NeighborhoodBuilder.cs:85-97: _lastVariantSite only advances
            # on eligible variants, so gVCF ref rows don't break chains)
            continue
        if (last_site is not None and last_site.chrom == site.chrom
                and abs(site.position - last_site.position) < criteria.phasing_distance
                and last_site.original_allele is not None):
            if (neighborhoods
                    and neighborhoods[-1].chrom == site.chrom
                    and neighborhoods[-1].sites[-1].position == last_site.position):
                neighborhoods[-1].sites.append(site)
            else:
                nbhd_count += 1
                nb = Neighborhood(site.chrom, [last_site, site],
                                  id=f"NbhdNum{nbhd_count - 1}_{site.chrom}_"
                                     f"{last_site.position}")
                neighborhoods.append(nb)
        last_site = site

    if criteria.min_passing_variants_in_nbhd > 0:
        # skip under-supported neighborhoods unless they consist only of
        # passing variants (NeighborhoodBuilder
        # .ConvertToCallableNeighborhoods, cs:125-132)
        kept = []
        for nb in neighborhoods:
            n_pass = sum(1 for s in nb.sites if s.is_passing)
            if (n_pass < criteria.min_passing_variants_in_nbhd
                    and len(nb.sites) - n_pass > 0):
                continue
            kept.append(nb)
        neighborhoods = kept

    return neighborhoods


# ---------------------------------------------------------------------------
# Phased variant extraction (PhasedVariantExtractor)
# ---------------------------------------------------------------------------

def _num_trailing_agreement(ref: str, alt: str) -> int:
    n = 0
    while (n < len(ref) and n < len(alt)
           and ref[len(ref) - 1 - n] == alt[len(alt) - 1 - n]):
        n += 1
    return n


def _num_preceding_agreement(ref: str, alt: str) -> int:
    n = 0
    while n < len(ref) and n < len(alt) and ref[n] == alt[n]:
        n += 1
    return n


def create_allele(chrom: str, pos: int, ref: str, alt: str, var_count: int,
                  nocall_count: int, total_coverage: int, ref_support: int,
                  category: AlleleCategory, noise_level: int,
                  max_q: int) -> CalledAllele:
    """PhasedVariantExtractor.Create."""
    if total_coverage < var_count:
        total_coverage = var_count
    if category == AlleleCategory.REFERENCE:
        ref_support = var_count
    a = CalledAllele(chrom, pos, ref, alt, category)
    a.total_coverage = total_coverage
    a.allele_support = var_count
    a.reference_support = ref_support
    a.num_no_calls = nocall_count
    a.variant_qscore = int(stats.assign_poisson_qscore(
        np.array([var_count]), np.array([total_coverage]), noise_level, max_q)[0])
    a.noise_level_applied = noise_level
    a.genotype = (Genotype.HOMOZYGOUS_REF if category == AlleleCategory.REFERENCE
                  else Genotype.HETEROZYGOUS_ALT_REF)
    a.set_fraction_no_calls()
    return a


def extract_phased_allele(cluster_sites: List[VariantSite], reference: str,
                          depths: np.ndarray, nocalls: np.ndarray,
                          cluster_ref_support: int, counts: np.ndarray,
                          chrom: str, noise_level: int, max_q: int,
                          anchor_position: int = -1
                          ) -> Tuple[CalledAllele, Dict[int, int]]:
    """PhasedVariantExtractor.Extract."""
    reference_removal: Dict[int, int] = {}
    allele_ref = ""
    allele_alt = ""
    sucked_up: List[int] = []
    depths_in, counts_in, nocalls_in = [], [], []

    last_ref_base = cluster_sites[0].position
    first_variant_pos = cluster_sites[0].position
    started = False
    using_anchor = anchor_position != -1
    if using_anchor:
        last_ref_base = anchor_position - 1

    for i, site in enumerate(cluster_sites):
        ref_add = site.true_ref
        alt_add = site.true_alt
        cur = site.true_first_base_of_diff
        diff = last_ref_base - cur
        if ref_add == alt_add:
            continue
        if started and diff >= 0:
            trim = diff + 1
            if trim < len(site.true_alt) and trim < len(site.true_ref):
                ref_add = site.true_ref[trim:]
                alt_add = site.true_alt[trim:]
                cur = site.true_first_base_of_diff + trim
            else:
                continue
        if started or using_anchor:
            gap = cur - last_ref_base - 1
            gap_positions = [last_ref_base + k + 1 for k in range(gap)]
            sucked_up.extend(gap_positions)
            filler = ""
            for p in gap_positions:
                idx = p - cluster_sites[0].position
                if len(reference) == 0:
                    filler += "R"
                elif 0 <= idx < len(reference):
                    filler += reference[idx]
                else:
                    filler += "R"
            allele_ref += filler
            allele_alt += filler
        if not started:
            first_variant_pos = cur
        started = True
        depths_in.append(int(depths[i]))
        counts_in.append(int(counts[i]))
        nocalls_in.append(int(nocalls[i]))
        last_ref_base = cur + len(ref_add) - 1
        allele_ref += ref_add
        allele_alt += alt_add

    if started:
        t = _num_trailing_agreement(allele_ref, allele_alt)
        allele_ref = allele_ref[:len(allele_ref) - t]
        allele_alt = allele_alt[:len(allele_alt) - t]
    pre = 0 if using_anchor else _num_preceding_agreement(allele_ref, allele_alt)
    allele_ref = allele_ref[pre:]
    allele_alt = allele_alt[pre:]

    if not started or (len(allele_ref) == 0 and len(allele_alt) == 0):
        allele = create_allele(chrom, -1, allele_ref, allele_alt, 0, 0, 0,
                               cluster_ref_support, AlleleCategory.REFERENCE,
                               noise_level, max_q)
        return allele, reference_removal

    total_coverage = int(np.mean(depths_in)) if depths_in else 0
    var_count = int(np.mean(counts_in)) if counts_in else 0
    nocall_count = int(np.mean(nocalls_in)) if nocalls_in else 0

    true_start = anchor_position if using_anchor else first_variant_pos + pre
    idx_ref = (true_start - 1) - cluster_sites[0].position
    prepend = "R"
    if 0 <= idx_ref < len(reference):
        prepend = reference[idx_ref]

    if len(allele_ref) == 0 and len(allele_alt) != 0:
        allele = create_allele(chrom, true_start - 1, prepend + allele_ref,
                               prepend + allele_alt, var_count, nocall_count,
                               total_coverage, cluster_ref_support,
                               AlleleCategory.INSERTION, noise_level, max_q)
    elif len(allele_ref) != 0 and len(allele_alt) == 0:
        allele = create_allele(chrom, true_start - 1, prepend + allele_ref,
                               prepend + allele_alt, var_count, nocall_count,
                               total_coverage, cluster_ref_support,
                               AlleleCategory.DELETION, noise_level, max_q)
    else:
        allele = create_allele(chrom, true_start, allele_ref, allele_alt,
                               var_count, nocall_count, total_coverage,
                               cluster_ref_support, AlleleCategory.MNV,
                               noise_level, max_q)
    if var_count == 0:
        allele = create_allele(chrom, true_start, allele_ref, ".", var_count,
                               nocall_count, total_coverage, cluster_ref_support,
                               AlleleCategory.REFERENCE, noise_level, max_q)
    for p in sucked_up:
        if using_anchor or p > true_start:
            reference_removal[p] = var_count
    return allele, reference_removal


def combine_phased_variants(a1: CalledAllele, a2: CalledAllele,
                            max_q: int) -> CalledAllele:
    return create_allele(a1.chromosome, a1.position, a1.ref_allele, a1.alt_allele,
                         a1.allele_support + a2.allele_support,
                         (a1.num_no_calls + a2.num_no_calls) // 2,
                         (a1.total_coverage + a2.total_coverage) // 2,
                         (a1.reference_support + a2.reference_support) // 2,
                         a1.category, a1.noise_level_applied, max_q)


# ---------------------------------------------------------------------------
# The per-neighborhood pipeline
# ---------------------------------------------------------------------------

class ScyllaOptions:
    def __init__(self):
        self.min_base_call_quality = 20
        self.min_map_quality = 1
        self.min_number_variants_in_read = 1
        self.remove_duplicates = True
        self.only_use_proper_pairs = False
        self.max_q = 100
        self.min_variant_qscore = 20
        self.min_variant_qscore_filter = 30
        self.min_frequency = 0.01
        self.min_frequency_filter = 0.01
        self.low_depth_filter = 10
        self.min_coverage = 10
        self.target_lod = 0.01
        # ploidy (ScyllaApplicationOptions.cs:43-47 forces MinimumFrequency
        # to the diploid SNV MinorVF in diploid-by-thresholding mode;
        # CallableNeighborhood.cs:83-89 builds the nbhd GT calculator)
        from pisces_tpu_torch.domain.types import PloidyModel
        from pisces_tpu_torch.options import (DiploidThresholdingParameters,
                                        AdaptiveGenotypingParameters)
        self.ploidy_model = PloidyModel.SOMATIC
        self.diploid_snv_parameters = DiploidThresholdingParameters()
        self.diploid_indel_parameters = DiploidThresholdingParameters()
        self.adaptive_genotyping_parameters = AdaptiveGenotypingParameters()
        self.min_gq = 0
        self.max_gq = 100
        self.clustering = ClusteringParameters()
        self.phasable = PhasableVariantCriteria()
        self.crush_nbhd = False
        # SoftClipSupportParameters (PhasingOptions.cs:26-29)
        self.use_soft_clipped_reads = False
        self.min_size_for_clip_rescue = 6
        # neighborhood task parallelism (VariantPhaser.cs:44-100 batches
        # neighborhoods through JobManager with -MaxNumThreads)
        self.max_num_threads = 1
        self.no_call_filter_threshold = 0.6  # -ncfilter
        # VcfWriting group (shared with Pisces, ScyllaOptionsParser.cs:154):
        # NC and US columns on rewritten lines (ExecutionTests.cs
        # TestWithNCandUSData passes -reportnocalls/-reportrccounts/
        # -reporttscounts)
        self.report_no_calls = False
        self.report_rc_counts = False
        self.report_ts_counts = False


def collect_vead_groups(nbhd: Neighborhood, batch, keep: np.ndarray,
                        options: ScyllaOptions) -> List[VeadGroup]:
    """VeadGroupSource.GetVeadGroups."""
    finder = VeadFinder(options.min_base_call_quality,
                        options.min_number_variants_in_read)
    groups: Dict[tuple, VeadGroup] = {}
    pos1 = batch.pos.astype(np.int64) + 1
    end1 = batch.end_pos.astype(np.int64) + 1
    nbhd.number_clipped_reads = _count_clipped_in_neighborhood(
        nbhd, batch, pos1, end1)
    in_range = (keep & (end1 >= nbhd.first_position_of_interest)
                & (pos1 <= nbhd.last_position_with_lookahead))
    for i in np.nonzero(in_range)[0]:
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        qs, qe = batch.seq_off[i], batch.seq_off[i + 1]
        seq_chars = ALLELE_CHARS[batch.seq[qs:qe]].tobytes().decode()
        results = finder.find_variant_results(
            nbhd.sites, int(pos1[i]), batch.cigar_ops[s:e],
            batch.cigar_lens[s:e], seq_chars, batch.qual[qs:qe])
        if results is None:
            continue
        vead = Vead(f"r{i}", results)
        key = vead.key()
        if key in groups:
            groups[key].add_support()
        else:
            groups[key] = VeadGroup(vead)
    return list(groups.values())


_SOFTCLIP_OP = CIGAR_OPS.index("S")


def _clip_flags(batch):
    """Per-read (starts_with_softclip, ends_with_softclip, prefix_len,
    suffix_len) from the columnar CIGAR arrays (Read.StartsWithSoftClip /
    EndsWithSoftClip, Pisces.Domain/Models/Read.cs:139-140)."""
    off = batch.cigar_off
    n = len(off) - 1
    has = off[1:] > off[:-1]
    first_idx = np.where(has, off[:-1], 0)
    last_idx = np.where(has, off[1:] - 1, 0)
    starts = has & (batch.cigar_ops[first_idx] == _SOFTCLIP_OP)
    ends = has & (batch.cigar_ops[last_idx] == _SOFTCLIP_OP)
    prefix_len = np.where(starts, batch.cigar_lens[first_idx], 0)
    suffix_len = np.where(ends, batch.cigar_lens[last_idx], 0)
    return starts, ends, prefix_len.astype(np.int64), suffix_len.astype(np.int64)


def _count_clipped_in_neighborhood(nbhd: Neighborhood, batch, pos1, end1) -> int:
    """NeighborhoodReadFilter.IsClippedWithinNeighborhood counting
    (VeadGroupSource.cs:56-59): a read whose clip boundary (the alignment
    start for a leading clip, the alignment end for a trailing clip) falls
    inside [SoftClipEndBeforeNbhd, SoftClipPosAfterNbhd]."""
    starts, ends, _, _ = _clip_flags(batch)
    lo, hi = nbhd.soft_clip_end_before, nbhd.soft_clip_pos_after
    prefix_in = starts & (pos1 >= lo) & (pos1 <= hi)
    suffix_in = ends & (end1 >= lo) & (end1 <= hi)
    return int(np.count_nonzero(prefix_in | suffix_in))


def supplement_softclip_support(nbhd: Neighborhood, batch,
                                options: ScyllaOptions) -> None:
    """MNVSoftClipSupportFinder.SupplementSupportWithClippedReads
    (MNVSoftClipSupportFinder.cs.cs:31-83).

    For each accepted phased MNV of total allele length >=
    MinSizeForClipRescue, count reads whose soft-clipped prefix/suffix is
    anchored exactly at the MNV's divergence boundary
    (MNVSoftClipReadFilter.IsReadClippedAtMNVSite) and whose clipped bases
    reproduce the alternate haplotype (MNVClippedReadComparator.
    DoesClippedReadSupportMNV); then re-assign every candidate's q-score as
    AssignPoissonQScore(AlleleSupport, ReferenceSupport, noise, maxQ) —
    reference-support-as-coverage exactly as the reference does.
    """
    pos1 = batch.pos.astype(np.int64) + 1
    end1 = batch.end_pos.astype(np.int64) + 1
    starts, ends, prefix_len, suffix_len = _clip_flags(batch)

    for mnv in nbhd.accepted:
        ref, alt = mnv.ref_allele, mnv.alt_allele
        if len(ref) + len(alt) < options.min_size_for_clip_rescue:
            continue
        # last matching ref position before a trailing clip would begin
        if ref[0] == alt[0]:
            expected_end = mnv.position
        else:
            expected_end = mnv.position - 1
        # alignment start position of a read whose prefix was clipped here
        if ref[-1] == alt[-1]:
            expected_pos = mnv.position + len(ref) - 1
        else:
            expected_pos = mnv.position + len(ref)
        L = len(alt)
        alt_bytes = alt.encode()

        supported = np.zeros(len(pos1), dtype=bool)
        pre_idx = np.nonzero(starts & (pos1 == expected_pos)
                             & (prefix_len >= L))[0]
        for i in pre_idx:
            qs = batch.seq_off[i]
            n = int(prefix_len[i])
            prefix = ALLELE_CHARS[batch.seq[qs:qs + n]].tobytes()
            if prefix[n - L:] == alt_bytes:
                supported[i] = True
        suf_idx = np.nonzero(ends & (end1 == expected_end)
                             & (suffix_len >= L))[0]
        for i in suf_idx:
            qe = batch.seq_off[i + 1]
            n = int(suffix_len[i])
            suffix = ALLELE_CHARS[batch.seq[qe - n:qe]].tobytes()
            if suffix[:L] == alt_bytes:
                supported[i] = True
        n_clip = int(np.count_nonzero(supported))
        if n_clip:
            mnv.allele_support += n_clip
            mnv.soft_clip_allele_support += n_clip

    for mnv in nbhd.accepted:
        mnv.variant_qscore = int(stats.assign_poisson_qscore(
            mnv.allele_support, mnv.reference_support,
            options.min_base_call_quality, options.max_q))


def process_neighborhood(nbhd: Neighborhood, batch, keep, refseq,
                         options: ScyllaOptions) -> None:
    """VariantPhaser.CallMnvsForNeighborhood equivalent."""
    nbhd.set_range_of_interest(refseq)
    vead_groups = collect_vead_groups(nbhd, batch, keep, options)
    clusterer = NeighborhoodClusterer(options.clustering)
    cluster_set = clusterer.cluster_vead_groups(list(vead_groups))

    clusters = cluster_set.clusters
    if not clusters:
        pass
    else:
        depths, nocalls = depth_at_sites(
            [vg for c in clusters for vg in c.vead_groups])
        # crush mode AND both diploid modes anchor all phased alleles at the
        # first position of interest (CallableNeighborhood.cs:160-165)
        from pisces_tpu_torch.domain.types import PloidyModel
        anchored_mode = (options.crush_nbhd or options.ploidy_model in
                         (PloidyModel.DIPLOID_BY_THRESHOLDING,
                          PloidyModel.DIPLOID_BY_ADAPTIVE_GT))
        anchor = nbhd.first_position_of_interest if anchored_mode else -1
        for cluster in clusters:
            consensus = cluster.consensus_sites()
            ref_support = cluster.get_cluster_reference_support(clusters)
            mnv, ref_removal = extract_phased_allele(
                consensus, nbhd.reference_substring, depths, nocalls,
                ref_support, cluster.counts_at_sites, nbhd.chrom,
                options.min_base_call_quality, options.max_q, anchor)
            if mnv.category != AlleleCategory.REFERENCE and mnv.allele_support != 0:
                _add_combining(nbhd.accepted, mnv, options.max_q)
                for pos, count in ref_removal.items():
                    if pos not in nbhd.used_ref_counts:
                        nbhd.used_ref_counts[pos] = [0, mnv]
                    nbhd.used_ref_counts[pos][0] += count
            elif mnv.total_coverage != 0:
                _add_combining(nbhd.rejected, mnv, options.max_q)

    for pv in nbhd.accepted:
        pv.reference_support = pv.reference_support
        rec = nbhd.used_ref_counts.get(pv.position)
        if rec is not None and rec[1] is not pv:
            pv.reference_support = max(0, pv.reference_support - rec[0])

    # soft-clip rescue between MNV creation and genotyping
    # (VariantPhaser.cs:135-140)
    if nbhd.number_clipped_reads > 0 and options.use_soft_clipped_reads:
        supplement_softclip_support(nbhd, batch, options)

    _genotype_and_prune(nbhd, options)
    _call_mnvs(nbhd, options)
    _call_refs(nbhd, options)


def _add_combining(target: List[CalledAllele], mnv: CalledAllele, max_q: int):
    for i, existing in enumerate(target):
        if (existing.chromosome == mnv.chromosome
                and existing.position == mnv.position
                and existing.ref_allele == mnv.ref_allele
                and existing.alt_allele == mnv.alt_allele):
            target[i] = combine_phased_variants(existing, mnv, max_q)
            return
    target.append(mnv)


class _NbhdGTConfig:
    """Config shim for create_genotype_calculator, mirroring the parameters
    CallableNeighborhood passes to GenotypeCreator.CreateGenotypeCalculator
    (CallableNeighborhood.cs:83-89)."""

    def __init__(self, options: ScyllaOptions):
        self.ploidy_model = options.ploidy_model
        self.min_frequency_filter = options.min_frequency_filter
        self.min_depth_to_genotype = options.min_coverage
        self.min_gq_score = options.min_gq
        self.max_gq_score = options.max_gq
        self.target_lod_frequency = options.target_lod
        self.diploid_snv_parameters = options.diploid_snv_parameters
        self.diploid_indel_parameters = options.diploid_indel_parameters
        self.adaptive_parameters = options.adaptive_genotyping_parameters


def _nbhd_gt_calculator(options: ScyllaOptions):
    from pisces_tpu_torch.genotype import create_genotype_calculator
    return create_genotype_calculator(_NbhdGTConfig(options))


def _genotype_and_prune(nbhd: Neighborhood, options: ScyllaOptions) -> None:
    """CallableNeighborhood.SetGenotypesAndPruneExcessAlleles
    (CallableNeighborhood.cs:137-147): genotype ALL accepted phased variants
    as one locus via the ploidy-appropriate calculator, then drop pruned
    excess alleles. For somatic this genotypes each allele independently and
    prunes nothing."""
    prune = _nbhd_gt_calculator(options).set_genotypes(nbhd.accepted)
    for mnv in prune:
        nbhd.accepted.remove(mnv)


def _call_mnvs(nbhd: Neighborhood, options: ScyllaOptions) -> None:
    """VariantCaller.CallMNVs (genotyping already done nbhd-level by
    _genotype_and_prune, matching VariantPhaser.cs:141)."""
    nbhd.accepted.sort(key=lambda a: (a.position, a.ref_allele, a.alt_allele))
    found: Dict[int, List[CalledAllele]] = {}
    for mnv in nbhd.accepted:
        mnv.noise_level_applied = options.min_base_call_quality
        mnv.strand_bias_gatk = -100.0
        if mnv.variant_qscore < options.min_variant_qscore:
            continue
        if np.float32(mnv.frequency) < np.float32(options.min_frequency):
            continue
        if mnv.variant_qscore < options.min_variant_qscore_filter:
            mnv.add_filter(FilterType.LOW_VARIANT_QSCORE)
        if np.float32(mnv.frequency) < np.float32(options.min_frequency_filter):
            mnv.add_filter(FilterType.LOW_VARIANT_FREQUENCY)
        if mnv.total_coverage < options.low_depth_filter:
            mnv.add_filter(FilterType.LOW_DEPTH)
        mnv.set_fraction_no_calls()
        if (options.no_call_filter_threshold is not None
                and mnv.category != AlleleCategory.REFERENCE
                and mnv.fraction_no_calls > options.no_call_filter_threshold):
            mnv.add_filter(FilterType.NO_CALL)
        found.setdefault(mnv.position, []).append(mnv)
    nbhd.called_variants = found


def _call_refs(nbhd: Neighborhood, options: ScyllaOptions) -> None:
    """VariantCaller.CallRefs (ref recall genotyped by the nbhd's
    ploidy-appropriate calculator, VariantCaller.cs:42-66)."""
    gt_calc = _nbhd_gt_calculator(options)
    refs: Dict[int, CalledAllele] = {}
    for allele in nbhd.original_vcf_variants():
        sucked = nbhd.used_ref_counts.get(allele.position, [0, None])[0]
        ref_support = max(0, allele.reference_support - sucked)
        new_ref = create_allele(allele.chromosome, allele.position,
                                allele.ref_allele[:1], ".", ref_support,
                                allele.num_no_calls, allele.total_coverage,
                                ref_support, AlleleCategory.REFERENCE,
                                options.min_base_call_quality, options.max_q)
        if new_ref.variant_qscore < options.min_variant_qscore or \
                np.float32(new_ref.frequency) < np.float32(options.min_frequency):
            new_ref.genotype = Genotype.REF_LIKE_NOCALL
            new_ref.genotype_qscore = 0
            if np.float32(new_ref.frequency) < np.float32(options.min_frequency):
                new_ref.variant_qscore = 0
        new_ref.filters = []
        new_ref.strand_bias_gatk = -100.0
        if new_ref.variant_qscore < options.min_variant_qscore_filter:
            new_ref.add_filter(FilterType.LOW_VARIANT_QSCORE)
        if new_ref.total_coverage < options.low_depth_filter:
            new_ref.add_filter(FilterType.LOW_DEPTH)
        if new_ref.position not in refs:
            gt_calc.set_genotypes([new_ref])
            refs[new_ref.position] = new_ref
    nbhd.called_refs = refs


# ---------------------------------------------------------------------------
# Whole-file orchestration + merge
# ---------------------------------------------------------------------------

def run_scylla(vcf_path: str, bam_path: str, genome_dir: Optional[str] = None,
               out_dir: Optional[str] = None,
               options: Optional[ScyllaOptions] = None) -> str:
    from pisces_tpu_torch.io.native import open_bam
    from pisces_tpu_torch.io.bam import filter_batch
    from pisces_tpu_torch.io.fasta import Genome

    options = options or ScyllaOptions()
    out_dir = out_dir or os.path.dirname(vcf_path)
    os.makedirs(out_dir, exist_ok=True)
    # output name mirrors the input's flavor (Factory.cs:85-92)
    base = os.path.basename(vcf_path)
    if base.endswith(".genome.vcf"):
        out_name = base[:-len(".genome.vcf")] + ".phased.genome.vcf"
    else:
        out_name = base[:-len(".vcf")] + ".phased.vcf" \
            if base.endswith(".vcf") else base + ".phased.vcf"
    out_path = os.path.join(out_dir, out_name)

    genome = Genome(genome_dir) if genome_dir else None

    # pass 1: build neighborhoods from the vcf
    _, variants = read_header_and_variants(vcf_path)

    def allele_stream():
        for v in variants:
            for a in to_called_alleles(v):
                yield a

    neighborhoods = build_neighborhoods(allele_stream(), options.phasable)
    if options.phasable.max_num_nbhds_to_process > 0:
        neighborhoods = neighborhoods[:options.phasable.max_num_nbhds_to_process]
    log(f"Scylla: {len(neighborhoods)} neighborhoods to phase")

    # read access: per-neighborhood .bai region fetch when indexed (the
    # reference's VeadGroupSource + BamReader.Jump, VeadGroupSource.cs), a
    # cached whole-chromosome batch otherwise
    import os as _os
    import threading as _threading
    bam = open_bam(bam_path)
    has_bai = _os.path.exists(bam_path + ".bai")
    # per-neighborhood region fetch: pool of lazy readers (native handles
    # mutate decode state per fetch, so concurrent neighborhoods each
    # borrow one; the compressed file is mmap'd, shared across handles)
    lazy_pool: List = []
    batches: Dict[str, tuple] = {}
    refs: Dict[str, object] = {}
    cache_lock = _threading.Lock()

    def _refseq_for(chrom: str):
        with cache_lock:
            if chrom not in refs:
                refs[chrom] = (genome.get_chr_reference(chrom).sequence
                               if genome is not None
                               and chrom in genome.chromosome_names else None)
            return refs[chrom]

    def _reads_for(nbhd: Neighborhood):
        if nbhd.chrom not in bam.header.ref_names:
            return None
        if has_bai:
            with cache_lock:
                lazy = lazy_pool.pop() if lazy_pool else None
            if lazy is None:
                lazy = open_bam(bam_path, lazy=True)
            try:
                rid = lazy.header.ref_index(nbhd.chrom)
                beg0 = max(0, nbhd.sites[0].position - 1
                           - options.min_size_for_clip_rescue - 500)
                end0 = (max(s.position + len(s.ref) for s in nbhd.sites)
                        + options.min_size_for_clip_rescue + 500)
                b = lazy.fetch_region(rid, beg0, end0)
            finally:
                with cache_lock:
                    lazy_pool.append(lazy)
        else:
            with cache_lock:
                if nbhd.chrom not in batches:
                    batches[nbhd.chrom] = bam.fetch(
                        bam.header.ref_index(nbhd.chrom))
                b = batches[nbhd.chrom]
        k = filter_batch(b, options.min_map_quality,
                         options.remove_duplicates,
                         options.only_use_proper_pairs)
        return b, k

    def _phase_one(nbhd: Neighborhood) -> None:
        got = _reads_for(nbhd)
        if got is None:
            return
        b, k = got
        try:
            process_neighborhood(nbhd, b, k, _refseq_for(nbhd.chrom), options)
        except Exception as e:  # keep going per neighborhood (VariantPhaser)
            log(f"Error processing nbhd {nbhd.id}: {e}", "ERROR")

    todo = [nbhd for nbhd in neighborhoods
            if not (options.phasable.filtered_nbhd_to_process
                    and nbhd.id != options.phasable.filtered_nbhd_to_process)]
    if options.max_num_threads > 1:
        from pisces_tpu_torch.parallel.scheduler import JobManager
        JobManager(options.max_num_threads, error_mode="none").process(
            [(lambda n=nbhd: _phase_one(n)) for nbhd in todo])
    else:
        for nbhd in todo:
            _phase_one(nbhd)

    # pass 2: merge phased calls back into the vcf stream
    _merge_to_output(vcf_path, out_path, neighborhoods, options)
    return out_path


def _writer_config(options: ScyllaOptions):
    """PhasedVcfWriter configuration from the (possibly VCF-rehydrated)
    Scylla options: frequency significant digits and filter tag thresholds
    track the original Pisces settings."""
    from pisces_tpu_torch.io.vcf_write import VcfWriterConfig
    from pisces_tpu_torch.options import PiscesApplicationOptions
    o = PiscesApplicationOptions()
    v = o.variant_calling_parameters
    v.minimum_frequency = options.min_frequency
    v.minimum_frequency_filter = options.min_frequency_filter
    v.minimum_variant_qscore = options.min_variant_qscore
    v.minimum_variant_qscore_filter = options.min_variant_qscore_filter
    v.minimum_coverage = options.min_coverage
    v.low_depth_filter = options.low_depth_filter
    v.maximum_variant_qscore = options.max_q
    v.no_call_filter_threshold = options.no_call_filter_threshold
    o.vcf_writing_parameters.report_no_calls = options.report_no_calls
    o.vcf_writing_parameters.report_rc_counts = options.report_rc_counts
    o.vcf_writing_parameters.report_ts_counts = options.report_ts_counts
    return VcfWriterConfig(o)


def _adjust_forced(rows):
    """VcfMergerUtils.AdjustForcedAllele (VcfMergerUtils.cs:12-78): at a
    position carrying a ForcedReport allele, non-forced lines write first
    and forced lines follow — a forced line is dropped entirely when a
    non-forced line with the same (ref, alt) exists and at least one
    non-forced allele is a real variant. rows: [(CalledAllele, raw|None)]."""
    forced = [(a, raw) for a, raw in rows
              if FilterType.FORCED_REPORT in a.filters]
    if not forced:
        return rows
    non_forced = [(a, raw) for a, raw in rows
                  if FilterType.FORCED_REPORT not in a.filters]
    if non_forced and not all(a.is_ref_type for a, _ in non_forced):
        seen_alts = {(a.ref_allele, a.alt_allele) for a, _ in non_forced}
        forced = [(a, raw) for a, raw in forced
                  if (a.ref_allele, a.alt_allele) not in seen_alts]
    return non_forced + forced


def _merge_to_output(vcf_path: str, out_path: str,
                     neighborhoods: List[Neighborhood],
                     options: Optional[ScyllaOptions] = None) -> None:
    """VcfMerger.WriteVariantsUptoIncludingNbhd over all neighborhoods."""
    from pisces_tpu_torch.io.vcf_write import VcfWriterConfig, VcfWriter

    header, variants = read_header_and_variants(vcf_path)
    nbhd_by_chrom: Dict[str, List[Neighborhood]] = {}
    for nbhd in neighborhoods:
        nbhd_by_chrom.setdefault(nbhd.chrom, []).append(nbhd)

    wcfg = _writer_config(options) if options else VcfWriterConfig()
    from pisces_tpu_torch.io.vcf_write import VcfFormatter
    formatter = VcfFormatter(wcfg)

    def allele_line(a: CalledAllele) -> str:
        from pisces_tpu_torch.io.vcf_write import dotnet_format, MIN_SB_SCORE, MAX_SB_SCORE
        total_depth = formatter.get_depth_count([a])
        fmt, smp = formatter.construct_format_and_sample([a], total_depth)
        ref_s, alt_s = formatter.uncrushed_ref_and_alt(a)
        if a.is_ref_type and a.genotype in (Genotype.HOMOZYGOUS_REF,
                                            Genotype.REF_LIKE_NOCALL,
                                            Genotype.REF_AND_NOCALL):
            alt_s = "."
        return (f"{a.chromosome}\t{a.position}\t.\t{ref_s}\t{alt_s}\t"
                f"{a.variant_qscore}\t{formatter.map_filters([a])}\t"
                f"DP={total_depth}\t{fmt}\t{smp}")

    with open(out_path, "w", newline="\n") as out:
        for line in header:
            if line.startswith("#CHROM"):
                out.write("##phasing=Scylla\n")
            out.write(line + "\n")

        def write_rows(rows) -> None:
            seen_lines = set()
            for a, raw in rows:
                if raw is not None:
                    if raw not in seen_lines:
                        seen_lines.add(raw)
                        out.write(raw + "\n")
                else:
                    out.write(allele_line(a) + "\n")

        def flush_nbhd(nbhd, lines) -> None:
            """GetMergedListOfVariants over one neighborhood's collected
            original lines (VcfMerger.cs:205-282): replace used originals,
            swallow stats-identical phased alleles, append unconsumed phased
            alleles, sort the merged list once, write."""
            used_alleles = [(a.position, a.ref_allele, a.alt_allele)
                            for a in nbhd.original_vcf_variants()]
            out_alleles: List[Tuple[CalledAllele, Optional[str]]] = []
            by_pos: Dict[int, list] = {}
            for v in lines:
                by_pos.setdefault(v.position, []).append(v)
            for pos in by_pos:
                group_alleles = [(v, a) for v in by_pos[pos]
                                 for a in to_called_alleles(v)]
                mnvs_here = nbhd.called_variants.get(pos, [])
                wrote_mnv = bool(mnvs_here)
                for mnv in mnvs_here:
                    # identical allele with identical stats: keep the
                    # original line verbatim (VcfMerger.cs:226-236)
                    raw = None
                    for v, a in group_alleles:
                        if (a.position == mnv.position
                                and a.ref_allele == mnv.ref_allele
                                and a.alt_allele == mnv.alt_allele
                                and a.allele_support == mnv.allele_support
                                and a.total_coverage == mnv.total_coverage
                                and a.reference_support
                                == mnv.reference_support):
                            raw = v.raw_line
                            break
                    out_alleles.append((mnv, raw))
                nbhd.called_variants[pos] = []
                for v, a in group_alleles:
                    was_used = (a.position, a.ref_allele,
                                a.alt_allele) in used_alleles
                    if wrote_mnv:
                        # the phased MNVs own this locus: add back only
                        # unused non-reference originals — never a
                        # CalledRefs line (VcfMerger.cs:221-246)
                        if not was_used and not a.is_ref_type:
                            out_alleles.append((a, v.raw_line))
                    elif was_used:
                        new_ref = nbhd.called_refs.get(a.position)
                        if new_ref is not None and not any(
                                x[0].position == pos and x[0].is_ref_type
                                for x in out_alleles):
                            out_alleles.append((new_ref, None))
                    else:
                        out_alleles.append((a, v.raw_line))
            # phased alleles at positions never visited by an original line
            # (a leftover-bypassed first line, or an allele keyed between
            # originals): "in case we called any MNVs past the edge"
            # (VcfMerger.cs:270-278)
            for p in sorted(nbhd.called_variants):
                for mnv in nbhd.called_variants[p]:
                    out_alleles.append((mnv, None))
                nbhd.called_variants[p] = []

            # AlleleTupleCompareByLociAndAllele (VcfMerger.cs:278) compares
            # the stored alternate string: originals parsed from the VCF
            # keep their raw "." on reference lines (AlleleReader.cs:133),
            # so passthrough ref lines sort before letter alts; newly
            # phased CalledRefs carry their actual bases.
            def _sort_alt(t):
                a, raw = t
                return "." if (raw is not None and a.is_ref_type) \
                    else a.alt_allele
            out_alleles.sort(key=lambda t: (t[0].position, t[0].ref_allele,
                                            _sort_alt(t)))
            # forced-allele ordering is a per-position rule
            # (VcfMergerUtils.cs:12-78)
            final: List[Tuple[CalledAllele, Optional[str]]] = []
            i = 0
            while i < len(out_alleles):
                j = i
                while (j < len(out_alleles) and out_alleles[j][0].position
                        == out_alleles[i][0].position):
                    j += 1
                final.extend(_adjust_forced(out_alleles[i:j]))
                i = j
            write_rows(final)

        # Streaming emulation of VariantPhaser's merge loop: each merge
        # closes by READING the first line past its neighborhood; that line
        # becomes the next call's leftover, which WriteVariantsUptoChr
        # writes VERBATIM before merging (VcfMerger.cs:64-86 + VariantPhaser
        # .cs:92-99). A leftover that is the next neighborhood's first
        # variant therefore BYPASSES its own neighborhood's merge — its
        # original line passes through untouched and its phased twin is
        # emitted through the trailing unconsumed loop. Pinned by the
        # shipped Bcereus oracles: 694/814 (leftover-bypassed) get original
        # + phased lines; 1162/2275 (reached after intervening non-nbhd
        # lines) swallow the stats-identical phased allele.
        active = None
        collected: List = []
        just_closed_chrom: Optional[str] = None
        for group in iter_colocated(variants):
            chrom = group[0].chrom
            pos = group[0].position
            nbhd = None
            for nb in nbhd_by_chrom.get(chrom, []):
                if nb.first_position_of_interest <= pos <= nb.last_position_in_vcf:
                    nbhd = nb
                    break
            if active is not None and nbhd is not active:
                flush_nbhd(active, collected)
                collected = []
                just_closed_chrom = active.chrom
                active = None
            if nbhd is None:
                rows = [(to_called_alleles(v)[0], v.raw_line) for v in group
                        if to_called_alleles(v)]
                seen_raw = set()
                for _a, raw in _adjust_forced(rows):
                    if raw not in seen_raw:
                        seen_raw.add(raw)
                        out.write(raw + "\n")
                just_closed_chrom = None  # leftover consumed here
                continue
            if nbhd is not active:
                active = nbhd
                if just_closed_chrom == chrom:
                    # this group's first line is the previous merge's
                    # read-ahead leftover: verbatim passthrough, bypassing
                    # the merge (its colocated siblings, if any, are later
                    # blocks and merge normally)
                    out.write(group[0].raw_line + "\n")
                    group = group[1:]
                just_closed_chrom = None
            collected.extend(group)
        if active is not None:
            flush_nbhd(active, collected)


def pisces_defaults_from_vcf_header(vcf_path: str) -> dict:
    """VcfConsumerAppParsingUtils.GetPiscesOptionsFromVcfHeader: the original
    Pisces command line embedded in the input VCF supplies DEFAULTS for the
    variant-calling settings; explicit Scylla CLI flags take precedence
    (Scylla/Program.cs:58-77). Returns parser-default overrides keyed by
    the Scylla parser's dest names."""
    cmdline = None
    try:
        with open(vcf_path) as f:
            for line in f:
                if not line.startswith("##"):
                    break
                if line.startswith("##Pisces_cmdline="):
                    cmdline = line[len("##Pisces_cmdline="):].strip()
    except OSError:
        return {}
    if not cmdline:
        return {}
    toks = cmdline.replace('"', "").lower().split()
    flag_map = {
        "-minbq": ("minbq", int), "-minbasecallquality": ("minbq", int),
        "-minmq": ("minmq", int), "-minmapquality": ("minmq", int),
        "-minvq": ("minvq", int), "-minvariantqscore": ("minvq", int),
        "-vqfilter": ("vqfilter", int),
        "-variantqualityfilter": ("vqfilter", int),
        "-minvf": ("minvf", float),
        "-minimumvariantfrequency": ("minvf", float),
        "-minimumfrequency": ("minvf", float),
        "-vffilter": ("vffilter", float),
        "-minvariantfrequencyfilter": ("vffilter", float),
        "-c": ("mindp", int), "-mindp": ("mindp", int),
        "-mindepth": ("mindp", int), "-mincoverage": ("mindp", int),
        "-mindpfilter": ("mindpfilter", int),
        "-mindepthfilter": ("mindpfilter", int),
        "-maxvq": ("maxvq", int), "-maxvariantqscore": ("maxvq", int),
        "-ncfilter": ("ncfilter", float),
        # the reference adopts the ENTIRE original VariantCallingParams from
        # the Pisces header cmdline (VcfConsumerAppParsingUtils.cs:23-42),
        # which carries the ploidy model and diploid thresholds
        "-ploidy": ("ploidy", str),
        "-diploidsnvgenotypeparameters": ("diploidsnvgenotypeparameters", str),
        "-diploidindelgenotypeparameters": ("diploidindelgenotypeparameters", str),
    }
    out = {}
    i = 0
    while i < len(toks) - 1:
        hit = flag_map.get(toks[i])
        if hit is not None:
            dest, typ = hit
            try:
                out[dest] = typ(toks[i + 1])
            except ValueError:
                pass
            i += 2
        else:
            i += 1
    return out


def main(argv=None) -> int:
    """Scylla CLI with the reference's flag surface
    (ScyllaOptionsParser.cs: required/common/clustering/phasable-criteria/
    clipped-read-support groups plus the shared BamFilter and
    VariantCalling option groups), case-insensitive."""
    from pisces_tpu_torch.apps._pisces_main import _normalize

    def _b(s) -> bool:
        return str(s).strip().lower() in ("true", "1", "yes")

    p = argparse.ArgumentParser(prog="scylla", description="MNV phaser")
    a = p.add_argument
    a("-vcf", required=True)
    a("-bam", required=True)
    a("-g", "-genome", dest="genome", default=None)
    a("-o", "-out", dest="out", default=None)
    a("-chr", default=None, help="comma-separated chromosomes to process")
    a("-dist", "-phasingdistance", dest="phasingdistance", type=int,
      default=50)
    a("-passingvariantsonly", default="true")
    a("-hetvariantsonly", default="false")
    a("-maxnbhdstoprocess", type=int, default=-1)
    a("-minpassingvariantsinnbhd", type=int, default=0)
    a("-nbhd", "-filterednbhdtoprocess", dest="nbhd", default=None)
    a("-clusterconstraint", type=int, default=-1)
    a("-allowclustermerging", default="true")
    a("-allowworstfitremoval", default="true")
    a("-usesoftclippedreads", default="false")
    a("-minsizeforcliprescue", type=int, default=6)
    a("-t", "-maxnumthreads", dest="maxnumthreads", type=int, default=10)
    a("-ncfilter", type=float, default=0.6)
    a("-debug", default="false")
    # shared BamFilter group
    a("-minbq", "-minbasecallquality", dest="minbq", type=int, default=20)
    a("-minmq", "-minmapquality", dest="minmq", type=int, default=1)
    a("-filterduplicates", "-duplicatereadfilter", dest="filterduplicates",
      default="true")
    a("-pp", "-onlyuseproperpairs", dest="properpairs", default="false")
    # shared VariantCalling group (subset used by the phasing rescore)
    a("-minvq", "-minvariantqscore", dest="minvq", type=int, default=20)
    a("-vqfilter", "-variantqualityfilter", dest="vqfilter", type=int,
      default=30)
    a("-minvf", "-minimumvariantfrequency", "-minimumfrequency",
      dest="minvf", type=float, default=0.01)
    a("-vffilter", "-minvariantfrequencyfilter", dest="vffilter",
      type=float, default=None)
    a("-mindpfilter", "-mindepthfilter", dest="mindpfilter", type=int,
      default=None)
    a("-c", "-mindp", "-mindepth", "-mincoverage", dest="mindp", type=int,
      default=10)
    a("-maxvq", "-maxvariantqscore", dest="maxvq", type=int, default=100)
    a("-crushvcf", default="false")
    # shared VcfWriting group (VcfWritingParserUtils.cs:24-38)
    a("-reportnocalls", default="false")
    a("-reportrccounts", default="false")
    a("-reporttscounts", default="false")
    a("-ploidy", default="somatic",
      help="somatic (default), diploid, or diploidbyadaptivegt "
           "(VariantCallingOptionsParserUtils.cs:75-78)")
    a("-diploidsnvgenotypeparameters", default=None)
    a("-diploidindelgenotypeparameters", default=None)
    raw = _normalize(list(argv if argv is not None else sys.argv[1:]))
    # the original Pisces settings embedded in the input VCF header are the
    # DEFAULTS; explicit CLI flags win (Scylla/Program.cs AdjustOptions)
    pre, _extra = p.parse_known_args(raw)
    p.set_defaults(**pisces_defaults_from_vcf_header(pre.vcf))
    args = p.parse_args(raw)
    options = ScyllaOptions()
    ph = options.phasable
    ph.phasing_distance = args.phasingdistance
    ph.passing_variants_only = _b(args.passingvariantsonly)
    ph.het_variants_only = _b(args.hetvariantsonly)
    ph.max_num_nbhds_to_process = args.maxnbhdstoprocess
    ph.min_passing_variants_in_nbhd = args.minpassingvariantsinnbhd
    ph.filtered_nbhd_to_process = args.nbhd
    if args.chr:
        ph.chrs_to_process = tuple(c for c in args.chr.split(",") if c)
    cl = options.clustering
    cl.cluster_constraint = args.clusterconstraint
    cl.allow_cluster_merging = _b(args.allowclustermerging)
    cl.allow_worst_fit_removal = _b(args.allowworstfitremoval)
    options.use_soft_clipped_reads = _b(args.usesoftclippedreads)
    options.min_size_for_clip_rescue = args.minsizeforcliprescue
    options.min_base_call_quality = args.minbq
    options.min_map_quality = args.minmq
    options.remove_duplicates = _b(args.filterduplicates)
    options.only_use_proper_pairs = _b(args.properpairs)
    options.min_variant_qscore = args.minvq
    options.min_variant_qscore_filter = args.vqfilter
    options.min_frequency = args.minvf
    options.min_frequency_filter = (args.vffilter if args.vffilter is not None
                                    else args.minvf)
    options.low_depth_filter = (args.mindpfilter if args.mindpfilter is not None
                                else args.mindp)
    options.min_coverage = args.mindp
    options.max_q = args.maxvq
    options.crush_nbhd = _b(args.crushvcf)
    options.max_num_threads = args.maxnumthreads
    options.no_call_filter_threshold = args.ncfilter
    # ploidy model + ScyllaApplicationOptions.SetDerivedValues
    # (ScyllaApplicationOptions.cs:35-57): diploid-by-thresholding forces
    # MinimumFrequency to the diploid SNV MinorVF, then the filter floors
    # are raised to at least the call thresholds
    from pisces_tpu_torch.domain.types import PloidyModel
    ploidy = (args.ploidy or "somatic").strip().lower()
    if ploidy in ("diploid", "diploidbythresholding"):
        options.ploidy_model = PloidyModel.DIPLOID_BY_THRESHOLDING
    elif ploidy in ("diploidbyadaptivegt", "adaptive"):
        options.ploidy_model = PloidyModel.DIPLOID_BY_ADAPTIVE_GT
    else:
        options.ploidy_model = PloidyModel.SOMATIC

    def _thresholds(spec, target):
        parts = [float(x) for x in spec.split(",")]
        target.minor_vf, target.major_vf = parts[0], parts[1]
        if len(parts) > 2:
            target.sum_vf_for_multi_allelic_site = parts[2]
    if args.diploidsnvgenotypeparameters:
        _thresholds(args.diploidsnvgenotypeparameters,
                    options.diploid_snv_parameters)
    if args.diploidindelgenotypeparameters:
        _thresholds(args.diploidindelgenotypeparameters,
                    options.diploid_indel_parameters)
    if options.ploidy_model == PloidyModel.DIPLOID_BY_THRESHOLDING:
        options.min_frequency = options.diploid_snv_parameters.minor_vf
    if options.min_frequency_filter < options.min_frequency:
        options.min_frequency_filter = options.min_frequency
    if options.min_variant_qscore_filter < options.min_variant_qscore:
        options.min_variant_qscore_filter = options.min_variant_qscore
    options.report_no_calls = _b(args.reportnocalls)
    options.report_rc_counts = _b(args.reportrccounts)
    options.report_ts_counts = _b(args.reporttscounts)
    out = run_scylla(args.vcf, args.bam, args.genome, args.out, options)
    log(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
