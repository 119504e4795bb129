"""Gemini-equivalent read-pair preprocessing: stitch + targeted indel
realignment.

Orchestration port of the Gemini pipeline (GeminiWorkflow.Execute,
DataflowReadEvaluator.ProcessBam block streaming, IndelTargetFinder ->
BasicIndelFilterer -> GeminiReadRealigner -> output BAM): per chromosome,
collect indel evidence from the reads, filter to confident targets, realign
mismatched reads against those targets, optionally stitch overlapping pairs,
and emit a cleaned sorted BAM. The per-chromosome fan-out (GeminiMulti's
subprocess driver) maps onto a process pool.

All of it is host code: the stitcher and the realigner run in the native
library (io/_native/stitch.cpp, realign.cpp), and nothing here imports
torch, so the spawned workers of run_gemini_multi never open the card. A
run's counters (read pairs by class, indel targets, realigned reads,
stitched pairs, and the pairs stitched by the columnar native call against
the per-pair path) are logged and, given a dict as `stats`, returned in it.
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.io.bam import FLAG_PAIRED, FLAG_REVERSE, ReadBatch, filter_batch
from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.preprocessing.indels import (
    BasicIndelFilterer, ChromosomeIndelSource, IndelEvidence,
    find_read_indels, get_final_indels_for_chromosome, record_indel_evidence,
)
from pisces_tpu_torch.preprocessing.realigner import (
    GemBasicAlignmentComparer, GeminiReadRealigner, RealignmentEvaluator,
    RealignmentJudger,
)
from pisces_tpu_torch.preprocessing.stitcher import stitch_reads
from pisces_tpu_torch.utils.logger import log

ALLELE_CHARS = np.frombuffer(b"AGCTN-", dtype=np.uint8)
OP_S = 4


def _treatment_string(r1_realigned: bool, r2_realigned: bool,
                      stitch_word: str, s1: bool, s2: bool) -> str:
    """XT read-treatment value (AggregateRegionProcessor.ReadTreatment,
    AggregateRegionProcessor.cs:537-554)."""
    silenced = f"_Silenced{'R1' if s1 else ''}{'R2' if s2 else ''}" \
        if (s1 or s2) else ""
    return ((("R1Realigned" if r1_realigned else "R1Untouched") + "_"
             + ("R2Realigned" if r2_realigned else "R2Untouched") + "_"
             + stitch_word) + silenced)


@dataclass
class GeminiOptions:
    min_base_call_quality: int = 20
    min_map_quality: int = 1
    stitch_pairs: bool = True
    realign: bool = True
    classify: bool = True            # PairClassification-driven treatment
    trust_softclips: bool = False
    classifier_min_mapq: int = 10    # ReadPairClassifierAndExtractor default
    # GeminiOptions.cs / StitcherOptions.cs counterparts
    skip_and_remove_dups: bool = True     # GeminiOptions.cs:15
    keep_both_side_softclips: bool = False
    nify_disagreements: bool = False      # StitcherOptions.cs:17
    max_read_length: int = 1024           # StitcherOptions.cs:24
    use_softclipped_bases: bool = True    # StitcherOptions.cs:13
    stitch_probe_softclips: bool = False  # StitcherOptions.cs:21 (inverted
    #                                       into ignoreProbeSoftclips)
    dont_stitch_homopolymer_bridge: bool = True  # StitcherOptions.cs:26
    max_num_disagreeing_bases: Optional[int] = None  # StitcherOptions.cs:29
    count_ns_toward_disagreements: bool = False      # StitcherOptions.cs:30
    chromosomes: tuple = ()               # Chromosomes= filter
    num_softclips_messy: int = 8          # NumSoftclipsToBeConsideredMessy
    num_mismatches_messy: int = 3         # NumMismatchesToBeConsideredMessy
    messy_mapq: int = 30                  # MessyMapq
    # bin-signal realignment gating + read silencing (GeminiOptions.cs:29-49;
    # see preprocessing/bins.py). Gating applies when classification is on.
    use_bin_signal: bool = True
    collect_depth: bool = True
    messy_site_width: int = 500
    messy_site_threshold: int = 1
    imperfect_freq_threshold: float = 0.03
    indel_region_freq_threshold: float = 0.01
    region_depth_threshold: int = 5
    directional_mess_threshold: float = 0.2
    silence_suspicious_md_reads: bool = False
    silence_directional_mess_reads: bool = False
    silence_messy_map_mess_reads: bool = False
    force_high_likelihood_realigners: bool = False
    tag_treatment: bool = True            # XT/XP tags on processed reads
    # indel filtering (IndelFilteringOptions.cs:5-11)
    found_threshold: int = 3              # MinPreferredSupport
    min_anchor: int = 1                   # MinPreferredAnchor
    strict_found_threshold: int = 0       # MinRequiredIndelSupport
    strict_anchor_threshold: int = 0      # MinRequiredAnchor
    max_mess: int = 20
    # realignment behavior (RealignmentOptions.cs, GeminiOptions.cs)
    keep_probe_softclips: bool = False    # KeepProbe
    remask_messy_softclips: bool = False  # RemaskMessySoftclips
    mask_partial_insertion: bool = False  # MaskPartialInsertion
    minimum_unanchored_insertion_length: int = 0
    pair_aware_everything: bool = False
    softclip_unknown_indels: bool = False
    # CategoriesForRealignment override (RealignmentOptions.cs:9-31);
    # empty = the default REALIGN_CLASSES set
    categories_to_realign: tuple = ()
    # Snowballing (RealignmentOptions.cs:32, AggregateRegionProcessor.cs:
    # 184-255): reads in these categories realign FIRST; their per-indel
    # outcomes filter the target set down to "super-finalized" indels
    # before the remaining categories realign
    categories_to_snowball: tuple = ()
    recalculate_usable_sites_after_snowball: bool = False
    require_positive_outcome_for_snowball: bool = False
    # read/pair-level filters (StitcherPairFilter.cs:37-122 semantics)
    filter_for_proper_pairs: bool = False      # StitcherOptions.cs:10
    filter_pair_low_mapq: bool = True          # StitcherOptions.cs:28
    filter_pair_unmapped: bool = False         # StitcherOptions.cs:27
    ignore_reads_above_max_length: bool = False  # StitcherOptions.cs:25
    treat_abnormal_orientation_as_improper: bool = False  # GeminiOptions
    # block streaming (DataflowReadEvaluator.ProcessBam / GeminiOptions
    # RegionSize): process the BAM in fixed-size genomic blocks with
    # EdgeState boundary-pair handoff; 0 = whole-chromosome batches
    region_size: int = 0


def build_indel_source(chrom_name: str, refseq_str: str, batch: ReadBatch,
                       keep: np.ndarray, features, options: GeminiOptions
                       ) -> Tuple[ChromosomeIndelSource,
                                  Dict[str, IndelEvidence]]:
    """Indel evidence -> BasicIndelFilterer -> genome contextualization ->
    ranked bucketed source (the IndelTargetFinder/IndelEvidenceHelper/
    BasicIndelFilterer/HashableIndelSource/ChromosomeIndelSource chain)."""
    lookup: Dict[str, IndelEvidence] = {}
    nm_total = features.nm_sub + features.indel_bases
    for i in np.nonzero(keep & (features.indel_events > 0))[0]:
        i = int(i)
        if not features.primary[i] \
                or features.mapq[i] <= options.min_map_quality:
            continue
        pos1, cigar, seq, quals = _read_tuple(batch, i)
        indels = find_read_indels(chrom_name, pos1, cigar, seq, quals,
                                  refseq_str)
        reputable = (features.nm_sub[i] < 3
                     and (options.trust_softclips
                          or features.softclip_bases[i] < 10))
        record_indel_evidence(indels, lookup, bool(features.reverse[i]),
                              reputable, False,
                              bool(features.mate_unmapped[i]),
                              int(nm_total[i]))
    filterer = BasicIndelFilterer(options.found_threshold, options.min_anchor,
                                  options.strict_anchor_threshold,
                                  options.strict_found_threshold,
                                  options.max_mess)
    pres = filterer.get_realignable_preindels(lookup, allow_rescue=True)
    hashables = get_final_indels_for_chromosome(pres, refseq_str)
    return ChromosomeIndelSource(hashables), lookup


def make_evaluator(source: ChromosomeIndelSource, refseq_str: str,
                   options: GeminiOptions,
                   already_stitched: bool = False) -> RealignmentEvaluator:
    """BamRealignmentFactory.GetRealignPairHandler wiring
    (Interfaces/BamRealignmentFactory.cs:40-131)."""
    comparer = GemBasicAlignmentComparer(
        trust_softclips=(options.trust_softclips
                         or options.keep_both_side_softclips
                         or options.keep_probe_softclips))
    realigner = GeminiReadRealigner(
        comparer,
        mask_partial_insertion=options.mask_partial_insertion,
        keep_probe_softclips=options.keep_probe_softclips,
        keep_both_side_softclips=(options.keep_both_side_softclips
                                  or (options.keep_probe_softclips
                                      and already_stitched)),
        mask_ns_only=not (options.remask_messy_softclips
                          or options.keep_probe_softclips
                          or options.keep_both_side_softclips),
        minimum_unanchored_insertion_length=
        options.minimum_unanchored_insertion_length)
    judger = RealignmentJudger(comparer)
    return RealignmentEvaluator(
        source, realigner, judger, refseq_str,
        softclip_unknown_indels=options.softclip_unknown_indels,
        pair_aware_everything=options.pair_aware_everything)


def _read_tuple(batch: ReadBatch, i: int):
    s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
    qs, qe = batch.seq_off[i], batch.seq_off[i + 1]
    cigar = list(zip(batch.cigar_ops[s:e].tolist(),
                     batch.cigar_lens[s:e].tolist()))
    seq = ALLELE_CHARS[batch.seq[qs:qe]].tobytes().decode()
    quals = batch.qual[qs:qe]
    return int(batch.pos[i]) + 1, cigar, seq, quals


def gemini_keep_mask(batch: ReadBatch, options: GeminiOptions,
                     read_names: Optional[List[str]] = None) -> np.ndarray:
    """StitcherPairFilter read-skip + pair-blacklist rules
    (StitcherPairFilter.cs:37-122).

    Read-level skips: unmapped / secondary / supplementary / cigar-less;
    mapq in (0, min) only when FilterPairLowMapQ is OFF (with it on, low
    mapq blacklists the PAIR instead); improper pairs when
    FilterForProperPairs; reads above MaxReadLength when
    IgnoreReadsAboveMaxLength. Pair-level blacklists (both mates dropped):
    low-mapq mate (FilterPairLowMapQ), truly-unmapped mate
    (FilterPairUnmapped), duplicates (SkipAndRemoveDups)."""
    from pisces_tpu_torch.io.bam import (
        FLAG_DUPLICATE, FLAG_PROPER_PAIR, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
        FLAG_UNMAPPED,
    )
    flag = batch.flag
    keep = (flag & FLAG_UNMAPPED) == 0
    keep &= (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
    keep &= (batch.cigar_off[1:] - batch.cigar_off[:-1]) > 0
    keep &= batch.pos >= 0
    low_mapq = (batch.mapq > 0) & (batch.mapq < options.min_map_quality)
    if not options.filter_pair_low_mapq:
        keep &= ~low_mapq
    if options.filter_for_proper_pairs:
        keep &= (flag & FLAG_PROPER_PAIR) != 0
    if options.ignore_reads_above_max_length:
        keep &= ((batch.seq_off[1:] - batch.seq_off[:-1])
                 <= options.max_read_length)

    blacklist = np.zeros(batch.n, dtype=bool)
    if options.filter_pair_low_mapq:
        blacklist |= low_mapq
    if options.filter_pair_unmapped:
        # "truly unmapped": no flag AND no coordinates (the comment in
        # ShouldBlacklistReadIndexer distinguishes mapq-0-but-placed mates)
        blacklist |= ((flag & FLAG_UNMAPPED) != 0) & (batch.ref_id < 0)
        if batch.mate_ref_id is not None:
            from pisces_tpu_torch.io.bam import FLAG_MATE_UNMAPPED
            blacklist |= (((flag & FLAG_MATE_UNMAPPED) != 0)
                          & (batch.mate_ref_id < 0))
    if options.skip_and_remove_dups:
        blacklist |= (flag & FLAG_DUPLICATE) != 0
    if blacklist.any() and read_names is not None:
        # blacklisting is pair-wide: extend to same-name mates
        bad_names = {read_names[i] for i in np.nonzero(blacklist)[0]}
        for i in range(batch.n):
            if read_names[i] in bad_names:
                blacklist[i] = True
    return keep & ~blacklist


def process_chromosome(chrom_name: str, refseq: np.ndarray, batch: ReadBatch,
                       options: GeminiOptions,
                       read_names: Optional[List[str]] = None,
                       indel_csv_rows: Optional[List[str]] = None
                       ) -> Tuple[List[BamRecord], Dict[str, int]]:
    """Returns cleaned records + outcome counters."""
    from pisces_tpu_torch.preprocessing import classify as _classify
    _classify.NM_MESSY = options.num_mismatches_messy
    _classify.SOFTCLIPS_MESSY = options.num_softclips_messy
    _classify.MESSY_MAPQ = options.messy_mapq
    keep = gemini_keep_mask(batch, options, read_names)
    stats = defaultdict(int)
    from pisces_tpu_torch.domain.types import BASE_TO_ALLELE as _B2A
    from pisces_tpu_torch.preprocessing.classify import extract_features
    refseq_str = refseq.tobytes().decode("latin-1")
    features = extract_features(batch, _B2A[refseq], keep)
    indel_source = None
    evidence_lookup: Dict[str, IndelEvidence] = {}
    if options.realign:
        indel_source, evidence_lookup = build_indel_source(
            chrom_name, refseq_str, batch, keep, features, options)
    targets = indel_source.indels if indel_source is not None else []
    stats["indel_targets"] = len(targets)

    # pair classification decides each read's treatment
    cls_map = None
    if options.classify and read_names is not None and batch.n:
        from pisces_tpu_torch.domain.types import BASE_TO_ALLELE
        from pisces_tpu_torch.preprocessing.classify import (
            PASSTHROUGH_CLASSES, REALIGN_CLASSES, STITCH_CLASSES,
            classify_batch,
        )
        ref_codes = BASE_TO_ALLELE[refseq]
        cls_map = classify_batch(batch, ref_codes, read_names,
                                 options.classifier_min_mapq,
                                 options.trust_softclips,
                                 check_md=options.silence_suspicious_md_reads,
                                 abnormal_as_improper=options.
                                 treat_abnormal_orientation_as_improper)
        for cls in cls_map.values():
            stats[f"cls_{cls.name}"] += 1

    from pisces_tpu_torch.preprocessing.classify import (
        REALIGN_CLASSES as _REALIGN_DEFAULT, PairClassification,
    )
    realign_classes = _REALIGN_DEFAULT
    if options.categories_to_realign:
        realign_classes = frozenset(
            PairClassification[name] for name in options.categories_to_realign)

    def _realignable(i: int) -> bool:
        if cls_map is None:
            return True
        return cls_map[i] in realign_classes

    def _stitchable(i: int) -> bool:
        if cls_map is None:
            return True
        return cls_map[i] in STITCH_CLASSES

    # mate index for every kept paired read (pair-span gating + silencing)
    mate_of: Dict[int, int] = {}
    if read_names is not None:
        pair_members: Dict[str, List[int]] = defaultdict(list)
        for i in np.nonzero(keep)[0]:
            if batch.flag[i] & FLAG_PAIRED:
                pair_members[read_names[i]].append(int(i))
        for members in pair_members.values():
            if len(members) == 2:
                mate_of[members[0]] = members[1]
                mate_of[members[1]] = members[0]

    # bin-level conclusions: realignment is only attempted where the bin
    # signal says the region is messy AND holds a confirmed indel target
    # (AggregateRegionProcessor.cs:80-200; preprocessing/bins.py)
    conclusions = None
    if options.use_bin_signal and cls_map is not None:
        from pisces_tpu_torch.preprocessing.bins import (
            BinSignalOptions, compute_bin_conclusions,
        )
        kept_idx = np.nonzero(keep)[0]
        cls_codes = np.fromiter((int(cls_map[int(i)]) for i in kept_idx),
                                np.int32, len(kept_idx))
        conclusions = compute_bin_conclusions(
            len(refseq), batch.pos[kept_idx], batch.end_pos[kept_idx],
            cls_codes, np.array([t.position for t in targets], np.int64),
            BinSignalOptions(
                messy_site_width=options.messy_site_width,
                messy_site_threshold=options.messy_site_threshold,
                collect_depth=options.collect_depth,
                imperfect_freq_threshold=options.imperfect_freq_threshold,
                indel_region_freq_threshold=options.indel_region_freq_threshold,
                region_depth_threshold=options.region_depth_threshold,
                directional_mess_threshold=options.directional_mess_threshold))

    def _site_usable(i: int) -> bool:
        """doRealignPair gate (AggregateRegionProcessor.cs:473-478): pair
        min/max position in a usable bin, or high-likelihood override."""
        if conclusions is None:
            return True
        if options.force_high_likelihood_realigners:
            from pisces_tpu_torch.preprocessing.bins import HIGH_LIKELIHOOD_REALIGN
            if cls_map[i] in HIGH_LIKELIHOOD_REALIGN:
                return True
        j = mate_of.get(i, i)
        lo = min(int(batch.pos[i]), int(batch.pos[j]))
        hi = max(int(batch.end_pos[i]), int(batch.end_pos[j]))
        return conclusions.usable_at(lo, hi)

    realigned: Dict[int, Tuple[int, list]] = {}
    nified_quals: Dict[int, List[int]] = {}
    evaluator = None
    if targets and indel_source is not None:
        evaluator = make_evaluator(indel_source, refseq_str, options)
        nm_total = features.nm_sub + features.indel_bases
        # pair-aware second pass: a mate's confirmed/accepted indels feed
        # the partner's lookup (RealignPairHandler pair flow)
        confirmed_by_pair: Dict[int, List] = {}
        order = list(np.nonzero(keep)[0])

        def _realign_one(i: int) -> None:
            i = int(i)
            if not _realignable(i):
                return
            if not _site_usable(i):
                stats["skipped_realign_sites"] += 1
                return
            stats["realign_attempts"] += 1
            pos1, cigar, seq, quals = _read_tuple(batch, i)
            existing = (find_read_indels(chrom_name, pos1, cigar, seq, quals,
                                         refseq_str)
                        if features.indel_events[i] else None)
            mate = mate_of.get(i)
            confirmed = confirmed_by_pair.get(mate, None) \
                if mate is not None else None
            new_pos, new_cigar, changed, confirmed_flag, accepted, nified = \
                evaluator.get_final_alignment(
                    pos1, cigar, seq, quals, existing,
                    is_reverse=bool(features.reverse[i]),
                    is_paired=bool(features.paired[i]),
                    has_mismatches_or_indels=bool(nm_total[i] > 0),
                    confirmed_accepteds=confirmed)
            if accepted and mate is not None:
                confirmed_by_pair.setdefault(i, []).extend(accepted)
            if changed:
                realigned[i] = (new_pos, new_cigar)
                stats["realigned"] += 1
                if nified:
                    q = list(quals)
                    for k in nified:
                        if 0 <= k < len(q):
                            q[k] = 0
                    nified_quals[i] = q
            elif confirmed_flag:
                stats["confirmed"] += 1

        snowball_classes = frozenset()
        if options.categories_to_snowball and cls_map is not None:
            snowball_classes = frozenset(
                PairClassification[name]
                for name in options.categories_to_snowball)
        if snowball_classes:
            # phase 1 (snowball): the chosen categories realign first,
            # per category in option order (AggregateRegionProcessor.cs:
            # 187-198), accumulating per-indel outcomes
            snowballed = set()
            for name in options.categories_to_snowball:
                cat = PairClassification[name]
                for i in order:
                    if cls_map[int(i)] is cat:
                        _realign_one(int(i))
                        snowballed.add(int(i))
            # super-finalize: drop indels that kept failing or kept losing
            # to other indels (GetSuperFinalizedIndelsAfterSnowball,
            # AggregateRegionProcessor.cs:597-633)
            super_final = []
            for h in indel_source.indels:
                oc = evaluator.indel_outcomes.get(h.string_rep)
                if oc is None:
                    if not options.require_positive_outcome_for_snowball:
                        super_final.append(h)
                    continue
                confirmed_n, accepted_n, other_accepted, rejected = \
                    oc[0], oc[1], oc[2], oc[3]
                pos_n = confirmed_n + accepted_n
                not_confirmed_or_accepted = pos_n == 0
                more_other = other_accepted > pos_n * 1.5
                if rejected > 5 and (not_confirmed_or_accepted or more_other):
                    continue  # not good enough
                super_final.append(h)
            stats["snowball_super_finalized"] = len(super_final)
            stats["snowball_dropped"] = len(targets) - len(super_final)
            if len(super_final) != len(targets):
                indel_source = ChromosomeIndelSource(super_final)
                prior_outcomes = evaluator.indel_outcomes
                evaluator = make_evaluator(indel_source, refseq_str, options)
                # master outcomes lookup persists across the snowball
                # boundary (_masterOutcomesLookup)
                evaluator.indel_outcomes = prior_outcomes
            if (options.recalculate_usable_sites_after_snowball
                    and conclusions is not None):
                # reset indel regions from the super-finalized set and
                # re-extend (AggregateRegionProcessor.cs:218-255); the
                # messy/depth evidence inputs are unchanged, so a full
                # recompute with the new targets is equivalent
                kept_idx = np.nonzero(keep)[0]
                cls_codes = np.fromiter(
                    (int(cls_map[int(i)]) for i in kept_idx),
                    np.int32, len(kept_idx))
                conclusions = compute_bin_conclusions(
                    len(refseq), batch.pos[kept_idx], batch.end_pos[kept_idx],
                    cls_codes,
                    np.array([t.position for t in super_final], np.int64),
                    BinSignalOptions(
                        messy_site_width=options.messy_site_width,
                        messy_site_threshold=options.messy_site_threshold,
                        collect_depth=options.collect_depth,
                        imperfect_freq_threshold=
                        options.imperfect_freq_threshold,
                        indel_region_freq_threshold=
                        options.indel_region_freq_threshold,
                        region_depth_threshold=options.region_depth_threshold,
                        directional_mess_threshold=
                        options.directional_mess_threshold))
            # phase 2: everything else realigns against the filtered set
            for i in order:
                if int(i) not in snowballed:
                    _realign_one(int(i))
        else:
            for i in order:
                _realign_one(int(i))
    if indel_csv_rows is not None:
        # GeminiWorkflow.WriteIndelsCsv analog: evidence + outcome per indel
        outcomes = evaluator.indel_outcomes if evaluator is not None else {}
        for key, ev in evidence_lookup.items():
            oc = outcomes.get(key.split("|")[0], [0, 0, 0, 0])
            indel_csv_rows.append(
                f"{key},{ev.row()},{oc[0]},{oc[1]},{oc[3]}")

    # read silencing: directional-mess / suspicious-mapping categories in
    # flagged bins get base qualities zeroed unless realigned
    # (ReadsToSilence + SilenceReads)
    silence_set: set = set()
    if cls_map is not None and (options.silence_suspicious_md_reads
                                or (conclusions is not None
                                    and (options.silence_directional_mess_reads
                                         or options.silence_messy_map_mess_reads))):
        from pisces_tpu_torch.preprocessing.bins import reads_to_silence
        from pisces_tpu_torch.preprocessing.classify import (
            PairClassification as _PC,
        )
        seen_pairs = set()
        for i in np.nonzero(keep)[0]:
            i = int(i)
            j = mate_of.get(i)
            key = (min(i, j), max(i, j)) if j is not None else (i, i)
            if key in seen_pairs:
                continue
            seen_pairs.add(key)
            # suspicious-MD pairs are silenced outright, no bin lookup
            # (ReadsToSilence, AggregateRegionProcessor.cs:349-352)
            if (options.silence_suspicious_md_reads
                    and cls_map[i] == _PC.UNSTITCH_MESSY_SUSPICIOUS_MD):
                silence_set.update(k for k in (i, j) if k is not None)
                continue
            if conclusions is None:
                continue
            if batch.flag[i] & FLAG_REVERSE:
                fwd_idx, rev_idx = j, i
            else:
                fwd_idx, rev_idx = i, j
            silence_set |= reads_to_silence(
                int(cls_map[i]), fwd_idx, rev_idx,
                lambda k: int(batch.pos[k]), conclusions,
                options.silence_directional_mess_reads,
                options.silence_messy_map_mess_reads)
    silence_set -= set(realigned)
    if silence_set:
        stats["silenced"] = len(silence_set)

    def _quals_for(i: int, quals):
        if i in silence_set:
            return [0] * len(quals)
        if i in nified_quals:
            return nified_quals[i]
        return list(quals)

    def _tags_for(i: int, treatment: str, extra=None) -> Optional[dict]:
        """XT (treatment) / XP (classification) tags
        (AggregateRegionProcessor.cs:516-521)."""
        tags = dict(extra) if extra else {}
        if options.tag_treatment and cls_map is not None:
            tags["XT"] = treatment
            tags["XP"] = cls_map[i].name
        return tags or None

    # pair up mates by name for stitching
    records: List[BamRecord] = []
    by_name: Dict[str, List[int]] = defaultdict(list)
    if options.stitch_pairs and read_names is not None:
        for i in np.nonzero(keep)[0]:
            if (batch.flag[i] & FLAG_PAIRED) and _stitchable(int(i)):
                by_name[read_names[i]].append(int(i))

    stitched_members = set()
    stitch_attempted = set()

    def _emit_stitched(name, i1, i2, result):
        stats["stitched_pairs"] += 1
        stitched_members.update((i1, i2))
        treatment = _treatment_string(
            i1 in realigned, i2 in realigned, "Stitched",
            i1 in silence_set, i2 in silence_set)
        records.append(BamRecord(
            name, int(batch.ref_id[i1]), result.pos1 - 1,
            max(int(batch.mapq[i1]), int(batch.mapq[i2])),
            int(batch.flag[i1]) & ~0x1 & ~0x40 & ~0x80,
            result.cigar, result.seq, result.qual,
            tags=_tags_for(i1, treatment, {"XD": result.xd})))

    def _stitch_one(name, i1, i2):
        """Original per-pair path: handles realigned/silenced/nified
        members and any input the batched native port refuses."""
        p1, c1, s1, q1 = _read_tuple(batch, i1)
        p2, c2, s2, q2 = _read_tuple(batch, i2)
        q1, q2 = _quals_for(i1, q1), _quals_for(i2, q2)
        if i1 in realigned:
            p1, c1 = realigned[i1]
        if i2 in realigned:
            p2, c2 = realigned[i2]
        if p2 < p1:
            (i1, p1, c1, s1, q1), (i2, p2, c2, s2, q2) = \
                (i2, p2, c2, s2, q2), (i1, p1, c1, s1, q1)
        r1_reverse = bool(batch.flag[i1] & FLAG_REVERSE)
        result = stitch_reads(
            p1, c1, s1, q1, p2, c2, s2, q2, r1_reverse,
            options.min_base_call_quality,
            nify_disagreements=options.nify_disagreements,
            use_softclipped_bases=options.use_softclipped_bases,
            dont_stitch_homopolymer_bridge=
            options.dont_stitch_homopolymer_bridge,
            max_read_length=options.max_read_length,
            ignore_probe_softclips=not options.stitch_probe_softclips,
            r1_is_first_mate=bool(batch.flag[i1] & 0x40),
            threshold_num_disagreeing_bases=
            options.max_num_disagreeing_bases,
            count_ns_toward_disagreements=
            options.count_ns_toward_disagreements)
        stitch_attempted.update((i1, i2))
        stats["stitch_per_pair_pairs"] += 1
        if result is not None:
            _emit_stitched(name, i1, i2, result)
            stats["stitched_per_pair"] += 1

    # pairs whose members carry NO per-read overrides (realignment, quals
    # silencing/nification) go through ONE columnar native call
    # (stitch_pairs_columnar); the rest take the per-pair path. Records
    # are emitted in by_name order either way (the final stable sort keeps
    # equal-position records in append order — the full-file oracles pin
    # that order).
    plain: List[Tuple[str, int, int]] = []
    for name, members in by_name.items():
        if len(members) != 2:
            continue
        i1, i2 = members
        if (i1 in realigned or i2 in realigned or i1 in silence_set
                or i2 in silence_set or i1 in nified_quals
                or i2 in nified_quals):
            continue
        if batch.pos[i2] < batch.pos[i1]:
            i1, i2 = i2, i1
        plain.append((name, i1, i2))
    batch_results: Dict[str, Tuple[int, object]] = {}
    if plain:
        from pisces_tpu_torch.preprocessing.stitcher import stitch_pairs_columnar
        idx1 = np.fromiter((p[1] for p in plain), np.int64, len(plain))
        idx2 = np.fromiter((p[2] for p in plain), np.int64, len(plain))
        ok, results = stitch_pairs_columnar(
            batch, idx1, idx2,
            min_base_quality=options.min_base_call_quality,
            nify_disagreements=options.nify_disagreements,
            use_softclipped_bases=options.use_softclipped_bases,
            dont_stitch_homopolymer_bridge=
            options.dont_stitch_homopolymer_bridge,
            max_read_length=options.max_read_length,
            ignore_probe_softclips=not options.stitch_probe_softclips,
            threshold_num_disagreeing_bases=
            options.max_num_disagreeing_bases,
            count_ns_toward_disagreements=
            options.count_ns_toward_disagreements)
        if ok is not None:
            for p, (name, i1, i2) in enumerate(plain):
                batch_results[name] = (int(ok[p]), results[p])
    for name, members in by_name.items():
        if len(members) != 2:
            continue
        i1, i2 = members
        hit = batch_results.get(name)
        if hit is None:
            _stitch_one(name, i1, i2)
            continue
        rc, result = hit
        if rc == 1:
            if batch.pos[i2] < batch.pos[i1]:
                i1, i2 = i2, i1
            stitch_attempted.update((i1, i2))
            _emit_stitched(name, i1, i2, result)
            stats["stitch_batched_pairs"] += 1
            stats["stitched_batched"] += 1
        elif rc == 0:
            stitch_attempted.update((i1, i2))
            stats["stitch_batched_pairs"] += 1
        else:  # unsupported input or probe-softclip conflict
            _stitch_one(name, i1, i2)

    for i in range(batch.n):
        if not keep[i]:
            stats["dropped"] += 1
            continue
        if int(i) in stitched_members:
            continue
        pos1, cigar, seq, quals = _read_tuple(batch, i)
        quals = _quals_for(int(i), quals)
        if int(i) in realigned:
            pos1, cigar = realigned[int(i)]
        name = read_names[i] if read_names is not None else f"r{i}"
        tags = None
        if cls_map is not None and (_realignable(int(i))
                                    or _stitchable(int(i))):
            stitch_word = ("FailStitch" if int(i) in stitch_attempted
                           else "Unstitch")
            tags = _tags_for(int(i), _treatment_string(
                int(i) in realigned, False, stitch_word,
                int(i) in silence_set, False))
        records.append(BamRecord(name, int(batch.ref_id[i]), pos1 - 1,
                                 int(batch.mapq[i]), int(batch.flag[i]),
                                 cigar, seq, quals, tags=tags))
    records.sort(key=lambda r: (r.ref_id, r.pos0))
    return records, dict(stats)


def run_gemini(bam_path: str, genome_dir: str, out_path: Optional[str] = None,
               options: Optional[GeminiOptions] = None,
               stats: Optional[dict] = None) -> str:
    from pisces_tpu_torch.io.native import open_bam

    options = options or GeminiOptions()
    if out_path is None:
        out_path = bam_path.replace(".bam", ".gemini.bam")
    elif os.path.isdir(out_path):
        # reference -OutFolder semantics: write <folder>/<bam name>
        out_path = os.path.join(out_path, os.path.basename(bam_path))
    genome = Genome(genome_dir)
    reader = open_bam(bam_path)  # native decode incl. read names

    writer = BamWriter(out_path, reader.header.ref_names,
                       reader.header.ref_lengths,
                       extra_header_text="@PG\tID:gemini-tpu\tPN:gemini-tpu\n")
    total_stats = defaultdict(int)
    csv_rows: List[str] = []
    stream = options.region_size > 0 and os.path.exists(bam_path + ".bai")
    # -RegionSize blocks come from the native lazy reader: only the .bai
    # chunks of a block inflate
    lazy = open_bam(bam_path, lazy=True) if stream else None
    for chrom_name in genome.chromosome_names:
        if chrom_name not in reader.header.ref_names:
            continue
        if options.chromosomes and chrom_name not in options.chromosomes:
            continue
        rid = reader.header.ref_index(chrom_name)
        refseq = genome.get_chr_reference(chrom_name).sequence
        if stream:
            blocks = stream_blocks(lazy, rid, len(refseq),
                                   options.region_size)
        else:
            blocks = [reader.fetch(ref_id=rid, parse_names=True)]
        for batch in blocks:
            records, chrom_stats = process_chromosome(
                chrom_name, refseq, batch, options, batch.names,
                indel_csv_rows=csv_rows)
            for k, v in chrom_stats.items():
                total_stats[k] += v
            for r in records:
                writer.add(r)
    writer.write(sort=True, index=True)  # sorted + .bai (samtools sort/index
    # merge step of the reference GeminiWorkflow.cs:62-101, done natively)
    with open(out_path + ".indels.csv", "w") as f:
        f.write("indel,observations,leftAnchor,rightAnchor,mess,quality,"
                "forward,reverse,stitched,reputableSupport,isRepeat,isSplit,"
                "outcome,confirmed,accepted,rejected\n")
        for row in csv_rows:
            f.write(row + "\n")
    log(f"gemini: {dict(total_stats)} -> {out_path}")
    if stats is not None:
        stats.update(total_stats)
    return out_path


def _gemini_chrom_worker(args):
    """One chromosome in a worker process: writes a per-chr BAM shard."""
    bam_path, genome_dir, chrom_name, shard_path, opt_dict = args
    from pisces_tpu_torch.io.native import open_bam
    options = GeminiOptions(**opt_dict)
    genome = Genome(genome_dir)
    reader = open_bam(bam_path)
    rid = reader.header.ref_index(chrom_name)
    batch = reader.fetch(ref_id=rid, parse_names=True)
    refseq = genome.get_chr_reference(chrom_name).sequence
    records, stats = process_chromosome(chrom_name, refseq, batch, options,
                                        batch.names)
    w = BamWriter(shard_path, reader.header.ref_names,
                  reader.header.ref_lengths)
    for r in records:
        w.add(r)
    w.write(sort=True)
    return chrom_name, shard_path, stats


def run_gemini_multi(bam_path: str, genome_dir: str,
                     out_path: Optional[str] = None,
                     options: Optional[GeminiOptions] = None,
                     n_processes: int = 4,
                     stats: Optional[dict] = None) -> str:
    """GeminiMulti equivalent (GeminiMultiProcessor.ExecuteChromosomeJobs,
    exe/GeminiMulti/GeminiMultiProcessor.cs:30-200): one worker process per
    chromosome, per-chr BAM shards merged natively (the samtools cat/sort/
    index step of GeminiWorkflow.cs:62-101) into a sorted, indexed BAM."""
    import dataclasses
    import multiprocessing as mp
    import tempfile

    from pisces_tpu_torch.io.native import open_bam

    options = options or GeminiOptions()
    if out_path is None:
        out_path = bam_path.replace(".bam", ".gemini.bam")
    elif os.path.isdir(out_path):
        # reference -OutFolder semantics: write <folder>/<bam name>
        out_path = os.path.join(out_path, os.path.basename(bam_path))
    genome = Genome(genome_dir)
    header = open_bam(bam_path, lazy=True).header  # the header alone
    chroms = [c for c in genome.chromosome_names if c in header.ref_names
              and (not options.chromosomes or c in options.chromosomes)]
    tmpdir = tempfile.mkdtemp(prefix="gemini_multi_")
    jobs = [(bam_path, genome_dir, c, os.path.join(tmpdir, f"{c}.bam"),
             dataclasses.asdict(options)) for c in chroms]
    ctx = mp.get_context("spawn")
    total_stats = defaultdict(int)
    shards = {}
    with ctx.Pool(min(n_processes, max(len(jobs), 1))) as pool:
        for chrom_name, shard_path, chrom_stats in pool.imap_unordered(
                _gemini_chrom_worker, jobs):
            shards[chrom_name] = shard_path
            for k, v in chrom_stats.items():
                total_stats[k] += v

    # native merge in genome order (samtools cat analog): record bytes are
    # concatenated verbatim — tags and all — recompressed in parallel, and
    # the .bai rebuilt from analytic virtual offsets (io/bam_write.cat_bams)
    from pisces_tpu_torch.io.bam_write import cat_bams
    cat_bams([shards[c] for c in chroms], out_path,
             header.ref_names, header.ref_lengths,
             extra_header_text="@PG\tID:gemini-tpu\tPN:gemini-tpu\n")
    for c in chroms:
        os.unlink(shards[c])
    os.rmdir(tmpdir)
    log(f"gemini-multi: {dict(total_stats)} -> {out_path}")
    if stats is not None:
        stats.update(total_stats)
    return out_path


def stream_blocks(reader, rid: int, chrom_len: int, region_size: int):
    """Block-wise read iteration with EdgeState boundary-pair handoff
    (DataflowReadEvaluator.cs:38-375, EdgeState.cs): each block owns the
    reads STARTING inside it (fetched via the .bai with bounded inflation);
    a read whose mate starts in a later block is carried forward so the
    pair stitches/realigns together in the mate's block."""
    from pisces_tpu_torch.io.bam import (
        FLAG_MATE_UNMAPPED, FLAG_PAIRED, concat_batches, subset_batch,
    )
    carry = None
    for b0 in range(0, chrom_len, region_size):
        b1 = min(b0 + region_size, chrom_len)
        batch = reader.fetch_region(rid, b0, b1, parse_names=True)
        block = subset_batch(batch, batch.pos >= b0)
        if carry is not None and carry.n:
            block = concat_batches(carry, block)
        carry = None
        if b1 < chrom_len and block.mate_pos is not None:
            hold = ((block.flag & FLAG_PAIRED) != 0)
            hold &= (block.flag & FLAG_MATE_UNMAPPED) == 0
            hold &= block.mate_ref_id == rid
            hold &= block.mate_pos >= b1
            if hold.any():
                carry = subset_batch(block, hold)
                block = subset_batch(block, ~hold)
        yield block
    if carry is not None and carry.n:
        yield carry


def main(argv=None) -> int:
    """Gemini CLI: the reference flag surface
    (GeminiApplicationOptionsParser / GeminiMultiApplicationOptionsParser)
    for every option with a behavioral counterpart here, case-insensitive.
    Flags tied to the reference's samtools/TPL-dataflow internals
    (-Samtools, -ReadCacheSize, -NumConcurrentRegions, ...) are accepted and
    ignored: this build merges/sorts/indexes natively and streams columnar
    batches instead."""
    from pisces_tpu_torch.apps._pisces_main import _normalize

    def _b(s) -> bool:
        return str(s).strip().lower() in ("true", "1", "yes")

    p = argparse.ArgumentParser(prog="gemini-tpu",
                                description="stitch + indel realignment")
    a = p.add_argument
    a("-bam", required=True)
    a("-g", "-genome", dest="genome", required=True)
    a("-o", "-out", "-outfolder", dest="out", default=None)
    a("-stitch", default="true")
    a("-realign", default="true")
    a("-stitchonly", default="false")
    a("-realignonly", default="false")
    a("-multiprocess", default="false",
      help="GeminiMulti mode: one worker process per chromosome")
    a("-numprocesses", type=int, default=4)
    a("-maxnumthreads", type=int, default=4)
    a("-chromosomes", default=None, help="comma-separated chromosome filter")
    a("-minbasecallquality", type=int, default=20)
    a("-minmapquality", type=int, default=1)
    a("-minrequiredindelsupport", type=int, default=2)
    a("-trustsoftclips", default="false")
    a("-keepbothsidesoftclips", default="false")
    a("-skipandremovedups", default="true")
    a("-nifydisagreement", default="false")
    a("-maxreadlength", type=int, default=1024)
    a("-usesoftclippedbases", default="true")
    a("-stitchprobesoftclips", default="false")
    a("-dontstitchrepeatoverlap", default="true")
    a("-maxnumdisagreeingstitchedbases", type=int, default=None)
    a("-countnstowarddisagreeingbases", default="false")
    a("-numsoftclipstobeconsideredmessy", type=int, default=8)
    a("-nummismatchestobeconsideredmessy", type=int, default=3)
    a("-messymapq", type=int, default=30)
    # bin-signal gating + silencing (GeminiApplicationOptionsParser)
    a("-collectdepth", default="true")
    a("-messysitethreshold", type=int, default=1)
    a("-messysitewidth", type=int, default=500)
    a("-imperfectfreqthreshold", type=float, default=0.03)
    a("-indelregionfreqthreshold", type=float, default=0.01)
    a("-regiondepththreshold", type=int, default=5)
    a("-directionalmessthreshold", type=float, default=0.2)
    a("-silencesuspiciousmdreads", default="false")
    a("-silencedirectionalmessreads", default="false")
    a("-silencemessymapmessreads", default="false")
    a("-forcehighlikelihoodrealigners", default="false")
    a("-debug", default="false")
    a("-lightdebug", default="false")
    # accepted for command-line compatibility; no behavioral counterpart in
    # the native/columnar architecture
    a("-minpreferredsupport", type=int, default=3,
      help="observations before an indel is a preferred realignment target")
    a("-minpreferredanchor", type=int, default=1)
    a("-minrequiredanchor", type=int, default=0)
    a("-keepprobe", default="false")
    a("-remaskmessysoftclips", default="false")
    a("-maskpartialinsertion", default="false")
    a("-minimumunanchoredinsertionlength", type=int, default=0)
    a("-pairawareeverything", default="false")
    a("-softclipunknownindels", default="false")
    a("-regionsize", type=int, default=0,
      help="stream each chromosome in blocks of this many bases with "
           "boundary-pair handoff (needs a .bai); 0 = whole chromosome")
    a("-categoriestorealign", default=None,
      help="comma-separated PairClassification names overriding the "
           "default realignment category set")
    a("-categoriestosnowball", default=None,
      help="comma-separated PairClassification names to realign FIRST; "
           "their outcomes filter the indel targets (super-finalization) "
           "before the remaining categories realign")
    a("-recalculateusablesitesaftersnowball", default="false")
    a("-requirepositiveoutcomeforsnowball", default="false")
    a("-filterforproperpairs", default="false")
    a("-filterpairlowmapq", default="true")
    a("-filterpairunmapped", default="false")
    a("-treatabnormalorientationasimproper", default="false")
    a("-ignorereadsabovemaxlength", default="false")
    # accepted-and-inert flags, each inert IN THE REFERENCE TOO:
    # samtools/exepath (output merge is native here; reference shells out),
    # readcachesize/numconcurrentregions/binsize (TPL Dataflow tuning),
    # keepunmerged/sortperchrom/indexperchrom (external samtools staging),
    # trackmismatches/checksoftclipsformismatches (alternate mismatch
    # accounting in the comparer — assessed but default-off),
    # avoidlikelysnvs (feeds single-mismatch bin hits whose only consumer
    # is commented out — BinConclusions.cs:188 'isProbableSnv = false;
    # TODO'), logregionsandrealignments / stringtagstokeepfromr1 /
    # allowrescoringorigzero (log + tag plumbing).
    for flag in ("-samtools", "-samtoolsoldstyle", "-exepath",
                 "-readcachesize", "-numconcurrentregions",
                 "-binsize", "-keepunmerged",
                 "-sortperchrom", "-indexperchrom",
                 "-trackmismatches", "-logregionsandrealignments",
                 "-avoidlikelysnvs",
                 "-checksoftclipsformismatches",
                 "-stringtagstokeepfromr1",
                 "-allowrescoringorigzero"):
        a(flag, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(_normalize(list(argv if argv is not None
                                        else sys.argv[1:])))
    options = GeminiOptions()
    options.stitch_pairs = _b(args.stitch) and not _b(args.realignonly)
    options.realign = _b(args.realign) and not _b(args.stitchonly)
    options.min_base_call_quality = args.minbasecallquality
    options.min_map_quality = args.minmapquality
    options.strict_found_threshold = args.minrequiredindelsupport
    options.found_threshold = args.minpreferredsupport
    options.min_anchor = args.minpreferredanchor
    options.strict_anchor_threshold = args.minrequiredanchor
    options.keep_probe_softclips = _b(args.keepprobe)
    options.remask_messy_softclips = _b(args.remaskmessysoftclips)
    options.mask_partial_insertion = _b(args.maskpartialinsertion)
    options.minimum_unanchored_insertion_length = \
        args.minimumunanchoredinsertionlength
    options.pair_aware_everything = _b(args.pairawareeverything)
    options.softclip_unknown_indels = _b(args.softclipunknownindels)
    options.region_size = args.regionsize
    if args.categoriestorealign:
        # reference names are CamelCase (e.g. ImperfectStitched); our enum
        # members are UPPER_SNAKE
        import re as _re
        options.categories_to_realign = tuple(
            _re.sub(r"(?<!^)(?=[A-Z])", "_", c.strip()).upper()
            for c in args.categoriestorealign.split(",") if c.strip())
    if args.categoriestosnowball:
        import re as _re
        options.categories_to_snowball = tuple(
            _re.sub(r"(?<!^)(?=[A-Z])", "_", c.strip()).upper()
            for c in args.categoriestosnowball.split(",") if c.strip())
    options.recalculate_usable_sites_after_snowball = _b(
        args.recalculateusablesitesaftersnowball)
    options.require_positive_outcome_for_snowball = _b(
        args.requirepositiveoutcomeforsnowball)
    options.filter_for_proper_pairs = _b(args.filterforproperpairs)
    options.filter_pair_low_mapq = _b(args.filterpairlowmapq)
    options.filter_pair_unmapped = _b(args.filterpairunmapped)
    options.treat_abnormal_orientation_as_improper = _b(
        args.treatabnormalorientationasimproper)
    options.ignore_reads_above_max_length = _b(
        args.ignorereadsabovemaxlength)
    options.trust_softclips = _b(args.trustsoftclips)
    options.keep_both_side_softclips = _b(args.keepbothsidesoftclips)
    options.skip_and_remove_dups = _b(args.skipandremovedups)
    options.nify_disagreements = _b(args.nifydisagreement)
    options.max_read_length = args.maxreadlength
    options.use_softclipped_bases = _b(args.usesoftclippedbases)
    options.stitch_probe_softclips = _b(args.stitchprobesoftclips)
    options.dont_stitch_homopolymer_bridge = _b(args.dontstitchrepeatoverlap)
    options.max_num_disagreeing_bases = args.maxnumdisagreeingstitchedbases
    options.count_ns_toward_disagreements = \
        _b(args.countnstowarddisagreeingbases)
    options.num_softclips_messy = args.numsoftclipstobeconsideredmessy
    options.num_mismatches_messy = args.nummismatchestobeconsideredmessy
    options.messy_mapq = args.messymapq
    options.collect_depth = _b(args.collectdepth)
    options.messy_site_threshold = args.messysitethreshold
    options.messy_site_width = args.messysitewidth
    options.imperfect_freq_threshold = args.imperfectfreqthreshold
    options.indel_region_freq_threshold = args.indelregionfreqthreshold
    options.region_depth_threshold = args.regiondepththreshold
    options.directional_mess_threshold = args.directionalmessthreshold
    options.silence_suspicious_md_reads = _b(args.silencesuspiciousmdreads)
    options.silence_directional_mess_reads = \
        _b(args.silencedirectionalmessreads)
    options.silence_messy_map_mess_reads = _b(args.silencemessymapmessreads)
    options.force_high_likelihood_realigners = \
        _b(args.forcehighlikelihoodrealigners)
    if args.chromosomes:
        options.chromosomes = tuple(
            c for c in args.chromosomes.split(",") if c)
    if _b(args.multiprocess):
        run_gemini_multi(args.bam, args.genome, args.out, options,
                         args.numprocesses)
    else:
        run_gemini(args.bam, args.genome, args.out, options)
    return 0


if __name__ == "__main__":
    sys.exit(main())
