"""Gemini read-pair classification.

The ~30-way PairClassification scheme of the reference
(Gemini/Types/PairClassification.cs:3-46) and the decision tree of
ReadPairClassifierAndExtractor (ClassificationAndEvidenceCollection/
ReadPairClassifierAndExtractor.cs:36-803), re-derived from columnar batch
features instead of NM tags: per-read substitution counts are computed
directly against the reference sequence (vectorized over the expanded
batch), so classification works on BAMs without NM/MD.

Categories drive treatment (ClassificationBlockProvider.cs): duplicates and
unusable reads pass through untouched, perfect pairs go straight to
stitching, indel-containing and messy categories enter realignment.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from pisces_tpu_torch.io.bam import ReadBatch
from pisces_tpu_torch.pileup.events import expand_batch

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800

OP_I, OP_D, OP_S = 1, 2, 4

# thresholds (ReadPairClassifierAndExtractor.cs:17-19, ctor defaults)
NM_LIKELY_SNV_IN_STITCHED = 1
NM_MESSY = 3
NM_UNUSABLE_IF_SPLIT = 20
SOFTCLIPS_MESSY = 8
MESSY_MAPQ = 30
LONG_FRAGMENT = 1000


class PairClassification(enum.IntEnum):
    UNKNOWN = 0
    PERFECT_STITCHED = 1
    IMPERFECT_STITCHED = 2
    DISAGREE = 3
    FAIL_STITCH = 4
    UNUSABLE = 5
    SPLIT = 6
    UNSTITCH_INDEL = 7
    UNSTITCHABLE = 8
    MESSY_STITCHED = 9
    MESSY_SPLIT = 10
    UNUSABLE_SPLIT = 11
    UNSTITCH_IMPERFECT = 12
    UNSTITCH_PERFECT = 13
    LONG_FRAGMENT_ = 14
    UNSTITCH_MESSY = 15
    UNSTITCH_SINGLE_MISMATCH = 16
    SINGLE_MISMATCH_STITCHED = 17
    UNSTITCHABLE_AS_SINGLETON = 18
    INDEL_SINGLETON = 19
    INDEL_UNSTITCHABLE = 20
    UNSTITCH_FORWARD_MESSY = 21
    UNSTITCH_REVERSE_MESSY = 22
    IMPROPER = 23
    INDEL_IMPROPER = 24
    UNSTITCH_MESSY_INDEL = 25
    UNSTITCH_MESSY_SUSPICIOUS_READ = 26
    UNSTITCH_MESSY_INDEL_SUSPICIOUS_READ = 27
    UNSTITCH_FORWARD_MESSY_INDEL = 28
    UNSTITCH_REVERSE_MESSY_INDEL = 29
    DUPLICATE = 30
    UNSTITCH_MESSY_SUSPICIOUS_MD = 31


# categories whose reads enter targeted realignment: the reference's
# default CategoriesForRealignment (Utility/RealignmentOptions.cs:9-29)
# plus the singleton/indel-singleton categories — our realigner derives
# mismatch counts from the reference sequence directly, so evidence-based
# realignment of messy singletons is sound where the reference (NM-tag
# dependent) skips them.
REALIGN_CLASSES = frozenset({
    PairClassification.IMPERFECT_STITCHED, PairClassification.FAIL_STITCH,
    PairClassification.UNSTITCH_INDEL, PairClassification.UNSTITCHABLE,
    PairClassification.DISAGREE, PairClassification.MESSY_STITCHED,
    PairClassification.MESSY_SPLIT, PairClassification.UNSTITCH_IMPERFECT,
    PairClassification.LONG_FRAGMENT_, PairClassification.UNSTITCH_MESSY,
    PairClassification.UNSTITCH_FORWARD_MESSY,
    PairClassification.UNSTITCH_REVERSE_MESSY,
    PairClassification.UNSTITCH_FORWARD_MESSY_INDEL,
    PairClassification.UNSTITCH_REVERSE_MESSY_INDEL,
    PairClassification.UNSTITCH_MESSY_SUSPICIOUS_READ,
    PairClassification.UNSTITCH_MESSY_INDEL_SUSPICIOUS_READ,
    PairClassification.UNSTITCH_MESSY_INDEL,
    PairClassification.UNSTITCH_MESSY_SUSPICIOUS_MD,
    # singleton extensions (see module docstring)
    PairClassification.UNSTITCHABLE_AS_SINGLETON,
    PairClassification.INDEL_SINGLETON,
    PairClassification.INDEL_UNSTITCHABLE,
})

# categories eligible for (post-realignment) pair stitching
# (TypeClassifier.ClassificationIsStitchable, TypeClassifier.cs:26-45)
STITCH_CLASSES = frozenset({
    PairClassification.DISAGREE, PairClassification.FAIL_STITCH,
    PairClassification.UNSTITCH_INDEL, PairClassification.UNSTITCH_IMPERFECT,
    PairClassification.UNSTITCH_PERFECT, PairClassification.LONG_FRAGMENT_,
    PairClassification.UNSTITCH_MESSY, PairClassification.UNSTITCH_MESSY_INDEL,
    PairClassification.UNSTITCH_MESSY_SUSPICIOUS_READ,
    PairClassification.UNSTITCH_MESSY_INDEL_SUSPICIOUS_READ,
    PairClassification.UNSTITCHABLE,
    PairClassification.UNSTITCH_SINGLE_MISMATCH,
    PairClassification.UNSTITCH_REVERSE_MESSY,
    PairClassification.UNSTITCH_FORWARD_MESSY,
    PairClassification.UNSTITCH_FORWARD_MESSY_INDEL,
    PairClassification.UNSTITCH_REVERSE_MESSY_INDEL,
})

# pass through the output BAM untouched
PASSTHROUGH_CLASSES = frozenset({
    PairClassification.DUPLICATE, PairClassification.UNUSABLE,
    PairClassification.UNUSABLE_SPLIT, PairClassification.SPLIT,
    PairClassification.IMPROPER,
})


@dataclass
class ReadFeatures:
    """Per-read classification inputs (vectorized extraction)."""

    nm_sub: np.ndarray        # substitutions vs reference (NM minus indels)
    indel_events: np.ndarray  # number of I/D cigar ops
    indel_bases: np.ndarray   # bases in I/D ops
    indel_pos: np.ndarray     # 1-based genomic pos of first I/D op (-1 none)
    softclip_bases: np.ndarray
    mapq: np.ndarray
    reverse: np.ndarray
    duplicate: np.ndarray
    proper: np.ndarray
    paired: np.ndarray
    unmapped: np.ndarray
    mate_unmapped: np.ndarray
    primary: np.ndarray
    pos: np.ndarray
    end_pos: np.ndarray


def extract_features(batch: ReadBatch, ref_codes: np.ndarray,
                     keep: Optional[np.ndarray] = None) -> ReadFeatures:
    """Vectorized per-read features; nm via direct reference comparison."""
    n = batch.n
    if keep is None:
        keep = np.ones(n, dtype=bool)
    ex = expand_batch(batch, keep)
    nm = np.zeros(n, dtype=np.int32)
    if len(ex.read_idx):
        mapped = ex.gpos > 0
        in_ref = mapped & (ex.gpos <= len(ref_codes))
        base = batch.seq[ex.seq_idx[in_ref]]
        ref = ref_codes[ex.gpos[in_ref] - 1]
        mism = (base != ref) & (base >= 0) & (base != 4) & (ref >= 0)
        np.add.at(nm, ex.read_idx[in_ref][mism], 1)

    n_ops = np.diff(batch.cigar_off)
    op_read = np.repeat(np.arange(n, dtype=np.int32), n_ops)
    ops = batch.cigar_ops
    lens = batch.cigar_lens
    indel_events = np.zeros(n, np.int32)
    indel_bases = np.zeros(n, np.int32)
    sc_bases = np.zeros(n, np.int32)
    indel_pos = np.full(n, -1, np.int64)
    if len(ops):
        is_indel = (ops == OP_I) | (ops == OP_D)
        np.add.at(indel_events, op_read[is_indel], 1)
        np.add.at(indel_bases, op_read[is_indel], lens[is_indel])
        is_sc = ops == OP_S
        np.add.at(sc_bases, op_read[is_sc], lens[is_sc])
        # genomic offset of each op within its read (ref-consuming prefix)
        from pisces_tpu_torch.pileup.events import OP_CONSUMES_REF
        ref_lens = lens.astype(np.int64) * OP_CONSUMES_REF[ops]
        g = np.concatenate(([0], np.cumsum(ref_lens)))[:-1]
        first_op = batch.cigar_off[:-1]
        safe_first = np.minimum(first_op, max(len(ops) - 1, 0))
        ref_off = g - g[safe_first][op_read]
        gstart = batch.pos.astype(np.int64)[op_read] + 1 + ref_off
        for j in np.nonzero(is_indel)[0][::-1]:
            indel_pos[op_read[j]] = gstart[j]

    flag = batch.flag
    return ReadFeatures(
        nm_sub=nm, indel_events=indel_events, indel_bases=indel_bases,
        indel_pos=indel_pos,
        softclip_bases=sc_bases, mapq=np.asarray(batch.mapq),
        reverse=(flag & FLAG_REVERSE) != 0,
        duplicate=(flag & FLAG_DUPLICATE) != 0,
        proper=(flag & FLAG_PROPER) != 0,
        paired=(flag & FLAG_PAIRED) != 0,
        unmapped=(flag & FLAG_UNMAPPED) != 0,
        mate_unmapped=(flag & FLAG_MATE_UNMAPPED) != 0,
        primary=(flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0,
        pos=np.asarray(batch.pos), end_pos=np.asarray(batch.end_pos))


@dataclass
class MdStats:
    """Per-read mismatch composition (the reference derives this from the
    MD tag — Helper.GetMdCountsWithSubstitutions, used by
    ReadPairClassifierAndExtractor.HasSuspiciousMd cs:256-330; here it is
    computed directly against the reference sequence)."""
    ref_comp: np.ndarray     # [n,4] mismatch counts by reference base AGCT
    sub_comp: np.ndarray     # [n,4] mismatch counts by substituted read base
    n_subs: np.ndarray       # [n]   aligned positions where the read has N
    run_len: np.ndarray      # [n]   longest run of adjacent mismatches
    num_in_runs: np.ndarray  # [n]   mismatches inside runs of length >= 2


def compute_md_stats(batch: ReadBatch, ref_codes: np.ndarray,
                     keep: Optional[np.ndarray] = None) -> MdStats:
    n = batch.n
    if keep is None:
        keep = np.ones(n, dtype=bool)
    ref_comp = np.zeros((n, 4), np.int32)
    sub_comp = np.zeros((n, 4), np.int32)
    n_subs = np.zeros(n, np.int32)
    run_len = np.zeros(n, np.int32)
    num_in_runs = np.zeros(n, np.int32)
    ex = expand_batch(batch, keep)
    if len(ex.read_idx):
        mapped = (ex.gpos > 0) & (ex.gpos <= len(ref_codes))
        base = batch.seq[ex.seq_idx]
        ref = np.where(mapped, ref_codes[np.clip(ex.gpos - 1, 0, None)], -1)
        is_n = mapped & (base == 4) & (ref >= 0) & (ref < 4)
        mism = mapped & (base != ref) & (base >= 0) & (base < 4) \
            & (ref >= 0) & (ref < 4)
        np.add.at(n_subs, ex.read_idx[is_n], 1)
        np.add.at(ref_comp, (ex.read_idx[mism], ref[mism]), 1)
        np.add.at(sub_comp, (ex.read_idx[mism], base[mism]), 1)
        mi = np.nonzero(mism)[0]
        if len(mi):
            r = ex.read_idx[mi]
            g = ex.gpos[mi]
            new_run = np.ones(len(mi), bool)
            # a run continues while the same read mismatches consecutive
            # reference positions (insertions between do not break an MD run)
            new_run[1:] = (r[1:] != r[:-1]) | (g[1:] != g[:-1] + 1)
            run_id = np.cumsum(new_run) - 1
            counts = np.bincount(run_id).astype(np.int32)
            run_reads = r[new_run]
            np.maximum.at(run_len, run_reads, counts)
            big = counts >= 2
            np.add.at(num_in_runs, run_reads[big], counts[big])
    return MdStats(ref_comp, sub_comp, n_subs, run_len, num_in_runs)


def _one_much_worse(a: int, b: int, threshold: int) -> bool:
    """OneMuchWorse (ReadPairClassifierAndExtractor.cs:339-355)."""
    if a > b:
        return a > threshold and a > b * 2
    return b > threshold and b > a * 2


def has_suspicious_md(md: MdStats, f: "ReadFeatures", i1: int,
                      i2: int) -> bool:
    """HasSuspiciousMd (cs:256-330): for a messy non-indel pair, excess Ns
    or a lopsided mismatch composition between overlapping mates marks the
    pair as a probable sequencing/mapping artifact."""
    if int(md.n_subs[i1]) > NM_MESSY or int(md.n_subs[i2]) > NM_MESSY:
        return True
    # mates that do not overlap cannot be compared (pair.DontOverlap)
    if f.end_pos[i1] < f.pos[i2] or f.end_pos[i2] < f.pos[i1]:
        return False
    t1 = int(md.ref_comp[i1].sum())
    t2 = int(md.ref_comp[i2].sum())
    total_md_suspicious = 8
    run_length_suspicious = 2
    num_in_runs_suspicious = 4
    suspicious_total = (t1 > total_md_suspicious
                        or t2 > total_md_suspicious)
    suspicious_runs = (
        max(int(md.num_in_runs[i1]), int(md.num_in_runs[i2]))
        > num_in_runs_suspicious
        or max(int(md.run_len[i1]), int(md.run_len[i2]))
        > run_length_suspicious)
    if suspicious_total or suspicious_runs:
        if _one_much_worse(t1, t2, total_md_suspicious):
            return True
        per_type = 4
        for k in range(4):
            if _one_much_worse(int(md.ref_comp[i1, k]),
                               int(md.ref_comp[i2, k]), per_type):
                return True
            if _one_much_worse(int(md.sub_comp[i1, k]),
                               int(md.sub_comp[i2, k]), per_type):
                return True
    return False


def _messy_suspicious(cls, mapq1, mapq2, has_indels):
    """AdjustClassificationForMultimapper (cs:359-380)."""
    if cls in (PairClassification.UNSTITCH_MESSY,
               PairClassification.UNSTITCH_MESSY_INDEL):
        if mapq1 < MESSY_MAPQ or mapq2 < MESSY_MAPQ:
            return (PairClassification.UNSTITCH_MESSY_INDEL_SUSPICIOUS_READ
                    if has_indels
                    else PairClassification.UNSTITCH_MESSY_SUSPICIOUS_READ)
    return cls


def _classify_indel_pair(f: ReadFeatures, i1: int, i2: Optional[int],
                         base_cls) -> PairClassification:
    """HandlePairContainingIndels (cs:497-590): total mismatch events
    (substitutions + indel ops) decide messy-indel subcategories."""
    t1 = int(f.nm_sub[i1]) + int(f.indel_events[i1])
    t2 = (int(f.nm_sub[i2]) + int(f.indel_events[i2])) if i2 is not None else 0
    cls = base_cls
    if max(t1, t2) > NM_MESSY and base_cls in (
            PairClassification.UNSTITCH_INDEL, PairClassification.DISAGREE):
        cls = PairClassification.UNSTITCH_MESSY_INDEL
        if t1 <= 2 and i2 is not None:
            cls = (PairClassification.UNSTITCH_REVERSE_MESSY_INDEL
                   if f.reverse[i2]
                   else PairClassification.UNSTITCH_FORWARD_MESSY_INDEL)
        elif t2 <= 2:
            cls = (PairClassification.UNSTITCH_REVERSE_MESSY_INDEL
                   if f.reverse[i1]
                   else PairClassification.UNSTITCH_FORWARD_MESSY_INDEL)
        cls = _messy_suspicious(cls, int(f.mapq[i1]),
                                int(f.mapq[i2]) if i2 is not None else 255,
                                True)
    return cls


def classify_pair(f: ReadFeatures, i1: int, i2: Optional[int],
                  min_map_quality: int = 10,
                  trust_softclips: bool = False,
                  abnormal_as_improper: bool = False,
                  batch: Optional[ReadBatch] = None) -> PairClassification:
    """Classify one pair (i2 None = singleton/mate unseen).

    Follows GetBamAlignmentsAndClassification (cs:43-253).
    abnormal_as_improper: TreatAbnormalOrientationAsImproper — a pair not
    in FR orientation classifies as Improper even when flagged proper
    (isImproper = IsImproper || !NormalPairOrientation,
    ReadPairClassifierAndExtractor.cs:451; orientation per
    ReadPair.cs:108-132)."""
    if f.duplicate[i1] or (i2 is not None and f.duplicate[i2]):
        return PairClassification.DUPLICATE

    has_indels1 = f.indel_events[i1] > 0
    has_indels2 = i2 is not None and f.indel_events[i2] > 0
    has_indels = bool(has_indels1 or has_indels2)

    if i2 is None:
        # incomplete pair (ClassifyIncompletePair, cs:443-495)
        improper = bool(f.paired[i1] and not f.proper[i1])
        if (abnormal_as_improper and batch is not None and f.paired[i1]
                and not f.mate_unmapped[i1]
                and not _normal_orientation(batch, i1)):
            improper = True
        if f.unmapped[i1]:
            return PairClassification.UNUSABLE
        if improper and not f.mate_unmapped[i1]:
            return (PairClassification.INDEL_IMPROPER if has_indels
                    else PairClassification.IMPROPER)
        if has_indels:
            return PairClassification.INDEL_SINGLETON
        if f.nm_sub[i1] > NM_UNUSABLE_IF_SPLIT:
            return PairClassification.UNUSABLE_SPLIT
        return PairClassification.UNSTITCHABLE_AS_SINGLETON

    # completed pair
    if f.unmapped[i1] or f.unmapped[i2]:
        return PairClassification.UNUSABLE
    frag = int(max(f.end_pos[i1], f.end_pos[i2])
               - min(f.pos[i1], f.pos[i2]))
    if not f.proper[i1] and frag > LONG_FRAGMENT:
        cls = PairClassification.LONG_FRAGMENT_
        if has_indels:
            cls = _classify_indel_pair(f, i1, i2,
                                       PairClassification.UNSTITCH_INDEL)
        return cls
    if not f.proper[i1]:
        return (PairClassification.INDEL_IMPROPER if has_indels
                else PairClassification.IMPROPER)

    hq1 = f.mapq[i1] >= min_map_quality
    hq2 = f.mapq[i2] >= min_map_quality
    if not (hq1 or hq2):
        return PairClassification.UNUSABLE
    if not (hq1 and hq2):
        # one low-quality mate -> split treatment (cs:205-215, 625-668)
        if has_indels:
            return _classify_indel_pair(f, i1, i2,
                                        PairClassification.UNSTITCH_INDEL)
        nm_max = max(int(f.nm_sub[i1]), int(f.nm_sub[i2]))
        if nm_max > NM_UNUSABLE_IF_SPLIT:
            return PairClassification.UNUSABLE_SPLIT
        if nm_max > NM_MESSY:
            return PairClassification.MESSY_SPLIT
        return PairClassification.SPLIT

    if has_indels:
        # overlapping mates may disagree on indels: the clean mate must
        # actually span the indel position to contradict it
        # (OverlappingIndelHelpers.IndelsDisagreeWithStrongMate)
        base = PairClassification.UNSTITCH_INDEL
        if f.end_pos[i1] >= f.pos[i2] and (has_indels1 != has_indels2):
            indel_read = i1 if has_indels1 else i2
            clean = i2 if has_indels1 else i1
            ip = int(f.indel_pos[indel_read])
            spans = (ip >= 0 and f.pos[clean] + 1 <= ip
                     and ip <= f.end_pos[clean] + 1)
            if spans and f.nm_sub[clean] <= NM_LIKELY_SNV_IN_STITCHED \
                    and f.indel_events[clean] == 0:
                base = PairClassification.DISAGREE
        return _classify_indel_pair(f, i1, i2, base)

    nm1, nm2 = int(f.nm_sub[i1]), int(f.nm_sub[i2])
    sc1, sc2 = int(f.softclip_bases[i1]), int(f.softclip_bases[i2])
    if not trust_softclips and (sc1 > 0 or sc2 > 0):
        # ClassifySoftclipContainingPairGivenSoftclipDistrust (cs:382-441)
        messy1 = (sc1 >= SOFTCLIPS_MESSY or (nm1 > 1 and sc1 > 0)
                  or nm1 >= NM_MESSY)
        messy2 = (sc2 >= SOFTCLIPS_MESSY or (nm2 > 1 and sc2 > 0)
                  or nm2 >= NM_MESSY)
        clean1 = not messy1 and sc1 == 0 and nm1 <= 2
        clean2 = not messy2 and sc2 == 0 and nm2 <= 2
        cls = PairClassification.UNSTITCH_IMPERFECT
        if messy1 or messy2:
            cls = PairClassification.UNSTITCH_MESSY
            if messy2 and clean1:
                cls = (PairClassification.UNSTITCH_REVERSE_MESSY
                       if f.reverse[i2]
                       else PairClassification.UNSTITCH_FORWARD_MESSY)
            elif messy1 and clean2:
                cls = (PairClassification.UNSTITCH_REVERSE_MESSY
                       if f.reverse[i1]
                       else PairClassification.UNSTITCH_FORWARD_MESSY)
        return _messy_suspicious(cls, int(f.mapq[i1]), int(f.mapq[i2]), False)

    if nm1 >= NM_MESSY or nm2 >= NM_MESSY:
        cls = PairClassification.UNSTITCH_MESSY
        if nm1 <= 1 or nm2 <= 1:
            messy = i2 if nm1 <= 1 else i1
            cls = (PairClassification.UNSTITCH_REVERSE_MESSY
                   if f.reverse[messy]
                   else PairClassification.UNSTITCH_FORWARD_MESSY)
        return _messy_suspicious(cls, int(f.mapq[i1]), int(f.mapq[i2]), False)
    if nm1 + nm2 == 0:
        return PairClassification.UNSTITCH_PERFECT
    if nm1 <= 1 and nm2 <= 1:
        return PairClassification.UNSTITCH_SINGLE_MISMATCH
    return PairClassification.UNSTITCH_IMPERFECT


def _normal_orientation(batch: ReadBatch, i: int) -> bool:
    """FR-orientation test (ReadPair.cs:108-132): mates on opposite strands
    and the forward mate leftmost (RF is abnormal)."""
    from pisces_tpu_torch.io.bam import FLAG_MATE_REVERSE, FLAG_REVERSE
    flag = int(batch.flag[i])
    rev = bool(flag & FLAG_REVERSE)
    mate_rev = bool(flag & FLAG_MATE_REVERSE)
    if rev == mate_rev:
        return False
    if batch.mate_ref_id is None or batch.mate_pos is None:
        return True
    if int(batch.ref_id[i]) != int(batch.mate_ref_id[i]):
        return True
    pos = int(batch.pos[i])
    mate_pos = int(batch.mate_pos[i])
    if not rev and pos > mate_pos:
        return False  # RF
    if rev and mate_pos > pos:
        return False  # RF
    return True


def classify_batch(batch: ReadBatch, ref_codes: np.ndarray,
                   read_names: List[str],
                   min_map_quality: int = 10,
                   trust_softclips: bool = False,
                   check_md: bool = False,
                   abnormal_as_improper: bool = False
                   ) -> Dict[int, PairClassification]:
    """Classification for every primary read, keyed by read index; both
    mates of a pair share the pair's classification.

    check_md enables the UnstitchMessySuspiciousMd upgrade for messy pairs
    (active in the reference only when SilenceSuspiciousMdReads is set —
    TaskFactory.cs:53 passes checkMd: GeminiOptions.SilenceSuspiciousMdReads)."""
    f = extract_features(batch, ref_codes)
    md = compute_md_stats(batch, ref_codes) if check_md else None
    by_name: Dict[str, List[int]] = {}
    for i in range(batch.n):
        if f.paired[i] and f.primary[i]:
            by_name.setdefault(read_names[i], []).append(i)
    out: Dict[int, PairClassification] = {}
    for i in range(batch.n):
        if not f.primary[i]:
            out[i] = PairClassification.UNUSABLE
            continue
        if not f.paired[i]:
            out[i] = classify_pair(f, i, None, min_map_quality,
                                   trust_softclips)
    for name, members in by_name.items():
        members.sort(key=lambda i: int(f.pos[i]))
        if len(members) == 2:
            cls = classify_pair(f, members[0], members[1], min_map_quality,
                                trust_softclips)
            if (md is not None
                    and cls in (PairClassification.UNSTITCH_MESSY,
                                PairClassification.UNSTITCH_MESSY_SUSPICIOUS_READ)
                    and has_suspicious_md(md, f, members[0], members[1])):
                cls = PairClassification.UNSTITCH_MESSY_SUSPICIOUS_MD
            out[members[0]] = cls
            out[members[1]] = cls
        else:
            for i in members:
                out[i] = classify_pair(f, i, None, min_map_quality,
                                       trust_softclips,
                                       abnormal_as_improper=
                                       abnormal_as_improper,
                                       batch=batch)
    return out
