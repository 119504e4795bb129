"""Targeted indel realignment: the Gemini realignment engine.

Port of the FromHygea realignment stack:
  - position-map realignment: the read is laid out fresh (all-M, softclips
    unrolled, terminal Ns held out) from the clip-adjusted position, and
    candidate indels are layered onto the position map from the left and
    right anchors (GeminiReadRealigner.cs:18-869, ReadToRealignDetails.cs)
  - insertion-sequence verification with bounded Hamming mismatch N-ifying
    for long insertions (GeminiReadRealigner.cs:395-458)
  - partial/unanchored insertion masking (MaskPartialInsertion)
  - softclip reapplication after realignment: terminal Ns re-clipped,
    original softclips re-masked at mismatches with edge-match rescue
    (SoftclipReapplier.cs:1-130, Helper.SoftclipCigar:372-561)
  - quality-aware alignment comparison (GemBasicAlignmentComparer.cs:8-271)
  - accept/reject judgment incl. unchanged detection and confirmation of
    existing indels (RealignmentJudger.cs, RealignmentEvaluator.cs:50-591)

The alignment summary and the per-anchor realignment run in the native
library (io/_native/stitch.cpp aln_summary, io/_native/realign.cpp
realign_anchor); a library that cannot be built raises. Their Python
versions below are the plain versions, reached when a caller sets
USE_NATIVE_SUMMARY or USE_NATIVE_REALIGN to False (the tests compare the
two), or for one read the native code refuses (a sequence whose length is
not the CIGAR's read span, or a realignment over its 4096-entry buffers).
"""
from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pisces_tpu_torch.preprocessing.indels import (
    ChromosomeIndelSource, HashableIndel, PreIndel, hamming_mismatches,
    is_match,
)

OP_M, OP_I, OP_D, OP_N, OP_S = 0, 1, 2, 3, 4
_READ_SPAN = (OP_M, OP_I, OP_S, 7, 8)
_REF_SPAN = (OP_M, OP_D, OP_N, 7, 8)

# MatchType codes (Helper.GetMismatchMap)
MT_NONE, MT_MISMATCH, MT_NMISMATCH, MT_UNMAPPED = 0, 1, 2, 3

VERY_MESSY_THRESHOLD = 20


# ---------------------------------------------------------------------------
# alignment summaries
# ---------------------------------------------------------------------------

@dataclass
class AlignmentSummary:
    """AlignmentSummary (ReadRealignmentLogic/Models/AlignmentSummary.cs)."""
    num_matches: int = 0
    num_mismatches: int = 0
    num_mismatches_incl_softclip: int = 0
    num_indels: int = 0
    num_inserted_bases: int = 0
    num_deleted_bases: int = 0
    num_indel_bases: int = 0
    num_softclips: int = 0
    num_non_n_softclips: int = 0
    anchor_length: int = 0
    cigar: List[Tuple[int, int]] = field(default_factory=list)
    sum_of_mismatching_qualities: Optional[int] = None


@dataclass
class RealignmentResult(AlignmentSummary):
    position: int = 0            # 1-based
    accepted_indels: List[int] = field(default_factory=list)
    accepted_hashables: List[HashableIndel] = field(default_factory=list)
    nified_at: List[int] = field(default_factory=list)
    indels_added_at: List[int] = field(default_factory=list)
    is_sketchy: bool = False


USE_NATIVE_SUMMARY = True  # tests set False to run the Python summary
_ref_bytes_cache: "OrderedDict[tuple, bytes]" = OrderedDict()
_ref_bytes_lock = threading.Lock()


def _get_native():
    """The port's native library, built at first use; raises if it cannot
    be built (its ctypes signatures are set by io/native.get_lib)."""
    from pisces_tpu_torch.io.native import get_lib
    return get_lib()


def _ref_bytes(refseq_str: str) -> bytes:
    """Per-chromosome encode cache (the str is megabytes; the same object
    is passed for thousands of summary calls). Keyed by
    (id, len, head, tail) so id reuse after GC cannot serve stale bytes."""
    key = (id(refseq_str), len(refseq_str), refseq_str[:32], refseq_str[-32:])
    with _ref_bytes_lock:
        b = _ref_bytes_cache.get(key)
        if b is None:
            b = refseq_str.encode("latin-1")
            _ref_bytes_cache[key] = b
            while len(_ref_bytes_cache) > 4:
                _ref_bytes_cache.popitem(last=False)
    return b


def _summary_native(lib, start_ref0: int, cigar, refseq_str: str,
                    read_seq: str, check_sc: bool
                    ) -> Optional[AlignmentSummary]:
    n = len(cigar)
    ops = np.fromiter((c[0] for c in cigar), np.uint8, count=n)
    lens = np.fromiter((c[1] for c in cigar), np.int32, count=n)
    out = np.empty(10, np.int32)
    rb = _ref_bytes(refseq_str)
    rc = lib.aln_summary(
        rb, len(rb), start_ref0, ctypes.c_void_p(ops.ctypes.data),
        ctypes.c_void_p(lens.ctypes.data), n, read_seq.encode("latin-1"),
        int(check_sc), ctypes.c_void_p(out.ctypes.data))
    if rc != 0:
        return None
    s = AlignmentSummary()
    s.cigar = list(cigar)
    (s.num_matches, s.num_mismatches, s.num_mismatches_incl_softclip,
     s.num_indels, s.num_inserted_bases, s.num_deleted_bases,
     s.num_indel_bases, s.num_softclips, s.num_non_n_softclips,
     s.anchor_length) = (int(x) for x in out)
    return s


def get_alignment_summary(start_ref0: int, cigar, refseq_str: str,
                          read_seq: str,
                          check_softclips_for_mismatches: bool = True
                          ) -> Optional[AlignmentSummary]:
    """Extensions.GetAlignmentSummary (ReadRealignmentLogic/Utlity/
    Extensions.cs:18-179). start_ref0 is the 0-based reference index of the
    first aligned base (prefix clips are walked backwards from there when
    checking softclips for mismatches)."""
    if USE_NATIVE_SUMMARY and isinstance(refseq_str, str) \
            and len(read_seq) == sum(
                ln for op, ln in cigar if op in _READ_SPAN):
        return _summary_native(_get_native(), start_ref0, cigar, refseq_str,
                               read_seq, check_softclips_for_mismatches)
    s = AlignmentSummary()
    s.cigar = list(cigar)
    ref_i = start_ref0
    if check_softclips_for_mismatches:
        ref_i -= _prefix_clip(cigar)
    read_i = 0
    anchor = 0
    end_anchor = 0
    hit_non_match = False
    hit_non_n_softclip = False
    for op, ln in cigar:
        if op == OP_S:
            for i in range(ln):
                s.num_softclips += 1
                b = read_seq[read_i + i]
                if b != "N" or hit_non_n_softclip:
                    hit_non_n_softclip = True
                    s.num_non_n_softclips += 1
                    if check_softclips_for_mismatches:
                        p = ref_i + i
                        if p < 0 or p >= len(refseq_str):
                            s.num_mismatches_incl_softclip += 1
                        elif b != refseq_str[p] and b != "N":
                            s.num_mismatches_incl_softclip += 1
        elif op in (OP_M, 7, 8):
            for i in range(ln):
                if ref_i + i > len(refseq_str) - 1:
                    return None
                if ref_i + i < 0:
                    return None
                b = read_seq[read_i + i]
                if b != "N" and b != refseq_str[ref_i + i]:
                    s.num_mismatches += 1
                    s.num_mismatches_incl_softclip += 1
                    hit_non_match = True
                    end_anchor = 0
                else:
                    if b != "N":
                        s.num_matches += 1
                    if not hit_non_match:
                        anchor += 1
                    end_anchor += 1
        elif op == OP_I:
            hit_non_match = True
            end_anchor = 0
            s.num_indels += 1
            s.num_indel_bases += ln
            s.num_inserted_bases += ln
        elif op in (OP_D, OP_N):
            hit_non_match = True
            end_anchor = 0
            s.num_indels += 1
            s.num_indel_bases += ln
            s.num_deleted_bases += ln
        if op in _READ_SPAN:
            read_i += ln
        if op in _REF_SPAN:
            ref_i += ln
        if check_softclips_for_mismatches and op == OP_S:
            ref_i += ln
    s.anchor_length = min(anchor, end_anchor)
    return s


def _prefix_clip(cigar) -> int:
    n = 0
    for op, ln in cigar:
        if op == OP_S:
            n += ln
        elif op != 5:
            break
    return n


def _suffix_clip(cigar) -> int:
    n = 0
    for op, ln in reversed(list(cigar)):
        if op == OP_S:
            n += ln
        elif op != 5:
            break
    return n


def _read_span(cigar) -> int:
    return sum(ln for op, ln in cigar if op in _READ_SPAN)


# ---------------------------------------------------------------------------
# position-map helpers
# ---------------------------------------------------------------------------

def position_map_from_cigar(pos1: int, cigar) -> np.ndarray:
    """1-based per-read-base reference positions; -1 for S/I."""
    out = np.empty(_read_span(cigar), dtype=np.int64)
    i = 0
    ref = pos1
    for op, ln in cigar:
        if op in (OP_M, 7, 8):
            out[i:i + ln] = np.arange(ref, ref + ln)
            i += ln
            ref += ln
        elif op in (OP_I, OP_S):
            out[i:i + ln] = -1
            i += ln
        elif op in (OP_D, OP_N):
            ref += ln
    return out


def construct_cigar(position_map: np.ndarray,
                    soft_clip: bool = False) -> List[Tuple[int, int]]:
    """Helper.ConstructCigar (Helper.cs:563-624)."""
    out: List[Tuple[int, int]] = []
    last_ref = -1
    last_op = None
    last_len = 0
    for p in position_map:
        p = int(p)
        op = OP_I if p < 0 else OP_M
        if op == OP_M:
            if last_ref != -1 and p > last_ref + 1:
                out.append((last_op, last_len))
                out.append((OP_D, p - last_ref - 1))
                last_op, last_len = OP_D, 0
            last_ref = p
        if op != last_op:
            if last_op is not None and last_op != OP_D:
                out.append((last_op, last_len))
            last_op, last_len = op, 1
        else:
            last_len += 1
    out.append((last_op, last_len))
    if soft_clip:
        if out and out[0][0] != OP_M:
            out[0] = (OP_S, out[0][1])
        if out and out[-1][0] != OP_M:
            out[-1] = (OP_S, out[-1][1])
    return out


def get_mismatch_map(read_seq: str, position_map: np.ndarray,
                     refseq_str: str) -> Optional[List[int]]:
    """Helper.GetMismatchMap (Helper.cs:626-672)."""
    out = [MT_NONE] * len(read_seq)
    for i in range(len(position_map)):
        p = int(position_map[i])
        if p < 0:
            out[i] = MT_NMISMATCH if read_seq[i] == "N" else MT_UNMAPPED
            continue
        if p > len(refseq_str):
            return None
        if p - 1 >= 0:
            rb = refseq_str[p - 1]
            b = read_seq[i]
            if rb != "N" and b != "N" and rb != b:
                out[i] = MT_MISMATCH
            elif rb == "N" or b == "N":
                out[i] = MT_NMISMATCH
        else:
            out[i] = MT_UNMAPPED
    return out


def sum_mismatch_quals(mismatch_map: Sequence[int], quals) -> int:
    return sum(int(quals[i]) for i, m in enumerate(mismatch_map)
               if m == MT_MISMATCH)


def softclip_cigar(raw_cigar, mismatch_map: Sequence[int],
                   orig_prefix_clip: int, orig_suffix_clip: int,
                   rescue_edge_matches: bool = True,
                   mask_ns_only: bool = False, prefix_ns: int = 0,
                   suffix_ns: int = 0, softclip_even_if_match: bool = False,
                   softclip_represents_mess: bool = True,
                   allow_one_softclip_mismatch_per: float = 12.0
                   ) -> List[Tuple[int, int]]:
    """Helper.SoftclipCigar (Helper.cs:372-561): re-mask original softclip
    regions that realignment turned into (mismatching) Ms."""
    if orig_prefix_clip == 0 and orig_suffix_clip == 0:
        return list(raw_cigar)
    expanded: List[int] = []
    for op, ln in raw_cigar:
        expanded.extend([op] * ln)
    changed = False

    first_non_ms = next((i for i, o in enumerate(expanded)
                         if o not in (OP_M, OP_S)), len(expanded) - 1)
    last_non_ms = next((len(expanded) - 1 - i
                        for i, o in enumerate(reversed(expanded))
                        if o not in (OP_M, OP_S)), 0)
    max_prefix = min(first_non_ms + 1, orig_prefix_clip)
    max_suffix = min(len(expanded) - last_non_ms, orig_suffix_clip)

    min_mism_prefix = orig_prefix_clip / allow_one_softclip_mismatch_per
    min_mism_suffix = orig_suffix_clip / allow_one_softclip_mismatch_per

    mmi = orig_prefix_clip
    n_mism = 0
    tmp = mmi
    for _ in range(max_prefix):
        tmp -= 1
        if mismatch_map[tmp] in (MT_MISMATCH, MT_NMISMATCH):
            n_mism += 1
    prefix_too_messy = n_mism > min_mism_prefix

    started = False
    prev_op = OP_N
    prev_prev_op = OP_N
    for i in range(max_prefix):
        index = max_prefix - 1 - i
        mmi -= 1
        op_at = expanded[index]
        if op_at != OP_M:
            prev_op = op_at
            continue
        if mask_ns_only:
            should = index < prefix_ns
        else:
            should = (softclip_even_if_match or not rescue_edge_matches
                      or started or prefix_too_messy)
            if not should and mismatch_map[mmi] in (MT_MISMATCH, MT_NMISMATCH):
                should = True
            if prev_op in (OP_D, OP_I) or (softclip_represents_mess
                                           and prev_prev_op in (OP_D, OP_I)):
                should = False
        if should:
            changed = True
            started = True
            expanded[index] = OP_S
        prev_prev_op = prev_op
        prev_op = op_at

    started = False
    read_span = sum(1 for o in expanded if o in (OP_M, OP_I, OP_S))
    mmi = len(mismatch_map) - max_suffix - 1
    n_mism = 0
    tmp = mmi
    for _ in range(max_suffix):
        tmp += 1
        if mismatch_map[tmp] in (MT_MISMATCH, MT_NMISMATCH):
            n_mism += 1
    suffix_too_messy = n_mism > min_mism_suffix
    prev_op = OP_N
    for i in range(max_suffix):
        index = len(expanded) - (max_suffix - i)
        mmi += 1
        op_at = expanded[index]
        if op_at != OP_M:
            prev_op = op_at
            continue
        if mask_ns_only:
            should = suffix_ns > 0 and mmi >= read_span - suffix_ns
        else:
            should = not rescue_edge_matches or started or suffix_too_messy
            if not should and mismatch_map[mmi] in (MT_MISMATCH, MT_NMISMATCH):
                should = True
            if prev_op in (OP_D, OP_I):
                should = False
        if should:
            changed = True
            started = True
            expanded[index] = OP_S
        prev_op = op_at

    if not any(o == OP_M for o in expanded):
        first_non_s = next((i for i, o in enumerate(expanded) if o != OP_S),
                           len(expanded))
        expanded[first_non_s - 1] = OP_M
    if not changed:
        return list(raw_cigar)
    out: List[Tuple[int, int]] = []
    for o in expanded:
        if out and out[-1][0] == o:
            out[-1] = (o, out[-1][1] + 1)
        else:
            out.append((o, 1))
    return out


# ---------------------------------------------------------------------------
# comparers + judger
# ---------------------------------------------------------------------------

class GemBasicAlignmentComparer:
    """GemBasicAlignmentComparer (FromHygea/GemBasicAlignmentComparer.cs)."""

    def __init__(self, trust_softclips: bool = False):
        self._trust_softclips = trust_softclips

    def compare_alignments(self, original: AlignmentSummary,
                           other: Optional[AlignmentSummary]) -> int:
        if other is None:
            return 1
        if other.num_mismatches > original.num_mismatches + 3:
            return 1
        if (original.num_mismatches == 1 and original.num_indels == 0
                and other.num_indels > 1):
            return 1
        if (other.num_mismatches == 1 and other.num_indels == 0
                and original.num_indels > 1):
            return -1
        o_sc = original.num_mismatches_incl_softclip
        n_sc = other.num_mismatches_incl_softclip
        if o_sc < 5 and o_sc < n_sc:
            return 1
        if o_sc >= 5 and o_sc < n_sc * 0.8:
            return 1
        if o_sc > n_sc + 1:
            return -1
        if original.num_indel_bases == other.num_indel_bases:
            if (original.num_indels == 1 and other.num_indels > 1
                    and original.num_mismatches <= 2):
                return 1
            if (other.num_indels == 1 and original.num_indels > 1
                    and other.num_mismatches <= 2):
                return -1
            if (original.num_mismatches > 0 and other.num_mismatches > 0
                    and original.num_mismatches <= 5
                    and other.num_mismatches <= 5):
                if (original.sum_of_mismatching_qualities is not None
                        and other.sum_of_mismatching_qualities is not None):
                    if (original.sum_of_mismatching_qualities
                            <= other.sum_of_mismatching_qualities):
                        return 1
                    return -1
        if o_sc > 0 and n_sc == 0:
            return -1
        if original.num_indels < other.num_indels:
            return 1
        if original.num_indels > other.num_indels:
            return -1
        return 0

    def get_better_result(self, r1: Optional[RealignmentResult],
                          r2: Optional[RealignmentResult]
                          ) -> Optional[RealignmentResult]:
        if r1 is None:
            return r2
        if r2 is None:
            return r1
        return r1 if self.compare_alignments(r1, r2) >= 0 else r2

    def compare_with_original(self, other: AlignmentSummary,
                              original: Optional[AlignmentSummary],
                              treat_kindly: bool = False) -> int:
        if treat_kindly and original is not None:
            if (other.num_mismatches <= 1
                    and other.num_mismatches_incl_softclip
                    <= original.num_mismatches_incl_softclip):
                return 1
        return self._compare_with_original2(other, original)

    def _compare_with_original2(self, other: AlignmentSummary,
                                original: Optional[AlignmentSummary]) -> int:
        if original is None:
            return 1
        if other.num_mismatches > original.num_mismatches + 3:
            return -1
        if (other.num_mismatches + other.num_softclips + other.num_indel_bases
                == original.num_mismatches + original.num_softclips
                + original.num_indel_bases):
            if other.num_deleted_bases < 3 and other.num_inserted_bases == 0:
                return -1
        o_sc = original.num_mismatches_incl_softclip
        n_sc = other.num_mismatches_incl_softclip
        if n_sc == 0:
            if (other.num_indels == 1 and other.num_indel_bases == 1
                    and o_sc == 1 and original.num_indels == 0):
                return -1
            if original.num_indels > 0:
                return 1
            if o_sc - n_sc >= 1:
                return 1
            return -1
        if (original.num_mismatches > 2
                and other.num_mismatches - original.num_mismatches <= 2
                and other.num_indels - original.num_indels <= 2
                and other.num_indel_bases > 10
                and (other.num_mismatches < original.num_mismatches
                     or n_sc < o_sc * 0.9
                     or other.num_softclips < original.num_softclips)):
            return 1
        if (other.num_indel_bases <= 2
                and other.num_indel_bases > original.num_indel_bases
                and other.num_mismatches >= original.num_mismatches - 1
                and (o_sc > 10
                     and ((not self._trust_softclips
                           and original.num_softclips * 0.8
                           <= other.num_softclips)
                          or o_sc - n_sc <= o_sc / 5))):
            return -1
        if o_sc > 10 and o_sc - n_sc <= o_sc / 10:
            return -1
        super_long = 20
        if (original.num_softclips > super_long
                and ((other.num_softclips / float(original.num_softclips)
                      >= 0.75
                      and other.num_mismatches >= original.num_mismatches)
                     or (other.num_matches - original.num_matches)
                     < (original.num_softclips - other.num_softclips) / 2.0)):
            return -1
        if (original.num_mismatches - other.num_mismatches <= 0
                and other.num_matches - original.num_matches <= 2
                and other.num_indels >= original.num_indels
                and o_sc - n_sc <= 2):
            return -1
        if (other.num_mismatches > original.num_mismatches
                and n_sc > o_sc * 0.75 and other.anchor_length < 3):
            return -1
        num_shared = min(o_sc, n_sc)
        if other.num_indel_bases <= 3 and (original.num_indel_bases == 0
                                           or original.num_indel_bases > 3):
            if n_sc - num_shared == 0 and o_sc - n_sc >= 2:
                return 1
            if n_sc - o_sc <= 1:
                return 1
            return -1
        if n_sc - num_shared <= 2:
            if o_sc - n_sc >= 1:
                return 1
        return -1 * self.compare_alignments(original, other)


class RealignmentJudger:
    """RealignmentJudger (FromHygea/RealignmentJudger.cs)."""

    def __init__(self, comparer: GemBasicAlignmentComparer):
        self._comparer = comparer

    @staticmethod
    def realignment_is_unchanged(result: RealignmentResult, orig_pos1: int,
                                 orig_cigar) -> bool:
        if result.position != orig_pos1:
            return False
        return list(result.cigar) == list(orig_cigar)

    def better_or_equal(self, result: RealignmentResult,
                        original: AlignmentSummary,
                        is_pair_aware: bool) -> bool:
        return self._comparer.compare_with_original(result, original,
                                                    is_pair_aware) >= 0

    @staticmethod
    def is_very_confident(summary: AlignmentSummary) -> bool:
        return summary.anchor_length > 10 and summary.num_mismatches <= 1


# ---------------------------------------------------------------------------
# the realigner
# ---------------------------------------------------------------------------

def _n_prefix(seq: str) -> int:
    n = 0
    for c in seq:
        if c != "N":
            break
        n += 1
    return n


def _n_suffix(seq: str) -> int:
    n = 0
    for c in reversed(seq):
        if c != "N":
            break
        n += 1
    return n


def _mono_repeat_prefix(seq: str) -> int:
    best = 0
    for nuc in "ACTG":
        n = 0
        for c in seq:
            if c == nuc or c == "N":
                n += 1
            else:
                break
        best = max(best, n)
    return best


def _mono_repeat_suffix(seq: str) -> int:
    return _mono_repeat_prefix(seq[::-1])


@dataclass
class _Details:
    position: int
    n_prefix: int
    n_suffix: int
    prefix_softclip: int
    suffix_softclip: int
    seq: str          # without terminal Ns
    pmap: np.ndarray  # fresh all-M position map for seq


USE_NATIVE_REALIGN = True  # tests set False to run the Python realigner
_realign_tls = threading.local()


class _RealignCtx:
    """Per-thread preallocated output buffers for realign_anchor."""

    CAP = 4096

    def __init__(self):
        self.out_ops = np.empty(self.CAP, np.uint8)
        self.out_lens = np.empty(self.CAP, np.int32)
        self.out_nc = np.empty(1, np.int32)
        self.counters = np.empty(13, np.int64)
        self.out_added = np.empty(self.CAP, np.int32)
        self.out_n_added = np.empty(1, np.int32)
        self.out_nified = np.empty(self.CAP, np.int32)
        self.out_n_nified = np.empty(1, np.int32)


def _realign_ctx() -> "_RealignCtx":
    ctx = getattr(_realign_tls, "ctx", None)
    if ctx is None:
        ctx = _RealignCtx()
        _realign_tls.ctx = ctx
    return ctx


class GeminiReadRealigner:
    def __init__(self, comparer: GemBasicAlignmentComparer,
                 remask_softclips: bool = True,
                 mask_partial_insertion: bool = False,
                 keep_probe_softclips: bool = False,
                 keep_both_side_softclips: bool = False,
                 mask_ns_only: bool = True,
                 min_insertion_size_to_allow_mismatching: int = 5,
                 max_proportion_insert_mismatch: float = 0.2,
                 minimum_unanchored_insertion_length: int = 0):
        self._comparer = comparer
        self._remask = remask_softclips
        self._mask_partial_insertion = mask_partial_insertion
        self._keep_probe = keep_probe_softclips
        self._keep_both = keep_both_side_softclips
        if keep_probe_softclips or keep_both_side_softclips:
            mask_ns_only = False
        self._mask_ns_only = mask_ns_only
        self._min_ins_mismatch = min_insertion_size_to_allow_mismatching
        self._max_prop_ins_mismatch = max_proportion_insert_mismatch
        self._min_unanchored_ins = minimum_unanchored_insertion_length

    # -- read layout -------------------------------------------------------

    def _adjusted_position(self, pos1: int, cigar, seq: str,
                           anchor_left: bool, is_reverse: bool,
                           is_paired: bool) -> int:
        """Read.GetAdjustedPosition (Extensions.cs:181-232), skipNs=True."""
        n_pre = _n_prefix(seq)
        n_suf = _n_suffix(seq)
        probe_prefix = 0
        if self._keep_probe:
            if (self._keep_both or not is_reverse or not is_paired) \
                    and n_pre == 0:
                probe_prefix = _prefix_clip(cigar)
        if anchor_left:
            adj = pos1 - _prefix_clip(cigar)
            if cigar and cigar[0][0] == OP_I:
                adj -= cigar[0][1]
            if len(cigar) >= 2 and cigar[0][0] == OP_S \
                    and cigar[1][0] == OP_I:
                adj -= cigar[1][1]
            return adj + n_pre + probe_prefix
        pmap = position_map_from_cigar(pos1, cigar)
        mapped = np.nonzero(pmap >= 0)[0]
        if len(mapped) == 0:
            return -1
        idx_max = int(mapped[-1])
        max_ref = int(pmap[idx_max])
        adj_max = max_ref + (len(pmap) - n_suf - (idx_max + 1))
        return adj_max - (len(seq) - n_pre - n_suf) + 1 + probe_prefix

    def _details(self, pos1: int, cigar, seq: str, anchor_left: bool,
                 is_reverse: bool, is_paired: bool) -> Optional[_Details]:
        n_pre = _n_prefix(seq)
        n_suf = _n_suffix(seq)
        if self._keep_probe:
            if self._keep_both or ((not is_reverse or not is_paired)
                                   and n_pre == 0):
                n_pre = max(n_pre, _prefix_clip(cigar))
            if self._keep_both or ((is_reverse or not is_paired)
                                   and n_suf == 0):
                n_suf = max(n_suf, _suffix_clip(cigar))
        pos = self._adjusted_position(pos1, cigar, seq, anchor_left,
                                      is_reverse, is_paired)
        if not anchor_left and pos < 0:
            return None
        mid_len = len(seq) - n_pre - n_suf
        if mid_len <= 0:
            return None
        pmap = np.arange(pos, pos + mid_len, dtype=np.int64)
        return _Details(pos, n_pre, n_suf, _prefix_clip(cigar),
                        _suffix_clip(cigar), seq[n_pre:len(seq) - n_suf],
                        pmap)

    # -- indel layering ------------------------------------------------------

    def _add_indel(self, seq: str, indel: HashableIndel, anchor_left: bool,
                   pmap: np.ndarray, refseq_str: str, pair_specific: bool
                   ) -> Optional[RealignmentResult]:
        """AddIndelAndGetResult (GeminiReadRealigner.cs:179-505)."""
        found = False
        ins_start = -1
        ins_end = -1
        del_pos = -1
        any_after_del = False
        n = len(pmap)

        if anchor_left:
            for i in range(n):
                if int(pmap[i]) == indel.position and i != n - 1:
                    found = True
                    if indel.is_insertion:
                        ins_start = i + 1
                        for j in range(i + 1, n):
                            if j - i <= indel.length:
                                pmap[j] = -1
                                if j - i == indel.length or j == n - 1:
                                    ins_end = j
                            else:
                                if pmap[j] != -1:
                                    pmap[j] = pmap[j] - indel.length
                        break
                    else:
                        del_pos = i
                        for j in range(i + 1, n):
                            if pmap[j] != -1:
                                any_after_del = True
                                pmap[j] = pmap[j] + indel.length
                        break
        else:
            if indel.is_insertion:
                for i in range(n - 1, -1, -1):
                    if int(pmap[i]) == indel.position + 1 and i != 0:
                        found = True
                        ins_end = i - 1
                    elif int(pmap[i]) == indel.position and i != n - 1:
                        found = True
                        ins_end = i
                    if found:
                        for j in range(ins_end, -1, -1):
                            if ins_end - j + 1 <= indel.length:
                                pmap[j] = -1
                                if (ins_end - j + 1 == indel.length
                                        or j == 0):
                                    ins_start = j
                            else:
                                if pmap[j] != -1:
                                    pmap[j] = pmap[j] + indel.length
                        break
            else:
                for i in range(n - 1, 0, -1):
                    if int(pmap[i]) == indel.position + indel.length + 1:
                        found = True
                        del_pos = i - 1
                        for j in range(i - 1, -1, -1):
                            if pmap[j] != -1:
                                any_after_del = True
                                pmap[j] = pmap[j] - indel.length
                        break

        if not found or (not indel.is_insertion and not any_after_del) \
                or not (pmap >= 0).any():
            return None

        is_sketchy = False
        if indel.is_repeat and indel.repeat_unit:
            anchor_length = (min(ins_start, len(seq) - ins_end)
                             if indel.is_insertion
                             else min(del_pos, len(seq) - del_pos))
            if anchor_length < max(10, indel.length):
                if not indel.is_insertion:
                    if _deletion_has_sketchy_anchor(seq, indel, del_pos):
                        if pair_specific:
                            is_sketchy = True
                        else:
                            return None
                else:
                    if indel.num_bases_in_ref_suffix_before_unique \
                            >= anchor_length:
                        if pair_specific:
                            is_sketchy = True
                        else:
                            return None

        if not indel.is_insertion:
            anchor_start = del_pos + 1
            right_anchor_len = len(seq) - anchor_start
            if right_anchor_len < indel.length and anchor_start < len(seq):
                if seq[anchor_start:] == \
                        indel.ref_allele[1:1 + right_anchor_len]:
                    return None

        if indel.is_duplication and indel.is_insertion:
            if len(seq) - ins_end <= 3:
                return None

        new_seq = seq
        nified: List[int] = []
        if indel.is_insertion:
            if ins_start == -1 or ins_end == -1:
                return None
            read_ins = seq[ins_start:ins_end + 1]
            indel_seq = indel.alt_allele[1:]
            if anchor_left and len(read_ins) < len(indel_seq) \
                    and indel.num_approx_dups_right > 0:
                return None
            if not anchor_left and len(read_ins) < len(indel_seq) \
                    and indel.num_approx_dups_left > 0:
                return None
            clipped = (indel_seq[:len(read_ins)] if anchor_left
                       else indel_seq[len(indel_seq) - len(read_ins):])
            if read_ins != clipped:
                mismatches = None
                to_dq = 0.0
                if indel.length >= self._min_ins_mismatch and not (
                        indel.num_approx_dups_left
                        + indel.num_approx_dups_right > 0):
                    mismatches = hamming_mismatches(read_ins, clipped)
                    to_dq = indel.length * self._max_prop_ins_mismatch
                    if mismatches is not None and mismatches <= to_dq:
                        merged = []
                        for k, (a, b) in enumerate(zip(clipped, read_ins)):
                            if a == b or a == "N":
                                merged.append(b)
                            else:
                                merged.append("N")
                                nified.append(k)
                        new_seq = (seq[:ins_start] + "".join(merged)
                                   + seq[ins_end + 1:])
                        nified = [x + ins_start for x in nified]
                if mismatches is None or mismatches > to_dq:
                    return None

        new_cigar = construct_cigar(pmap)
        mapped = pmap[pmap > 0]
        if len(mapped) == 0:
            return None
        start_ref = int(mapped[0]) - 1
        summary = get_alignment_summary(start_ref, new_cigar, refseq_str,
                                        new_seq, False)
        if summary is None:
            return None
        r = RealignmentResult(
            position=start_ref + 1, cigar=new_cigar,
            num_indels=sum(1 for op, _l in new_cigar if op in (OP_I, OP_D)),
            num_mismatches=summary.num_mismatches,
            num_softclips=summary.num_softclips,
            num_non_n_softclips=summary.num_non_n_softclips,
            num_deleted_bases=summary.num_deleted_bases,
            num_inserted_bases=summary.num_inserted_bases,
            num_matches=summary.num_matches,
            num_indel_bases=summary.num_indel_bases,
            num_mismatches_incl_softclip=summary.num_mismatches_incl_softclip,
            nified_at=nified,
            indels_added_at=[ins_start if indel.is_insertion else del_pos],
            is_sketchy=is_sketchy)
        return r

    # -- per-anchor orchestration -------------------------------------------

    def _realign_native(self, indels, seq: str, quals, refseq_str: str,
                        anchor_left: bool, details: _Details,
                        pair_specific: bool, indexes):
        """Native fast path for _realign_for_anchor; returns the result,
        None (no realignment), or NotImplemented to use the Python path."""
        if not USE_NATIVE_REALIGN:
            return NotImplemented
        lib = _get_native()
        n = len(indels)
        # string pool: four CONTIGUOUS per-field regions (ref alleles,
        # then alt alleles, then repeat units, then ref suffixes) so each
        # field's offset table satisfies off[k+1] == end of string k
        tables = []
        pieces = []
        cursor = 0
        for field in ("ref_allele", "alt_allele", "repeat_unit",
                      "ref_suffix"):
            t = np.empty(n + 1, np.int64)
            for k, h in enumerate(indels):
                t[k] = cursor
                b = getattr(h, field).encode("latin-1")
                pieces.append(b)
                cursor += len(b)
            t[n] = cursor
            tables.append(t)
        pool = b"".join(pieces)
        ra_t, aa_t, ru_t, rs_t = tables
        pos_a = np.fromiter((h.position for h in indels), np.int64, n)
        len_a = np.fromiter((h.length for h in indels), np.int64, n)
        flg_a = np.fromiter(
            ((1 if h.is_insertion else 0) | (2 if h.is_repeat else 0)
             | (4 if h.is_duplication else 0) for h in indels), np.uint8, n)
        dl_a = np.fromiter((h.num_approx_dups_left for h in indels),
                           np.int64, n)
        dr_a = np.fromiter((h.num_approx_dups_right for h in indels),
                           np.int64, n)
        su_a = np.fromiter((h.num_bases_in_ref_suffix_before_unique
                            for h in indels), np.int64, n)
        rb = _ref_bytes(refseq_str)
        q = np.ascontiguousarray(quals, np.uint8)
        ctx = _realign_ctx()
        vp = ctypes.c_void_p

        def P(a):
            return vp(a.ctypes.data)

        rc = lib.realign_anchor(
            rb, len(rb),
            details.position, details.n_prefix, details.n_suffix,
            details.prefix_softclip, details.suffix_softclip,
            seq.encode("latin-1"), P(q), len(seq),
            n, P(pos_a), P(len_a), P(flg_a), P(dl_a), P(dr_a), P(su_a),
            pool, P(ra_t), P(aa_t), P(ru_t), P(rs_t),
            int(anchor_left), int(pair_specific),
            int(self._remask), int(self._mask_partial_insertion),
            int(self._keep_probe), int(self._keep_both),
            int(self._mask_ns_only), self._min_ins_mismatch,
            self._max_prop_ins_mismatch, self._min_unanchored_ins,
            P(ctx.out_ops), P(ctx.out_lens), P(ctx.out_nc),
            P(ctx.counters), P(ctx.out_added), P(ctx.out_n_added),
            P(ctx.out_nified), P(ctx.out_n_nified), ctx.CAP)
        if rc == -1:
            return NotImplemented
        if rc == 0:
            return None
        c = ctx.counters
        nc = int(ctx.out_nc[0])
        order = (list(range(n)) if anchor_left
                 else list(range(n - 1, -1, -1)))
        result = RealignmentResult(
            position=int(c[12]),
            cigar=list(zip(ctx.out_ops[:nc].tolist(),
                           ctx.out_lens[:nc].tolist())),
            num_indels=int(c[0]), num_mismatches=int(c[1]),
            num_softclips=int(c[2]), num_non_n_softclips=int(c[3]),
            num_deleted_bases=int(c[4]), num_inserted_bases=int(c[5]),
            num_matches=int(c[6]), num_indel_bases=int(c[7]),
            num_mismatches_incl_softclip=int(c[8]),
            anchor_length=int(c[9]),
            sum_of_mismatching_qualities=(None if int(c[10]) == -1
                                          else int(c[10])),
            is_sketchy=bool(c[11]),
            nified_at=ctx.out_nified[:int(ctx.out_n_nified[0])].tolist(),
            indels_added_at=ctx.out_added[:int(
                ctx.out_n_added[0])].tolist())
        result.accepted_indels = [indexes[i] for i in order]
        result.accepted_hashables = [indels[i] for i in order]
        return result

    def _realign_for_anchor(self, indels: List[HashableIndel],
                            pos1, cigar, seq, quals, refseq_str: str,
                            anchor_left: bool, details: _Details,
                            pair_specific: bool, indexes: List[int]
                            ) -> Optional[RealignmentResult]:
        nat = self._realign_native(indels, seq, quals, refseq_str,
                                   anchor_left, details, pair_specific,
                                   indexes)
        if nat is not NotImplemented:
            return nat
        pmap = details.pmap.copy()
        result: Optional[RealignmentResult] = None
        accepted_sub: List[int] = []
        added_at: List[int] = []
        nified: List[int] = []
        order = range(len(indels)) if anchor_left \
            else range(len(indels) - 1, -1, -1)
        for i in order:
            result = self._add_indel(details.seq, indels[i], anchor_left,
                                     pmap, refseq_str, pair_specific)
            if result is None:
                return None
            accepted_sub.append(i)
            added_at.extend(result.indels_added_at)
            nified.extend(result.nified_at)
        result.accepted_indels = []
        result.accepted_hashables = []
        result.nified_at = nified
        result.indels_added_at = added_at

        # mask partial/unanchored insertions at read ends
        if self._mask_partial_insertion or self._min_unanchored_ins > 0:
            self._mask_partial(indels, details.seq, refseq_str, result)

        # reapply softclips (terminal Ns + original clip remasking)
        self._reapply_softclips(seq, quals, details, pmap, result, refseq_str)

        for k, sub_i in enumerate(accepted_sub):
            result.accepted_indels.append(indexes[sub_i])
            cur = indels[sub_i]
            result.accepted_hashables.append(cur)
            if not cur.is_insertion:
                added = result.indels_added_at[k]
                anchor_start = added + 1
                last_op = result.cigar[-1]
                right_sc = last_op[1] if last_op[0] == OP_S else 0
                right_anchor_len = len(seq) - anchor_start - right_sc
                if right_anchor_len < cur.length and anchor_start < len(seq) \
                        and right_anchor_len >= 0:
                    if seq[anchor_start:anchor_start + right_anchor_len] == \
                            cur.ref_allele[1:1 + right_anchor_len]:
                        return None

        if result.sum_of_mismatching_qualities is None:
            final_map = self._final_map(details, pmap)
            mm = get_mismatch_map(seq, final_map, refseq_str)
            if mm is not None:
                result.sum_of_mismatching_qualities = \
                    sum_mismatch_quals(mm, quals)
        return result

    @staticmethod
    def _final_map(details: _Details, pmap: np.ndarray) -> np.ndarray:
        return np.concatenate([
            np.full(details.n_prefix, -1, dtype=np.int64), pmap,
            np.full(details.n_suffix, -1, dtype=np.int64)])

    def _mask_partial(self, indels, seq: str, refseq_str: str,
                      result: RealignmentResult) -> None:
        """MaskPartialInsertion (GeminiReadRealigner.cs:697-753)."""
        first = indels[0]
        last = indels[-1]
        if not (first.is_insertion or last.is_insertion):
            return

        def should_mask(op_ln, indel) -> bool:
            op, ln = op_ln
            if op != OP_I:
                return False
            partial = self._mask_partial_insertion and ln < indel.length
            unanchored = indel.length < self._min_unanchored_ins
            return partial or unanchored

        new_cigar = []
        for i, op_ln in enumerate(result.cigar):
            if i == 0 and should_mask(op_ln, first):
                new_cigar.append((OP_S, op_ln[1]))
            elif i == len(result.cigar) - 1 and should_mask(op_ln, last):
                new_cigar.append((OP_S, op_ln[1]))
            else:
                new_cigar.append(op_ln)
        compressed = []
        for op, ln in new_cigar:
            if compressed and compressed[-1][0] == op:
                compressed[-1] = (op, compressed[-1][1] + ln)
            else:
                compressed.append((op, ln))
        result.cigar = compressed

    def _reapply_softclips(self, seq: str, quals, details: _Details,
                           pmap: np.ndarray, result: RealignmentResult,
                           refseq_str: str) -> None:
        """SoftclipReapplier.ReapplySoftclips (SoftclipReapplier.cs:33-129)."""
        final_map = self._final_map(details, pmap)
        final_cigar = []
        if details.n_prefix:
            final_cigar.append((OP_S, details.n_prefix))
        final_cigar.extend(result.cigar)
        if details.n_suffix:
            final_cigar.append((OP_S, details.n_suffix))
        compressed = []
        for op, ln in final_cigar:
            if compressed and compressed[-1][0] == op:
                compressed[-1] = (op, compressed[-1][1] + ln)
            else:
                compressed.append((op, ln))
        result.cigar = compressed

        if not self._remask:
            return
        mm = get_mismatch_map(seq, final_map, refseq_str)
        if mm is None:
            return
        adjusted = softclip_cigar(
            result.cigar, mm, details.prefix_softclip,
            details.suffix_softclip, mask_ns_only=self._mask_ns_only,
            prefix_ns=_n_prefix(seq), suffix_ns=_n_suffix(seq),
            softclip_even_if_match=self._keep_probe or self._keep_both,
            softclip_represents_mess=not (self._keep_probe or self._keep_both))
        pre = _prefix_clip(adjusted)
        for i in range(pre):
            final_map[i] = -2
        suf = _suffix_clip(adjusted)
        for i in range(suf):
            final_map[len(final_map) - 1 - i] = -2

        mm2 = get_mismatch_map(seq, final_map, refseq_str)
        if mm2 is None:
            return
        mapped = final_map[final_map > 0]
        if len(mapped) == 0:
            return
        result.position = int(mapped[0])
        result.cigar = adjusted
        result.num_mismatches = sum(1 for x in mm2 if x == MT_MISMATCH)
        result.indels_added_at = [i + details.n_prefix
                                  for i in result.indels_added_at]
        result.nified_at = [i + details.n_prefix for i in result.nified_at]
        summary = get_alignment_summary(result.position - 1, adjusted,
                                        refseq_str, seq, False)
        if summary is not None:
            result.num_non_n_softclips = summary.num_non_n_softclips
            result.num_softclips = summary.num_softclips
            result.num_inserted_bases = summary.num_inserted_bases
            result.num_mismatches_incl_softclip = \
                summary.num_mismatches_incl_softclip
            result.anchor_length = summary.anchor_length
            result.num_matches = summary.num_matches
        result.sum_of_mismatching_qualities = sum_mismatch_quals(mm, quals)

    # -- top level -----------------------------------------------------------

    @staticmethod
    def _is_unbeatable(r: Optional[RealignmentResult]) -> bool:
        return (r is not None and r.num_indels == 1 and r.num_mismatches == 0
                and r.num_mismatches_incl_softclip == 0)

    @staticmethod
    def can_coexist(i1: HashableIndel, i2: HashableIndel) -> bool:
        """GeminiReadRealigner.CanCoexist: only observed-together multis."""
        if not i1.in_multi or not i2.in_multi:
            return False
        return i1.other_indel == i2.string_rep

    def realign(self, pos1: int, cigar, seq: str, quals,
                ranked_indels: List[HashableIndel], refseq_str: str,
                pair_specific: bool = False, is_reverse: bool = False,
                is_paired: bool = True) -> Optional[RealignmentResult]:
        """GetBestAlignment + final checks (GeminiReadRealigner.cs:62-844)."""
        details = self._details(pos1, cigar, seq, True, is_reverse, is_paired)
        if details is None:
            return None
        details_right = self._details(pos1, cigar, seq, False, is_reverse,
                                      is_paired)

        best: Optional[RealignmentResult] = None
        for i, indel1 in enumerate(ranked_indels):
            r1 = self._realign_to_targets([indel1], [i], pos1, cigar, seq,
                                          quals, refseq_str, details,
                                          details_right, pair_specific)
            best = self._comparer.get_better_result(best, r1)
            if self._is_unbeatable(best):
                break
            for j in range(i + 1, len(ranked_indels)):
                indel2 = ranked_indels[j]
                if not self.can_coexist(indel1, indel2):
                    continue
                pair = sorted(
                    [(indel1, i), (indel2, j)],
                    key=lambda t: (t[0].position, not t[0].is_insertion))
                r2 = self._realign_to_targets(
                    [p[0] for p in pair], [p[1] for p in pair], pos1, cigar,
                    seq, quals, refseq_str, details, details_right,
                    pair_specific)
                best = self._comparer.get_better_result(best, r2)
            if self._is_unbeatable(best):
                break

        if best is not None and best.num_mismatches >= VERY_MESSY_THRESHOLD:
            return None
        if best is not None:
            summary = get_alignment_summary(best.position - 1, best.cigar,
                                            refseq_str, seq, True)
            if summary is None:
                return None
            best.num_mismatches = summary.num_mismatches
            best.num_inserted_bases = summary.num_inserted_bases
            best.num_indel_bases = summary.num_indel_bases
            best.num_non_n_softclips = summary.num_non_n_softclips
            best.num_indels = summary.num_indels
            best.num_matches = summary.num_matches
            best.anchor_length = summary.anchor_length
            best.num_mismatches_incl_softclip = \
                summary.num_mismatches_incl_softclip
            if self._attempted_indel_in_unanchored_repeat(seq, best,
                                                          ranked_indels):
                if pair_specific:
                    best.is_sketchy = True
                else:
                    return None
        return best

    def _realign_to_targets(self, indels, indexes, pos1, cigar, seq, quals,
                            refseq_str, details, details_right,
                            pair_specific) -> Optional[RealignmentResult]:
        left = self._realign_for_anchor(indels, pos1, cigar, seq, quals,
                                        refseq_str, True, details,
                                        pair_specific, indexes)
        if self._is_unbeatable(left):
            return left
        right = None
        if details_right is not None:
            right = self._realign_for_anchor(indels, pos1, cigar, seq, quals,
                                             refseq_str, False, details_right,
                                             pair_specific, indexes)
        return self._comparer.get_better_result(left, right)

    @staticmethod
    def _attempted_indel_in_unanchored_repeat(seq: str,
                                              result: RealignmentResult,
                                              indels: List[HashableIndel]
                                              ) -> bool:
        """AttemptedAddingIndelInUnanchoredRepeat (GeminiReadRealigner.cs:
        137-177)."""
        if not result.indels_added_at or not result.accepted_indels:
            return False
        rpt_prefix = _mono_repeat_prefix(seq)
        if rpt_prefix > 3 and min(result.indels_added_at) <= rpt_prefix:
            return True
        rpt_suffix = _mono_repeat_suffix(seq)
        if rpt_suffix > 3:
            last = indels[result.accepted_indels[-1]] \
                if result.accepted_indels[-1] < len(indels) else None
            if last is None:
                return False
            off = 0 if last.is_insertion else 1
            if (len(seq) - max(result.indels_added_at) - off <= rpt_suffix
                    and rpt_suffix
                    <= last.num_bases_in_ref_suffix_before_unique
                    and seq[len(seq) - rpt_suffix:]
                    == last.ref_suffix[:rpt_suffix]):
                return True
        return False


def _deletion_has_sketchy_anchor(seq: str, indel: HashableIndel,
                                 del_pos: int) -> bool:
    """Helper.DeletionHasSketchyAnchor (Helper.cs:298-369)."""
    unit = indel.repeat_unit
    if not unit:
        return False
    any_non_repeat_right = False
    assessed_right = False
    i = del_pos + 1
    while i < len(seq):
        assessed_right = True
        take = min(len(unit), len(seq) - i)
        if seq[i:i + take] != unit[:take]:
            any_non_repeat_right = True
        i += len(unit)
    any_non_repeat_left = False
    assessed_left = False
    i = del_pos + 1
    while i >= 0:
        if i - 1 < 0:
            break
        if i + len(unit) >= len(seq):
            i -= len(unit)
            continue
        assessed_left = True
        take = min(len(unit), i)
        cmp = unit[len(unit) - take:]
        if seq[i - 1:i - 1 + take] != cmp:
            any_non_repeat_left = True
        i -= len(unit)
    return ((assessed_left and not any_non_repeat_left)
            or (assessed_right and not any_non_repeat_right))


# ---------------------------------------------------------------------------
# the evaluator (accept/reject per read)
# ---------------------------------------------------------------------------

class RealignmentEvaluator:
    """RealignmentEvaluator.GetFinalAlignment (RealignmentEvaluator.cs:50-370),
    without BAM-tag bookkeeping: decides whether a read keeps its alignment,
    is confirmed (already has the best indel), or takes a realignment."""

    def __init__(self, indel_source: ChromosomeIndelSource,
                 realigner: GeminiReadRealigner, judger: RealignmentJudger,
                 refseq_str: str, softclip_unknown_indels: bool = False,
                 pair_aware_everything: bool = False):
        self._source = indel_source
        self._realigner = realigner
        self._judger = judger
        self._ref = refseq_str
        self._softclip_unknown = softclip_unknown_indels
        self._pair_aware_everything = pair_aware_everything
        self.indel_outcomes: Dict[str, List[int]] = {}

    def _outcome(self, h: HashableIndel) -> List[int]:
        # [confirmed, accepted, acceptedOther, rejected] — the snowball
        # predicate reads these (reference outcome slots 5, 6, 7, 1;
        # RealignmentEvaluator.cs UpdateIndelOutcomes/UpdateOutcomeForConfirmed)
        return self.indel_outcomes.setdefault(h.string_rep, [0, 0, 0, 0])

    def get_final_alignment(self, pos1: int, cigar, seq: str, quals,
                            existing_indels: Optional[List[PreIndel]] = None,
                            is_reverse: bool = False, is_paired: bool = True,
                            has_mismatches_or_indels: bool = True,
                            confirmed_accepteds: Optional[
                                List[HashableIndel]] = None):
        """Returns (new_pos1, new_cigar, changed, confirmed, accepted,
        nified_at). new values equal originals when unchanged."""
        if not self._source.any_indels_nearby(pos1):
            return pos1, list(cigar), False, False, [], []
        suspect = any(op in (OP_S, OP_I, OP_D, 8) for op, _l in cigar)
        if not (suspect or has_mismatches_or_indels):
            return pos1, list(cigar), False, False, [], []

        indels = self._source.get_relevant_indels(pos1, existing_indels,
                                                  confirmed_accepteds)
        has_unsanctioned = False
        existing_best = False
        has_very_good = False
        has_hard_to_call = False
        existing_matches: List[PreIndel] = []
        existing_hashables: List[HashableIndel] = []
        confirmed_indel: Optional[HashableIndel] = None
        if indels and existing_indels:
            top = float(max(x.score for x in indels))
            matches_found = 0
            remaining = []
            for idx, h in enumerate(indels):
                matches = [e for e in existing_indels if is_match(e, h)]
                if matches:
                    matches_found += 1
                    if not h.in_multi and idx == 0:
                        existing_best = True
                        confirmed_indel = h
                    if top and h.score / top >= 0.75:
                        has_very_good = True
                    if h.hard_to_call:
                        has_hard_to_call = True
                    existing_matches.extend(matches)
                    existing_hashables.append(h)
                if not matches or h.in_multi:
                    remaining.append(h)
            indels = remaining
            if matches_found == 0:
                has_unsanctioned = True

        if existing_best and confirmed_indel is not None:
            self._outcome(confirmed_indel)[0] += 1
            if confirmed_accepteds is not None:
                confirmed_accepteds.append(confirmed_indel)
            return pos1, list(cigar), False, True, [confirmed_indel], []

        ref_span = sum(ln for op, ln in cigar if op in _REF_SPAN)
        if not indels or ref_span > 500:
            return pos1, list(cigar), False, False, [], []

        pair_aware = bool(confirmed_accepteds) or self._pair_aware_everything
        result = self._realigner.realign(pos1, cigar, seq, quals, indels,
                                         self._ref, pair_specific=pair_aware,
                                         is_reverse=is_reverse,
                                         is_paired=is_paired)

        unchanged = True
        original: Optional[AlignmentSummary] = None
        if result is not None:
            original = get_alignment_summary(pos1 - 1, cigar, self._ref, seq,
                                             True)
            unchanged = self._judger.realignment_is_unchanged(result, pos1,
                                                              cigar)
            if original is not None and original.num_mismatches > 0:
                mm = get_mismatch_map(
                    seq, position_map_from_cigar(pos1, cigar), self._ref)
                if mm is not None:
                    original.sum_of_mismatching_qualities = \
                        sum_mismatch_quals(mm, quals)
            good = False
            if original is not None:
                if unchanged:
                    good = bool(result.nified_at)
                else:
                    good = self._judger.better_or_equal(result, original,
                                                        pair_aware)
            if good:
                accepted_set = set(id(h) for h in result.accepted_hashables)
                for k, h in enumerate(result.accepted_hashables):
                    self._outcome(h)[1] += 1
                # tried indels the accepted realignment did NOT use: the
                # "otherAccepted" outcome (UpdateIndelOutcomes, outcome[7])
                # — snowballing drops indels that keep losing to others
                for h in indels:
                    if id(h) not in accepted_set:
                        self._outcome(h)[2] += 1
                if confirmed_accepteds is not None:
                    confirmed_accepteds.extend(result.accepted_hashables)
                return (result.position, list(result.cigar), True, False,
                        list(result.accepted_hashables),
                        list(result.nified_at))

        if not unchanged:
            for h in indels:
                self._outcome(h)[3] += 1
            confirmed = False
            accepted: List[HashableIndel] = []
            if ((has_very_good or (has_hard_to_call and original is not None
                                   and self._judger.is_very_confident(
                                       original)))
                    and not has_unsanctioned and existing_hashables):
                confirmed = True
                for h in existing_hashables:
                    self._outcome(h)[0] += 1
                    accepted.append(h)
                    if confirmed_accepteds is not None:
                        confirmed_accepteds.append(h)
            return pos1, list(cigar), False, confirmed, accepted, []
        if result is not None:
            # realignment reproduced the original: existing indels confirmed
            for idx in result.accepted_indels:
                if idx < len(indels):
                    self._outcome(indels[idx])[0] += 1
            return pos1, list(cigar), False, True, [], []
        if self._softclip_unknown and has_unsanctioned and existing_indels:
            # realignment failed around an unrecognized indel: optionally
            # softclip the untrusted indel out of the read
            # (RealignmentEvaluator.cs:330-362, SoftclipAfterIndel)
            new_pos, new_cigar = pos1, list(cigar)
            clipped = False
            for pre in sorted((e for e in existing_indels
                               if e not in existing_matches),
                              key=lambda x: x.position):
                reverse_clip = False
                clip_len = pre.right_anchor
                if pre.left_anchor < pre.right_anchor:
                    reverse_clip = True
                    clip_len = pre.left_anchor
                if clip_len > 20:
                    continue  # well-anchored: keep the indel
                new_pos, new_cigar = softclip_after_indel(
                    new_pos, new_cigar, reverse_clip, pre.position)
                clipped = True
            if clipped:
                return new_pos, new_cigar, True, False, [], []
        return pos1, list(cigar), False, False, [], []


def softclip_after_indel(pos1: int, cigar, is_reverse: bool,
                         first_collision: int):
    """OverlappingIndelHelpers.SoftclipAfterIndel (OverlappingIndelHelpers
    .cs:9-94): softclip the read portion outward of an untrusted indel.
    Returns (new_pos1, new_cigar); positions are 1-based."""
    ops = list(cigar)
    hit_indel = False
    hit_match = False
    out = list(ops)
    if is_reverse:
        end_pos = pos1 - 1 + sum(ln for op, ln in ops if op in _REF_SPAN)
        pos_adjust = 0
        for i in range(len(ops) - 1, -1, -1):
            op, ln = ops[i]
            ref_span = op in _REF_SPAN
            if op in (OP_D, OP_I) and \
                    end_pos - (ln if ref_span else 1) <= first_collision - 1:
                hit_indel = True
            elif op == OP_M and not hit_indel:
                hit_match = True
            if hit_indel and hit_match:
                if op not in (OP_S, 5):
                    if ref_span:
                        pos_adjust += ln
                    out[i] = (OP_S, 0 if op == OP_D else ln)
            if ref_span:
                end_pos -= ln
        new_pos1 = pos1 + pos_adjust
    else:
        ref_i = pos1 - 1
        for i, (op, ln) in enumerate(ops):
            if op in (OP_D, OP_I) and ref_i >= first_collision - 1:
                hit_indel = True
            elif op == OP_M and not hit_indel:
                hit_match = True
            if hit_indel and hit_match and op not in (OP_S, 5):
                out[i] = (OP_S, 0 if op == OP_D else ln)
            if op in _REF_SPAN:
                ref_i += ln
        new_pos1 = pos1
    compressed = []
    for op, ln in out:
        if ln == 0:
            continue
        if compressed and compressed[-1][0] == op:
            compressed[-1] = (op, compressed[-1][1] + ln)
        else:
            compressed.append((op, ln))
    return new_pos1, compressed
