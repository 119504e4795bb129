"""Read-pair stitching: merge overlapping R1/R2 into one stitched read.

CigarReconciler-grade port of the StitchingLogic layer:
  - BasicStitcher.TryStitch gates (IsStitchable span check, disagreement
    threshold, homopolymer-bridge rejection)       BasicStitcher.cs:68-211
  - the super-simple fast path for S?M S? cigars   CigarReconciler.cs:91-293
  - the site-by-site dual-cursor reconciliation:
    per-reference-offset StitchedPositions with UnmappedPrefix (S/I) and
    MappedSite (M/D) op lists per read, bookending-softclip redistribution
    across the other read's further-extending ops (softclip-vs-M
    reconciliation, terminal clips supporting overlapping deletions),
    combined-op resolution (S yields to M/I/D), incompatible-insertion and
    empty-gap and internal-softclip rejection      CigarReconciler.cs:434-1328
  - base/quality consensus incl. the reference's disagreement rules
    (agree: summed quality capped at 93; disagree: N-ify, or the
    quality/first-mate winner with "dangerous high-Q disagreement" zeroing)
  - OverlapEvaluator repeat-unit scan              OverlapEvaluator.cs:1-292

The stitched read carries an XD direction string (F/S/R segments) consumed
by the caller's stitched pileup path.

The native stitcher (io/_native/stitch.cpp: stitch_pair, and
stitch_pairs_batch over a columnar ReadBatch) is the path every call takes:
a library that cannot be built raises, as io/native.get_lib() does. The
Python implementation below is its plain version, reached only when a
caller sets USE_NATIVE = False (the tests compare the two), or for one
pair whose input the native code refuses (a CIGAR over 4096 operations, or
a sequence whose length is not the CIGAR's read span).
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field
from itertools import groupby
from typing import List, Optional, Tuple

import numpy as np


MAX_BASE_QUALITY = 93
OP_M, OP_I, OP_D, OP_N, OP_S = 0, 1, 2, 3, 4
_OP_CHAR = {OP_M: "M", OP_I: "I", OP_D: "D", OP_N: "N", OP_S: "S",
            7: "M", 8: "M"}
_CHAR_OP = {"M": OP_M, "I": OP_I, "D": OP_D, "N": OP_N, "S": OP_S}
_READ_SPAN = frozenset("MIS=X")
_REF_SPAN = frozenset("MDN=X")


@dataclass
class StitchedRead:
    pos1: int                 # 1-based position (min of the mates')
    cigar: List[Tuple[int, int]]
    seq: str
    qual: List[int]
    xd: str                   # direction string over expanded read
    num_agreements: int
    num_disagreements: int
    num_n_disagreements: int


# ---------------------------------------------------------------------------
# cigar helpers
# ---------------------------------------------------------------------------

def _chars(cigar) -> List[str]:
    out = []
    for op, ln in cigar:
        out.extend(_OP_CHAR.get(op, "?") * ln)
    return out


def _read_span(cigar) -> int:
    return sum(ln for op, ln in cigar if _OP_CHAR.get(op, "?") in _READ_SPAN)


def _ref_span(cigar) -> int:
    return sum(ln for op, ln in cigar if _OP_CHAR.get(op, "?") in _REF_SPAN)


def _prefix_clip(cigar) -> int:
    n = 0
    for op, ln in cigar:
        if op == OP_S:
            n += ln
        elif op != 5:  # hard clips don't interrupt
            break
    return n


def _suffix_clip(cigar) -> int:
    n = 0
    for op, ln in reversed(cigar):
        if op == OP_S:
            n += ln
        elif op != 5:
            break
    return n


def _compress(expanded: List[str]) -> List[Tuple[str, int]]:
    return [(c, len(list(g))) for c, g in groupby(expanded)]


def _has_internal_softclip(compressed: List[Tuple[str, int]]) -> bool:
    ops = [c for c, _l in compressed]
    for i, c in enumerate(ops):
        if c == "S" and 0 < i < len(ops) - 1:
            return True
    return False


# ---------------------------------------------------------------------------
# StitchingInfo accumulation
# ---------------------------------------------------------------------------

class _Info:
    __slots__ = ("cigar", "dirs", "bases", "quals", "n_disagree", "n_agree",
                 "n_ndis", "is_simple", "overlap_bases",
                 "ignored_probe_prefix", "ignored_probe_suffix")

    def __init__(self):
        self.cigar: List[str] = []       # expanded op chars
        self.dirs: List[str] = []        # expanded F/R/S per op
        self.bases: List[str] = []
        self.quals: List[int] = []
        self.n_disagree = 0
        self.n_agree = 0
        self.n_ndis = 0
        self.is_simple = False
        self.overlap_bases = ""
        self.ignored_probe_prefix = 0
        self.ignored_probe_suffix = 0


# ---------------------------------------------------------------------------
# super-simple fast path (CigarReconciler.GetSuperDuperSimpleStitchedCigar)
# ---------------------------------------------------------------------------

def _simple_components(cigar):
    """(prefixS, M, suffixS) for S?M S? cigars, else None."""
    ops = [(op, ln) for op, ln in cigar if op != 5]
    if len(ops) == 3 and ops[0][0] == OP_S and ops[1][0] == OP_M \
            and ops[2][0] == OP_S:
        return ops[0][1], ops[1][1], ops[2][1]
    if len(ops) == 2:
        if ops[0][0] == OP_S and ops[1][0] == OP_M:
            return ops[0][1], ops[1][1], 0
        if ops[0][0] == OP_M and ops[1][0] == OP_S:
            return 0, ops[0][1], ops[1][1]
    if len(ops) == 1 and ops[0][0] == OP_M:
        return 0, ops[0][1], 0
    return None


def _super_simple(p1, cigar1, seq1, qual1, p2, cigar2, seq2, qual2,
                  r1_is_reverse, r1_is_first_mate, min_bq,
                  nify_disagreements) -> Optional[_Info]:
    super_clean = (len(cigar1) == 1 and len(cigar2) == 1
                   and cigar1[0][0] == OP_M and cigar2[0][0] == OP_M)
    c1 = _simple_components(cigar1)
    c2 = _simple_components(cigar2)
    if c1 is None or c2 is None:
        return None
    sp1, m1, ss1 = c1
    sp2, m2, ss2 = c2
    if ss1 + sp2 > 0:
        return None
    pos_gap = p2 - p1
    if (pos_gap > 0 and pos_gap > m1) or (pos_gap < 0 and -pos_gap > m2):
        return None

    r1_end = p1 + _ref_span(cigar1)
    r2_end = p2 + _ref_span(cigar2)
    if not (p2 < r1_end and r1_end <= r2_end):
        return None
    overlap = r1_end - p2
    r1_len = len(seq1)
    r1_first_overlap = r1_len - overlap
    if (sp1 > 0 and sp1 >= r1_first_overlap) or (ss2 > 0 and m2 < overlap):
        return None
    if overlap <= 0:
        return None
    if not super_clean:
        e1 = _chars(cigar1)
        e2 = _chars(cigar2)
        for i in range(overlap):
            if e1[r1_first_overlap + i] != e2[i]:
                return None

    info = _Info()
    info.is_simple = True
    r1_before = r1_len - overlap
    r2_after = len(seq2) - overlap
    s1o = seq1[r1_first_overlap:r1_first_overlap + overlap]
    s2o = seq2[:overlap]
    q1o = [int(x) for x in qual1[r1_before:r1_before + overlap]]
    q2o = [int(x) for x in qual2[:overlap]]
    # summed agreement quality first (ReadMerger rules); disagreeing
    # positions — usually none — are then patched individually
    out_q = [min(a + b, MAX_BASE_QUALITY) for a, b in zip(q1o, q2o)]
    if s1o == s2o:
        info.n_agree = overlap
        stitched_s = s1o
    else:
        stitched = list(s1o)
        n_dis = 0
        for i, (b1, b2) in enumerate(zip(s1o, s2o)):
            if b1 == b2:
                continue
            n_dis += 1
            if b1 == "N" or b2 == "N":
                info.n_ndis += 1
            q1 = q1o[i]
            q2 = q2o[i]
            if nify_disagreements:
                q, b = 0, "N"
            else:
                if r1_is_first_mate:
                    b, q = (b1, q1) if q1 >= q2 else (b2, q2)
                else:
                    b, q = (b2, q2) if q2 >= q1 else (b1, q1)
                if q1 > min_bq and q2 > min_bq:
                    q = 0
            stitched[i] = b
            out_q[i] = q
        info.n_disagree = n_dis - info.n_ndis
        info.n_agree = overlap - n_dis
        stitched_s = "".join(stitched)
    quals = ([int(x) for x in qual1[:r1_before]] + out_q
             + [int(x) for x in qual2[overlap:]])

    bases = seq1[:r1_before] + stitched_s + seq2[overlap:]
    info.bases = list(bases)
    info.quals = quals
    info.overlap_bases = stitched_s
    m_len = len(bases) - sp1 - ss2
    info.cigar = (["S"] * sp1) + (["M"] * m_len) + (["S"] * ss2)
    d1 = "R" if r1_is_reverse else "F"
    d2 = "F" if r1_is_reverse else "R"
    info.dirs = ([d1] * r1_before) + (["S"] * overlap) + ([d2] * r2_after)
    return info


# ---------------------------------------------------------------------------
# site-by-site reconciliation (the general path)
# ---------------------------------------------------------------------------

class _Site:
    """Per-read op lists at one stitch position (StitchedSite)."""

    __slots__ = ("r1", "r2", "is_prefix", "is_suffix")

    def __init__(self):
        self.r1: List[Tuple[str, Optional[str], Optional[int]]] = []
        self.r2: List[Tuple[str, Optional[str], Optional[int]]] = []
        self.is_prefix = False
        self.is_suffix = False

    def ops(self, read1: bool):
        return self.r1 if read1 else self.r2

    def has_value(self) -> bool:
        return bool(self.r1 or self.r2)

    def has_ref_span(self, read1: bool) -> bool:
        return any(op in _REF_SPAN for op, _b, _q in self.ops(read1))

    def has_insertion(self, read1: bool) -> bool:
        return any(op == "I" for op, _b, _q in self.ops(read1))


class _Pos:
    __slots__ = ("unmapped", "mapped")

    def __init__(self):
        self.unmapped = _Site()
        self.mapped = _Site()


def _add_read(positions: List[_Pos], expanded: List[str], bases: str,
              quals, start_offset: int, read1: bool) -> None:
    """AddR1ToList/AddR2ToList: ref-span ops land in MappedSite at
    consecutive offsets; S/I ops pile into the UnmappedPrefix of the
    current offset."""
    # exact preallocation: ref_pos advances once per ref-span op; a
    # trailing S/I group additionally needs the slot it piles into
    n_ref = sum(1 for op in expanded if op in _REF_SPAN)
    target = start_offset + n_ref + (
        1 if expanded and expanded[-1] not in _REF_SPAN else 0)
    while len(positions) < target:
        positions.append(_Pos())
    ref_pos = start_offset
    idx = 0
    for op in expanded:
        if op in _REF_SPAN:
            if op == "D" or op == "N":
                item = (op, None, None)
            else:
                item = (op, bases[idx], int(quals[idx]))
                idx += 1
            positions[ref_pos].mapped.ops(read1).append(item)
            ref_pos += 1
        else:
            item = (op, bases[idx], int(quals[idx]))
            idx += 1
            positions[ref_pos].unmapped.ops(read1).append(item)


def _redistribute_softclips(positions: List[_Pos], operate_on_r1: bool,
                            has_prefix_clip: bool, has_suffix_clip: bool,
                            allow_terminal_clips_support_dels: bool) -> None:
    """RedistributeSoftclips (CigarReconciler.cs:949-1167): spread a read's
    bookending softclips across the other read's further-extending
    positions so S-over-M overlaps reconcile 1:1 per site."""
    this = operate_on_r1
    other = not operate_on_r1
    suffix_to_add: Optional[_Pos] = None

    i = 0
    while i < len(positions):
        sp = positions[i]
        nxt = positions[i + 1] if i + 1 < len(positions) else None
        prv = positions[i - 1] if i > 0 else None

        is_suffix = (i == len(positions) - 1
                     or (nxt is not None and not nxt.unmapped.ops(this)
                         and not nxt.mapped.ops(this)))
        is_prefix = (i == 0
                     or (prv is not None and not prv.unmapped.ops(this)
                         and not prv.mapped.ops(this)))
        if is_prefix:
            is_suffix = False
        if sp.unmapped.has_value():
            sp.unmapped.is_prefix = is_prefix
            sp.unmapped.is_suffix = is_suffix

        if not is_prefix and not has_suffix_clip:
            break
        if not is_suffix and not has_prefix_clip:
            i += 1
            continue

        if is_suffix:
            ops_this = sp.unmapped.ops(this)
            if len(ops_this) > len(sp.unmapped.ops(other)):
                give = []
                for item in reversed(ops_this):
                    if item[0] == "S":
                        give.append(item)
                    else:
                        break
                give.reverse()
                n_give = len(give)
                del ops_this[len(ops_this) - n_give:]
                count = 0
                while give:
                    j = i + count
                    if j > len(positions) - 1:
                        suffix_to_add = _Pos()
                        suffix_to_add.unmapped.ops(this).extend(give)
                        give = []
                        break
                    cur = positions[j]
                    while (len(cur.unmapped.ops(other))
                           != len(cur.unmapped.ops(this)) and give):
                        cur.unmapped.ops(this).append(give.pop(0))
                    other_mapped = cur.mapped.ops(other)
                    if (allow_terminal_clips_support_dels and other_mapped
                            and all(o[0] == "D" for o in other_mapped)):
                        # terminal S supports the overlapping deletion
                        first = other_mapped[0]
                        cur.mapped.ops(this).append(
                            (first[0], first[1], first[2]))
                    elif (other_mapped and give
                          and not cur.mapped.ops(this)):
                        cur.mapped.ops(this).append(give.pop(0))
                    count += 1
        if is_prefix:
            ops_this = sp.unmapped.ops(this)
            if len(ops_this) > len(sp.unmapped.ops(other)):
                give = []
                for item in ops_this:
                    if item[0] == "S":
                        give.append(item)
                    else:
                        break
                n_give = len(give)
                del ops_this[:n_give]
                count = 0
                while give:
                    count += 1
                    j = i - count
                    penultimate = positions[j + 1]
                    if j < 0:
                        penultimate.unmapped.ops(this)[:] = give
                        break
                    cur = positions[j]
                    other_mapped = cur.mapped.ops(other)
                    if (allow_terminal_clips_support_dels and other_mapped
                            and all(o[0] == "D" for o in other_mapped)):
                        first = other_mapped[0]
                        cur.mapped.ops(this).append(
                            (first[0], first[1], first[2]))
                        continue
                    elif (other_mapped and give
                          and not cur.mapped.ops(this)):
                        cur.mapped.ops(this).append(give.pop())
                    else:
                        penultimate.unmapped.ops(this)[:] = list(give)
                        break
        i += 1

    if suffix_to_add is not None:
        positions.append(suffix_to_add)


def _combined_op(op1: Optional[str], op2: Optional[str]) -> Optional[str]:
    if op1 is None and op2 is None:
        return None
    if op1 is None:
        return op2
    if op2 is None:
        return op1
    if op1 == op2:
        return op1
    if op1 == "S":
        return op2
    if op2 == "S":
        return op1
    return None


class _Cursor:
    __slots__ = ("in_r1", "in_r2")

    def __init__(self):
        self.in_r1 = -1
        self.in_r2 = -1


def _merge_stitched_base(info: _Info, r1_item, r2_item, r1_dir: str,
                         r1_is_first_mate: bool, min_bq: int,
                         nify: bool) -> None:
    """AddStitchedBaseAndUpdateNumDisagreements (CigarReconciler.cs:866-946)."""
    b1, q1 = r1_item[1], r1_item[2]
    b2, q2 = r2_item[1], r2_item[2]
    if b1 == b2:
        info.bases.append(b1)
        info.quals.append(min(q1 + q2, MAX_BASE_QUALITY))
        return
    info.n_disagree += 1
    if nify:
        info.bases.append("N")
        info.quals.append(0)
        return
    fwd = r1_item if r1_dir == "F" else r2_item
    rev = r2_item if r1_dir == "F" else r1_item
    if fwd[2] > rev[2]:
        base = fwd[1]
        q = fwd[2] if rev[2] < min_bq else 0
    elif fwd[2] == rev[2]:
        first = r1_item if r1_is_first_mate else r2_item
        second = r2_item if r1_is_first_mate else r1_item
        base = first[1]
        q = first[2] if second[2] < min_bq else 0
    else:
        base = rev[1]
        q = rev[2] if fwd[2] < min_bq else 0
    info.bases.append(base)
    info.quals.append(q)


def _fill_in_from_read(items, info: _Info, direction: str,
                       cur: _Cursor, read1: bool) -> None:
    for op, base, q in items:
        info.dirs.append(direction)
        info.cigar.append(op)
        if op == "D" or op == "N":
            continue
        if op in _READ_SPAN:
            if read1:
                cur.in_r1 += 1
            else:
                cur.in_r2 += 1
        info.bases.append(base)
        info.quals.append(q)


def _reconcile_site(site: _Site, info: _Info, cur: _Cursor,
                    prefix_probe_clip_end: int, suffix_probe_clip_start: int,
                    pair_is_outie: bool, r1_dir: str, r2_dir: str,
                    r1_is_first_mate: bool, right_align: bool,
                    use_softclipped_bases: bool,
                    ignore_probe_softclips: bool, min_bq: int,
                    nify: bool) -> bool:
    """ReconcileSite (CigarReconciler.cs:668-832)."""
    n1 = len(site.r1)
    n2 = len(site.r2)
    if n1 == 1 and n2 == 1:
        item1 = site.r1[0]
        item2 = site.r2[0]
        if item1[0] == "M" and item2[0] == "M":
            # the dominant case — plain M-over-M overlap: none of the
            # softclip/probe machinery below applies to M ops
            info.cigar.append("M")
            cur.in_r1 += 1
            cur.in_r2 += 1
            info.dirs.append("S")
            _merge_stitched_base(info, item1, item2, r1_dir,
                                 r1_is_first_mate, min_bq, nify)
            return True
    offset = abs(n1 - n2)
    r1_longer = n1 > n2
    for j in range(max(n1, n2)):
        if right_align:
            i1 = j if r1_longer else j - offset
            i2 = j - offset if r1_longer else j
        else:
            i1 = j
            i2 = j
        item1 = site.r1[i1] if 0 <= i1 < n1 else None
        item2 = site.r2[i2] if 0 <= i2 < n2 else None
        op1 = item1[0] if item1 is not None else None
        op2 = item2[0] if item2 is not None else None
        combined = _combined_op(op1, op2)
        if combined is None:
            return False
        info.cigar.append(combined)

        r1_used = op1 is not None
        r2_used = op2 is not None
        if r1_used and op1 in _READ_SPAN:
            cur.in_r1 += 1
        if r2_used and op2 in _READ_SPAN:
            cur.in_r2 += 1
        if combined != "S":
            if not use_softclipped_bases and op2 == "S":
                r2_used = False
            if not use_softclipped_bases and op1 == "S":
                r1_used = False
        if ignore_probe_softclips:
            if r1_used and op1 == "S":
                is_probe = ((pair_is_outie
                             and cur.in_r1 >= suffix_probe_clip_start)
                            or (not pair_is_outie
                                and cur.in_r1 < prefix_probe_clip_end))
                if is_probe and r2_used:
                    r1_used = False
                    if pair_is_outie:
                        info.ignored_probe_suffix += 1
                    else:
                        info.ignored_probe_prefix += 1
            if r2_used and op2 == "S":
                is_probe = ((pair_is_outie
                             and cur.in_r2 < prefix_probe_clip_end)
                            or (not pair_is_outie
                                and cur.in_r2 >= suffix_probe_clip_start))
                if is_probe and r1_used:
                    r2_used = False
                    if pair_is_outie:
                        info.ignored_probe_prefix += 1
                    else:
                        info.ignored_probe_suffix += 1
            if not r1_used and not r2_used:
                raise ValueError(
                    "both R1 and R2 in probe softclip at overlapping position")

        stitched = r1_used and r2_used
        info.dirs.append("S" if stitched else (r1_dir if r1_used else r2_dir))
        if combined == "D" or combined == "N":
            continue
        if stitched:
            _merge_stitched_base(info, item1, item2, r1_dir,
                                 r1_is_first_mate, min_bq, nify)
        else:
            item = item1 if r1_used else item2
            info.bases.append(item[1])
            info.quals.append(item[2])
    return True


def _has_incompatible_insertion(pos: _Pos, before: Optional[_Pos]) -> bool:
    um = pos.unmapped
    if not um.r1 and not um.r2:
        return False  # no unmapped ops here — nothing to be incompatible
    for read1 in (True, False):
        other = not read1
        if (not pos.unmapped.ops(other) and pos.unmapped.has_insertion(read1)
                and pos.mapped.has_ref_span(other)
                and before is not None and before.mapped.has_ref_span(other)):
            return True
    return False


def _reconcile_sites(positions: List[_Pos], r1_is_reverse: bool,
                     pair_is_outie: bool, r1_is_first_mate: bool,
                     prefix_probe_clip_end: int, suffix_probe_clip_start: int,
                     r1_has_prefix: bool, r1_has_suffix: bool,
                     r2_has_prefix: bool, r2_has_suffix: bool,
                     use_softclipped_bases: bool, ignore_probe_softclips: bool,
                     min_bq: int, nify: bool,
                     allow_terminal_dels: bool) -> Optional[_Info]:
    info = _Info()
    r1_dir = "R" if r1_is_reverse else "F"
    r2_dir = "F" if r1_is_reverse else "R"

    if r1_has_prefix or r1_has_suffix:
        _redistribute_softclips(positions, True, r1_has_prefix, r1_has_suffix,
                                allow_terminal_dels)
    if r2_has_prefix or r2_has_suffix:
        _redistribute_softclips(positions, False, r2_has_prefix, r2_has_suffix,
                                allow_terminal_dels)

    cur = _Cursor()
    empty_sites = 0
    for i, pos in enumerate(positions):
        before = positions[i - 1] if i > 0 else None
        if _has_incompatible_insertion(pos, before):
            return None
        if empty_sites >= 1 and pos.mapped.has_value():
            return None  # gap between mapped sites: not really stitched
        if not pos.unmapped.has_value() and not pos.mapped.has_value():
            empty_sites += 1
            continue
        ok = _reconcile_site(pos.unmapped, info, cur, prefix_probe_clip_end,
                             suffix_probe_clip_start, pair_is_outie, r1_dir,
                             r2_dir, r1_is_first_mate, pos.unmapped.is_prefix,
                             use_softclipped_bases, ignore_probe_softclips,
                             min_bq, nify)
        if not ok:
            return None
        n1 = len(pos.mapped.r1)
        n2 = len(pos.mapped.r2)
        if n2 > 0 and n1 == 0:
            _fill_in_from_read(pos.mapped.r2, info, r2_dir, cur, False)
            continue
        if n1 > 0 and n2 == 0:
            _fill_in_from_read(pos.mapped.r1, info, r1_dir, cur, True)
            continue
        if n1 == 0 and n2 == 0:
            continue
        ok = _reconcile_site(pos.mapped, info, cur, prefix_probe_clip_end,
                             suffix_probe_clip_start, pair_is_outie, r1_dir,
                             r2_dir, r1_is_first_mate, False,
                             use_softclipped_bases, ignore_probe_softclips,
                             min_bq, nify)
        if not ok:
            return None

    if _has_internal_softclip(_compress(info.cigar)):
        return None
    return info


# ---------------------------------------------------------------------------
# native path (io/_native/stitch.cpp: the same semantics, about 30x faster;
# the Python implementation below is its plain version)
# ---------------------------------------------------------------------------

USE_NATIVE = True          # tests set False to run the Python path
_tls = threading.local()


def _get_native():
    """The port's native library, built at first use; raises if it cannot
    be built (its ctypes signatures are set by io/native.get_lib)."""
    from pisces_tpu_torch.io.native import get_lib
    return get_lib()


class _StitchCtx:
    """Per-thread preallocated buffers with their ctypes pointers computed
    once — the per-call ctypes glue (data_as/cast) dominated the first
    native version's profile at ~77us/pair."""

    MAX_OPS = 4096

    def __init__(self, cap: int):
        self.cap = cap
        self.in_ops1 = np.empty(self.MAX_OPS, np.uint8)
        self.in_lens1 = np.empty(self.MAX_OPS, np.int32)
        self.in_ops2 = np.empty(self.MAX_OPS, np.uint8)
        self.in_lens2 = np.empty(self.MAX_OPS, np.int32)
        self.in_seq1 = np.empty(cap, np.uint8)
        self.in_seq2 = np.empty(cap, np.uint8)
        self.in_q1 = np.empty(cap, np.uint8)
        self.in_q2 = np.empty(cap, np.uint8)
        self.out_ops = np.empty(cap, np.uint8)
        self.out_lens = np.empty(cap, np.int32)
        self.out_seq = np.empty(cap, np.uint8)
        self.out_qual = np.empty(cap, np.uint8)
        self.out_xd = np.empty(8 * cap, np.uint8)
        self.counts = np.empty(3, np.int32)
        self.out_pos = ctypes.c_int64()
        self.out_nc = ctypes.c_int32()
        self.out_len = ctypes.c_int32()
        self.out_xn = ctypes.c_int32()
        as_ptr = ctypes.c_void_p
        self.p = tuple(as_ptr(a.ctypes.data) for a in (
            self.in_ops1, self.in_lens1, self.in_seq1, self.in_q1,
            self.in_ops2, self.in_lens2, self.in_seq2, self.in_q2,
            self.out_ops, self.out_lens, self.out_seq, self.out_qual,
            self.out_xd, self.counts))
        self.rp = (ctypes.byref(self.out_pos), ctypes.byref(self.out_nc),
                   ctypes.byref(self.out_len), ctypes.byref(self.out_xn))


def _native_ctx(cap: int) -> _StitchCtx:
    ctx = getattr(_tls, "stitch_ctx", None)
    if ctx is None or ctx.cap < cap:
        ctx = _StitchCtx(cap)
        _tls.stitch_ctx = ctx
    return ctx


def _stitch_native(lib, pos1_r1, cigar1, seq1, qual1, pos1_r2, cigar2, seq2,
                   qual2, r1_is_reverse, min_bq, nify, use_sc, dont_hp,
                   max_read_length, pair_is_outie, r1_first, ignore_probe,
                   allow_td, thresh, count_ns) -> Optional[StitchedRead]:
    n1, n2 = len(cigar1), len(cigar2)
    l1, l2 = len(seq1), len(seq2)
    cap = 4 * max_read_length + 64
    ctx = _native_ctx(max(cap, l1 + 1, l2 + 1))
    if n1 > ctx.MAX_OPS or n2 > ctx.MAX_OPS:
        raise _NativeUnsupported()
    for k, (op, ln) in enumerate(cigar1):
        ctx.in_ops1[k] = op
        ctx.in_lens1[k] = ln
    for k, (op, ln) in enumerate(cigar2):
        ctx.in_ops2[k] = op
        ctx.in_lens2[k] = ln
    ctx.in_seq1[:l1] = np.frombuffer(seq1.encode(), np.uint8)
    ctx.in_seq2[:l2] = np.frombuffer(seq2.encode(), np.uint8)
    ctx.in_q1[:l1] = qual1
    ctx.in_q2[:l2] = qual2
    p = ctx.p
    rp = ctx.rp
    rc = lib.stitch_pair(
        pos1_r1, p[0], p[1], n1, p[2], p[3], l1,
        pos1_r2, p[4], p[5], n2, p[6], p[7], l2,
        int(r1_is_reverse), min_bq, int(nify), int(use_sc), int(dont_hp),
        max_read_length, -1 if pair_is_outie is None else int(pair_is_outie),
        int(r1_first), int(ignore_probe), int(allow_td),
        -1 if thresh is None else int(thresh), int(count_ns),
        rp[0], p[8], p[9], rp[1], p[10], p[11], rp[2], p[12], rp[3],
        p[13], ctx.cap)
    if rc == 0:
        return None
    if rc == -2:
        raise ValueError(
            "both R1 and R2 in probe softclip at overlapping position")
    if rc != 1:
        raise _NativeUnsupported()
    nc = ctx.out_nc.value
    n_out = ctx.out_len.value
    cigar_out = list(zip(ctx.out_ops[:nc].tolist(),
                         ctx.out_lens[:nc].tolist()))
    seq = ctx.out_seq[:n_out].tobytes().decode()
    quals = ctx.out_qual[:n_out].tolist()
    xd = ctx.out_xd[:ctx.out_xn.value].tobytes().decode()
    return StitchedRead(int(ctx.out_pos.value), cigar_out, seq, quals, xd,
                        int(ctx.counts[0]), int(ctx.counts[1]),
                        int(ctx.counts[2]))


class _NativeUnsupported(Exception):
    pass


class _BatchStitchCtx:
    """Reusable per-thread output buffers for stitch_pairs_batch."""

    def __init__(self, n_pairs: int, max_read_length: int):
        self.n_pairs = n_pairs
        self.mrl = max_read_length
        self.seq_stride = 2 * max_read_length + 64
        self.cig_stride = min(self.seq_stride, 4096)
        self.xd_stride = 8 * self.seq_stride
        n = n_pairs
        self.ok = np.empty(n, np.int8)
        self.out_pos = np.empty(n, np.int64)
        self.out_ops = np.empty(n * self.cig_stride, np.uint8)
        self.out_lens = np.empty(n * self.cig_stride, np.int32)
        self.out_ncig = np.empty(n, np.int32)
        self.out_seq = np.empty(n * self.seq_stride, np.uint8)
        self.out_qual = np.empty(n * self.seq_stride, np.uint8)
        self.out_len = np.empty(n, np.int32)
        self.out_xd = np.empty(n * self.xd_stride, np.uint8)
        self.out_xd_len = np.empty(n, np.int32)
        self.out_counts = np.empty(3 * n, np.int32)


def stitch_pairs_columnar(batch, idx1: np.ndarray, idx2: np.ndarray,
                          min_base_quality: int = 20,
                          nify_disagreements: bool = True,
                          use_softclipped_bases: bool = True,
                          dont_stitch_homopolymer_bridge: bool = True,
                          max_read_length: int = 1024,
                          ignore_probe_softclips: bool = True,
                          allow_terminal_clips_to_support_overlapping_dels:
                          bool = True,
                          threshold_num_disagreeing_bases: Optional[int]
                          = None,
                          count_ns_toward_disagreements: bool = False):
    """Stitch many pairs in one native call over the columnar ReadBatch
    (no per-pair marshalling). idx1/idx2 must be ordered so
    batch.pos[idx1] <= batch.pos[idx2] per pair. Returns
    (ok, results) where ok[p] is the native return code and results[p] is
    a StitchedRead for ok==1, else None; returns (None, None) under
    USE_NATIVE = False (the caller then stitches pair by pair in Python).
    Codes < -1 / == -1 mean the caller must re-run THAT pair through
    stitch_reads (unsupported input or probe-softclip ValueError)."""
    if not USE_NATIVE:
        return None, None
    lib = _get_native()
    n = len(idx1)
    if n == 0:
        return np.empty(0, np.int8), []
    ctx = getattr(_tls, "batch_ctx", None)
    if ctx is None or ctx.n_pairs < n or ctx.mrl < max_read_length:
        ctx = _BatchStitchCtx(max(n, 256), max_read_length)
        _tls.batch_ctx = ctx
    lut = b"AGCTN-"
    i1 = np.ascontiguousarray(idx1, np.int64)
    i2 = np.ascontiguousarray(idx2, np.int64)
    pos = np.ascontiguousarray(batch.pos, np.int32)
    flag = np.ascontiguousarray(batch.flag, np.uint16)
    vp = ctypes.c_void_p

    def P(a):
        return vp(a.ctypes.data)

    lib.stitch_pairs_batch(
        n, P(i1), P(i2), P(pos), P(flag),
        P(batch.cigar_off), P(batch.cigar_ops), P(batch.cigar_lens),
        P(batch.seq_off), P(batch.seq), P(batch.qual),
        lut, len(lut),
        min_base_quality, int(nify_disagreements),
        int(use_softclipped_bases), int(dont_stitch_homopolymer_bridge),
        max_read_length, int(ignore_probe_softclips),
        int(allow_terminal_clips_to_support_overlapping_dels),
        -1 if threshold_num_disagreeing_bases is None
        else int(threshold_num_disagreeing_bases),
        int(count_ns_toward_disagreements),
        P(ctx.ok), P(ctx.out_pos),
        P(ctx.out_ops), P(ctx.out_lens), P(ctx.out_ncig), ctx.cig_stride,
        P(ctx.out_seq), P(ctx.out_qual), P(ctx.out_len), ctx.seq_stride,
        P(ctx.out_xd), P(ctx.out_xd_len), ctx.xd_stride,
        P(ctx.out_counts))
    results = []
    for p in range(n):
        rc = int(ctx.ok[p])
        if rc != 1:
            results.append(None)
            continue
        nc = int(ctx.out_ncig[p])
        ln = int(ctx.out_len[p])
        co = p * ctx.cig_stride
        so = p * ctx.seq_stride
        xo = p * ctx.xd_stride
        results.append(StitchedRead(
            int(ctx.out_pos[p]),
            list(zip(ctx.out_ops[co:co + nc].tolist(),
                     ctx.out_lens[co:co + nc].tolist())),
            ctx.out_seq[so:so + ln].tobytes().decode(),
            ctx.out_qual[so:so + ln].tolist(),
            ctx.out_xd[xo:xo + int(ctx.out_xd_len[p])].tobytes().decode(),
            int(ctx.out_counts[3 * p]), int(ctx.out_counts[3 * p + 1]),
            int(ctx.out_counts[3 * p + 2])))
    return ctx.ok[:n], results


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def stitch_reads(pos1_r1: int, cigar1, seq1: str, qual1,
                 pos1_r2: int, cigar2, seq2: str, qual2,
                 r1_is_reverse: bool = False,
                 min_base_quality: int = 20,
                 nify_disagreements: bool = True,
                 use_softclipped_bases: bool = True,
                 dont_stitch_homopolymer_bridge: bool = True,
                 max_read_length: int = 1024,
                 pair_is_outie: Optional[bool] = None,
                 r1_is_first_mate: bool = True,
                 ignore_probe_softclips: bool = True,
                 allow_terminal_clips_to_support_overlapping_dels: bool = True,
                 threshold_num_disagreeing_bases: Optional[int] = None,
                 count_ns_toward_disagreements: bool = False
                 ) -> Optional[StitchedRead]:
    """Attempt to stitch two overlapping mates; None if unstitchable.

    cigar: list of (op_code, length) with MIDNS codes 0..4. Reads are
    normalized so r1 is the earlier read by CLIP-ADJUSTED position
    (AlignmentSet.cs:29-36); pair_is_outie defaults to "the earlier read is
    reverse" (AlignmentSet.IsOutie: PartnerRead2 forward => outie).
    """
    cigar1 = list(cigar1)
    cigar2 = list(cigar2)
    if not cigar1 or not cigar2:
        return None
    if USE_NATIVE:
        lib = _get_native()
        # the native code assumes the valid-BAM invariant len(seq) ==
        # read-span(cigar); a pair that breaks it takes the Python path
        if (len(seq1) == _read_span(cigar1) == len(qual1)
                and len(seq2) == _read_span(cigar2) == len(qual2)):
            try:
                return _stitch_native(
                    lib, pos1_r1, cigar1, seq1, qual1, pos1_r2, cigar2, seq2,
                    qual2, r1_is_reverse, min_base_quality,
                    nify_disagreements, use_softclipped_bases,
                    dont_stitch_homopolymer_bridge, max_read_length,
                    pair_is_outie, r1_is_first_mate, ignore_probe_softclips,
                    allow_terminal_clips_to_support_overlapping_dels,
                    threshold_num_disagreeing_bases,
                    count_ns_toward_disagreements)
            except _NativeUnsupported:
                pass
    if (pos1_r1 - _prefix_clip(cigar1)) > (pos1_r2 - _prefix_clip(cigar2)):
        return stitch_reads(pos1_r2, cigar2, seq2, qual2,
                            pos1_r1, cigar1, seq1, qual1,
                            not r1_is_reverse, min_base_quality,
                            nify_disagreements, use_softclipped_bases,
                            dont_stitch_homopolymer_bridge, max_read_length,
                            pair_is_outie, not r1_is_first_mate,
                            ignore_probe_softclips,
                            allow_terminal_clips_to_support_overlapping_dels,
                            threshold_num_disagreeing_bases,
                            count_ns_toward_disagreements)
    if pair_is_outie is None:
        pair_is_outie = r1_is_reverse

    # IsStitchable span gate (BasicStitcher.cs:195-200)
    r1_end = pos1_r1 + _ref_span(cigar1) - 1
    if use_softclipped_bases:
        stitchable = (r1_end + _suffix_clip(cigar1)
                      >= pos1_r2 - _prefix_clip(cigar2))
    else:
        stitchable = r1_end >= pos1_r2
    if not stitchable:
        return None

    max_stitched = max_read_length * 2 - 1

    info = _super_simple(pos1_r1, cigar1, seq1, qual1, pos1_r2, cigar2,
                         seq2, qual2, r1_is_reverse, r1_is_first_mate,
                         min_base_quality, nify_disagreements)
    if info is not None and len(info.bases) > max_stitched:
        return None
    if info is None:
        positions: List[_Pos] = []
        e1 = _chars(cigar1)
        e2 = _chars(cigar2)
        if pos1_r1 < pos1_r2:
            _add_read(positions, e1, seq1, qual1, 0, True)
            _add_read(positions, e2, seq2, qual2, pos1_r2 - pos1_r1, False)
        else:
            _add_read(positions, e2, seq2, qual2, 0, False)
            _add_read(positions, e1, seq1, qual1, pos1_r1 - pos1_r2, True)
        if len(positions) > max_stitched:
            return None
        r1_pre = _prefix_clip(cigar1)
        r2_pre = _prefix_clip(cigar2)
        r1_suf = _suffix_clip(cigar1)
        r2_suf = _suffix_clip(cigar2)
        prefix_probe_clip_end = r2_pre if pair_is_outie else r1_pre
        suffix_probe_clip_start = (
            _read_span(cigar1) - r1_suf if pair_is_outie
            else _read_span(cigar2) - r2_suf)
        info = _reconcile_sites(
            positions, r1_is_reverse, pair_is_outie, r1_is_first_mate,
            prefix_probe_clip_end, suffix_probe_clip_start,
            r1_pre > 0, r1_suf > 0, r2_pre > 0, r2_suf > 0,
            use_softclipped_bases, ignore_probe_softclips,
            min_base_quality, nify_disagreements,
            allow_terminal_clips_to_support_overlapping_dels)
        if info is None:
            return None

    # disagreement threshold (BasicStitcher.cs:85-88)
    if threshold_num_disagreeing_bases is not None:
        n = info.n_disagree + (info.n_ndis
                               if count_ns_toward_disagreements else 0)
        if n > threshold_num_disagreeing_bases:
            return None

    # homopolymer-bridge rejection (OverlapEvaluator.BridgeAnchored)
    if dont_stitch_homopolymer_bridge:
        if info.is_simple:
            anchored = bridge_anchored(info.overlap_bases)
        else:
            stitched_bases = []
            bi = 0
            for op, d in zip(info.cigar, info.dirs):
                if op == "D" or op == "N":
                    continue
                if d == "S":
                    stitched_bases.append(info.bases[bi])
                bi += 1
            ov = "".join(stitched_bases)
            if len(ov) <= 3:
                anchored = True
            elif len(set(ov)) == 1:
                anchored = False
            else:
                anchored = not is_repeat(ov)
        if not anchored:
            return None

    compressed = _compress(info.cigar)
    cigar_out = [(_CHAR_OP[c], ln) for c, ln in compressed]
    xd = "".join(f"{ln}{d}" for d, ln in _compress(info.dirs))
    return StitchedRead(min(pos1_r1, pos1_r2), cigar_out,
                        "".join(info.bases), info.quals, xd,
                        info.n_agree, info.n_disagree, info.n_ndis)


# ---------------------------------------------------------------------------
# repeat detection (OverlapEvaluator)
# ---------------------------------------------------------------------------

def _slide_sequence(overlap: str, window: int) -> List[str]:
    """SlideSequence: candidate units from the first few start offsets."""
    n = len(overlap)
    limit = 2 if n >= 5 else n - window
    units = []
    i = 0
    while i <= limit:
        u = overlap[i:i + window]
        if len(u) == window and u not in units:
            units.append(u)
        i += 1
    return units


def _string_is_repeat_of_units(overlap: str, unit: str) -> bool:
    """StringIsRepeatOfUnits: tandem repeats of unit, allowing a partial
    leading repeat (matching the unit's tail) and a partial trailing one."""
    first = overlap.find(unit)
    if first > 0:
        if first >= len(unit):
            return False
        if overlap[:first] != unit[len(unit) - first:]:
            return False
    i = first
    is_full = True
    while i < len(overlap):
        if overlap.find(unit, i) == i:
            i += len(unit)
            continue
        remaining = len(overlap) - i
        if remaining <= len(unit):
            if overlap[i:] != unit[:remaining]:
                return False
            return True
        return False
    return is_full


def is_repeat(overlap: str, max_unit: int = 3) -> bool:
    """OverlapEvaluator.IsRepeat: overlap consists of tandem repeats of a
    short unit (allowing partial leading/trailing repeats)."""
    window = 1
    max_window = min(len(overlap) - 1, max_unit)
    while window <= max_window:
        for unit in _slide_sequence(overlap, window):
            if len(overlap) == len(unit):
                continue
            if _string_is_repeat_of_units(overlap, unit):
                return True
        window += 1
    return False


def bridge_anchored(overlap_bases: str) -> bool:
    """OverlapEvaluator.BridgeAnchored(string)."""
    if len(overlap_bases) <= 3:
        return True
    return not is_repeat(overlap_bases)
