"""Coverage reconciliation (CoverageCalculator semantics).

Single-point coverage (reference alleles / SNVs) and spanning coverage
(deletion / MNV / insertion) per src/lib/Pisces.Calculators/CoverageCalculator.cs.
The dense single-point path is vectorized over positions; the spanning path
takes a batch of alleles as columns (spanning_coverage_columns), one allele
being the one-row case.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pisces_tpu_torch.domain.types import (
    COVERAGE_CONTRIBUTING_ALLELES, NUM_DIRECTION_TYPES, AlleleCategory,
    AlleleType, DirectionType, get_allele_type,
)
from pisces_tpu_torch.calling.source import AlleleSource
from pisces_tpu_torch.pileup.counts import anchor_window_sum

_COV_ALLELES = [int(a) for a in COVERAGE_CONTRIBUTING_ALLELES]


@dataclass
class CoverageResult:
    total_coverage: int = 0
    coverage_by_direction: np.ndarray = field(
        default_factory=lambda: np.zeros(NUM_DIRECTION_TYPES, dtype=np.int64))
    reference_support: int = 0
    num_no_calls: int = 0
    sum_of_base_quality: float = 0.0
    confident_coverage_start: int = 0
    confident_coverage_end: int = 0
    suspicious_coverage_start: int = 0
    suspicious_coverage_end: int = 0
    unanchored_coverage_weight: float = 0.0
    allele_support_adjustment: int = 0  # gapped-mnv adjustment for Reference alleles


def single_point_coverage(source: AlleleSource, position: int, ref_base: str,
                          category: AlleleCategory,
                          allele_support: int) -> CoverageResult:
    """CoverageCalculator.CalculateSinglePoint (cs:49-98)."""
    res = CoverageResult()
    ref_type = int(get_allele_type(ref_base[0]))
    # one row fetch for the position; the loop below preserves the
    # reference's exact accumulation order (float-sum parity)
    rows = source.flat_rows(position)
    if rows is None:
        crow = [[0] * 3 for _ in range(6)]
        qrow = [[0.0] * 3 for _ in range(6)]
    else:
        crow = rows[0].tolist()
        qrow = rows[1].tolist()
    n_type = int(AlleleType.N)
    for d in range(NUM_DIRECTION_TYPES):
        for a in _COV_ALLELES:
            c = crow[a][d]
            res.coverage_by_direction[d] += c
            res.sum_of_base_quality += qrow[a][d]
            if a == ref_type:
                res.reference_support += c
        res.total_coverage += int(res.coverage_by_direction[d])
        res.confident_coverage_start += int(res.coverage_by_direction[d])
        res.confident_coverage_end += int(res.coverage_by_direction[d])
        res.num_no_calls += crow[n_type][d]

    gapped = source.get_gapped_mnv_ref_count(position)
    if category == AlleleCategory.SNV:
        res.reference_support = max(0, res.reference_support - gapped)
    elif category == AlleleCategory.REFERENCE:
        res.allele_support_adjustment = -min(gapped, allele_support)
    return res


@dataclass
class SpanningColumns:
    """CoverageResult's fields of n spanning alleles, one row each
    (spanning_coverage_columns)."""
    total_coverage: np.ndarray             # int64 [n]
    coverage_by_direction: np.ndarray      # int64 [n, 3]
    reference_support: np.ndarray          # int64 [n]
    num_no_calls: np.ndarray               # int64 [n], always 0
    sum_of_base_quality: np.ndarray        # float64 [n]
    confident_coverage_start: np.ndarray   # int64 [n]
    confident_coverage_end: np.ndarray
    suspicious_coverage_start: np.ndarray
    suspicious_coverage_end: np.ndarray
    unanchored_coverage_weight: np.ndarray  # float64 [n]

    def result(self, i: int) -> CoverageResult:
        return CoverageResult(
            int(self.total_coverage[i]),
            self.coverage_by_direction[i].copy(),
            int(self.reference_support[i]), int(self.num_no_calls[i]),
            float(self.sum_of_base_quality[i]),
            int(self.confident_coverage_start[i]),
            int(self.confident_coverage_end[i]),
            int(self.suspicious_coverage_start[i]),
            int(self.suspicious_coverage_end[i]),
            float(self.unanchored_coverage_weight[i]))


def _ordered_sum(values: np.ndarray) -> np.ndarray:
    """Sum [n, m] along its rows one value after another from 0.0, as the
    reference's loops add them (a cumulative sum is sequential; numpy's
    plain sum is pairwise)."""
    n = len(values)
    return np.cumsum(np.concatenate([np.zeros((n, 1)), values], axis=1),
                     axis=1)[:, -1]


def _window_sums(table: np.ndarray, rows: np.ndarray, allele: np.ndarray,
                 anchor_size: int, min_anchor: int, max_anchor, from_end: bool
                 ) -> np.ndarray:
    """[m, 3]: anchor_window_sum of table[rows[j], allele[j], d] for each
    direction d, 0 where rows[j] is -1 (no anchored row there)."""
    if len(table) == 0:
        return np.zeros((len(rows), NUM_DIRECTION_TYPES), table.dtype)
    sums = anchor_window_sum(table[np.maximum(rows, 0), allele], anchor_size,
                             min_anchor, max_anchor, from_end)
    return np.where((rows >= 0)[:, None], sums, 0)


def spanning_coverage_columns(source: AlleleSource, category, position,
                              ref_len, alt_len, first_base, last_base,
                              allele_support, well_anchored_support,
                              consider_anchor_information: bool
                              ) -> SpanningColumns:
    """CoverageCalculator.CalculateSpanning (cs:171-331) over n deletions,
    insertions or MNVs at once, one row each. Arrays [n]: the category,
    1-based position, lengths of the ref and alt alleles, the AlleleType of
    an insertion's first and last inserted base (any value for other
    rows), the support and well-anchored support.

    Each row gets the reference's arithmetic bit for bit: the same counts,
    the f64 sum of base qualities in the reference's order, the int()
    truncations and the f32 direction coverages. A picky row (an insertion
    with anchor information) reads its first inserted base's allele at the
    end position, and its last's at the start, from the anchor-resolved
    rows, windowed by the insertion's length; every other count is a
    full-range total."""
    cat = np.asarray(category, np.int64)
    position, ref_len, alt_len, first_base, last_base, support, well = (
        np.asarray(x, np.int64) for x in (
            position, ref_len, alt_len, first_base, last_base,
            allele_support, well_anchored_support))
    n = len(cat)
    ins = cat == AlleleCategory.INSERTION
    dele = cat == AlleleCategory.DELETION
    length = np.where(ins, alt_len - 1, np.where(dele, ref_len - 1, alt_len))
    start = np.where(dele, position + 1, position)
    end = np.where(ins, position + 1, start + length - 1)
    presume_anchored = ~ins | bool(source.expect_stitched_reads)
    picky = ins & bool(consider_anchor_information)
    unanchored = support - well

    # [n, direction, allele] over the coverage-contributing alleles, in
    # the reference's (d, a) loop order
    def totals(pos):
        c, q = source.flat_columns(pos)
        return (c[:, _COV_ALLELES, :].transpose(0, 2, 1).astype(np.int64),
                q[:, _COV_ALLELES, :].transpose(0, 2, 1).copy())

    sc, sq = totals(start)
    ec, eq = totals(end)
    unanch_start = np.zeros((n, NUM_DIRECTION_TYPES), np.int64)
    unanch_end = np.zeros((n, NUM_DIRECTION_TYPES), np.int64)
    unanch_start_qual = np.zeros(n)
    unanch_end_qual = np.zeros(n)

    rows = np.nonzero(picky)[0]
    if len(rows):
        pc = source.pc
        a_size = pc.anchor_size
        s_ar = pc.anchored_rows(start[rows])
        e_ar = pc.anchored_rows(end[rows])
        # an allele's slot among the contributing alleles, -1 if none
        slot = np.full(len(AlleleType), -1)
        slot[_COV_ALLELES] = np.arange(len(_COV_ALLELES))
        last, first = last_base[rows], first_base[rows]
        for lng in np.unique(length[rows]).tolist():
            g = np.nonzero(length[rows] == lng)[0]
            # the last inserted base is windowed at the start, the first at
            # the end; the unanchored qualities of both are read at the
            # *start* (CoverageCalculator.cs:262-263), kept for parity
            for ar, base, cnt, qual, from_end, u_cnt, u_qual in (
                    (s_ar[g], last[g], sc, sq, False, unanch_start,
                     unanch_start_qual),
                    (e_ar[g], first[g], ec, eq, True, unanch_end,
                     unanch_end_qual)):
                j = np.nonzero(slot[base] >= 0)[0]
                r, aj, bj, sl = rows[g][j], ar[j], base[j], slot[base[j]]
                cnt[r, :, sl] = _window_sums(pc.anchored_counts, aj, bj,
                                             a_size, lng, None, from_end)
                qual[r, :, sl] = _window_sums(pc.anchored_quals, aj, bj,
                                              a_size, lng, None, from_end)
                k = np.nonzero(unanchored[r] > 0)[0]
                u_cnt[r[k]] = _window_sums(pc.anchored_counts, aj[k], bj[k],
                                           a_size, 0, lng - 1, from_end)
                u_qual[r[k]] = _ordered_sum(_window_sums(
                    pc.anchored_quals, s_ar[g][j][k], bj[k], a_size, 0,
                    lng - 1, from_end))

    # base qualities: (d, a) interleaved, start before end
    sum_q = _ordered_sum(np.stack([sq, eq], axis=-1).reshape(
        n, 2 * NUM_DIRECTION_TYPES * len(_COV_ALLELES)))
    conf_l = sc.sum(axis=(1, 2))
    conf_r = ec.sum(axis=(1, 2))
    susp_l = unanch_start.sum(axis=1)
    susp_r = unanch_end.sum(axis=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        truly_anchored = ((conf_l - susp_r) + (conf_r - susp_l)) / 2.0
        anchored_vf = np.where(truly_anchored <= 0, 0.0,
                               well / truly_anchored)
        total_susp = susp_l + susp_r
        unanch_vf = np.where(total_susp == 0, 0.0, unanchored / total_susp)
        ratio = unanch_vf / anchored_vf
    # max(0.0, 1.0 if anchored_vf == 0 else min(1.0, ratio)), as Python
    # picks among equals
    weight = np.where(anchored_vf == 0, 1.0, np.where(ratio < 1.0, ratio, 1.0))
    weight = np.where(picky & (weight > 0.0), weight, 0.0)
    start_cov = sc.sum(axis=2) + (unanch_start * weight[:, None]).astype(np.int64)
    end_cov = ec.sum(axis=2) + (unanch_end * weight[:, None]).astype(np.int64)
    # the reference adds these inside the direction loop (3x);
    # reproduced for parity (CoverageCalculator.cs:295-297)
    for _ in range(NUM_DIRECTION_TYPES):
        sum_q = sum_q + unanch_start_qual * weight
        sum_q = sum_q + unanch_end_qual * weight

    for cov in (start_cov, end_cov):
        # stitched support goes half to forward (rounded up), half to reverse
        st = cov[:, DirectionType.STITCHED].copy()
        cov[:, DirectionType.FORWARD] += -(-st // 2)
        cov[:, DirectionType.REVERSE] += st // 2
    s2, e2 = start_cov[:, :2], end_cov[:, :2]
    exact = np.where(presume_anchored[:, None],
                     (s2 + e2).astype(np.float32) / np.float32(2.0),
                     np.minimum(s2, e2).astype(np.float32))
    cov_by_dir = np.zeros((n, NUM_DIRECTION_TYPES), np.int64)
    cov_by_dir[:, :2] = exact.astype(np.int64)
    total = ((np.float32(0.0) + exact[:, 0]) + exact[:, 1]).astype(np.int64)
    return SpanningColumns(
        total, cov_by_dir, np.maximum(0, total - support),
        np.zeros(n, np.int64), sum_q, conf_l, conf_r, susp_l, susp_r, weight)


def spanning_coverage(source: AlleleSource, category: AlleleCategory,
                      position: int, ref_allele: str, alt_allele: str,
                      allele_support: int, well_anchored_support: int,
                      consider_anchor_information: bool) -> CoverageResult:
    """CoverageCalculator.CalculateSpanning (cs:171-331) for one allele:
    the one-row case of spanning_coverage_columns."""
    first = last = int(AlleleType.N)
    if category == AlleleCategory.INSERTION:
        first = int(get_allele_type(alt_allele[1]))
        last = int(get_allele_type(alt_allele[-1]))
    return spanning_coverage_columns(
        source, [int(category)], [position], [len(ref_allele)],
        [len(alt_allele)], [first], [last], [allele_support],
        [well_anchored_support], consider_anchor_information).result(0)


def compute_coverage(source: AlleleSource, category: AlleleCategory, position: int,
                     ref_allele: str, alt_allele: str, allele_support: int,
                     well_anchored_support: int,
                     consider_anchor_information: bool) -> CoverageResult:
    """CoverageCalculator.Compute dispatch."""
    if category in (AlleleCategory.REFERENCE, AlleleCategory.SNV):
        return single_point_coverage(source, position, ref_allele, category,
                                     allele_support)
    if category in (AlleleCategory.DELETION, AlleleCategory.MNV,
                    AlleleCategory.INSERTION):
        return spanning_coverage(source, category, position, ref_allele, alt_allele,
                                 allele_support, well_anchored_support,
                                 consider_anchor_information)
    return single_point_coverage(source, position, ref_allele, category,
                                 allele_support)
