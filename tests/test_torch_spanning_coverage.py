"""Spanning coverage as columns (pisces_tpu_torch/ops/coverage
.spanning_coverage_columns) against a frozen copy of the per-allele
function it replaced.

The oracle below is that per-allele CoverageCalculator.CalculateSpanning,
with the allele-source lookups and the anchor-window sum it called, frozen
here as they were: scalar get_allele_count / get_sum_of_base_qualities
calls, a two-row branch for rows that are not picky and the anchor-windowed
branch for picky insertions. Every field of every row must be equal, the
sum of base qualities and the unanchored coverage weight as f64 bits, and
so must the one-row case (spanning_coverage).

Counts come from the port's own read flows on a messy synthetic workload
(the C++ pileup and the Python event build, each with its real indels) and
from hand-built PileupCounts with random f64 qualities, whose sums round
differently in any other order.
"""
import dataclasses
import math
import os
import struct

import numpy as np
import pytest

from pisces_tpu_torch.apps import pisces as torch_app
from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.calling.caller import AlleleCaller
from pisces_tpu_torch.calling.source import AlleleSource
from pisces_tpu_torch.domain.types import (
    COVERAGE_CONTRIBUTING_ALLELES, NUM_DIRECTION_TYPES, AlleleCategory,
    AlleleType, DirectionType, get_allele_type, num_anchor_indexes,
)
from pisces_tpu_torch.io import native
from pisces_tpu_torch.ops.coverage import (
    CoverageResult, spanning_coverage, spanning_coverage_columns,
)
from pisces_tpu_torch.pileup.counts import PileupCounts
from pisces_tpu_torch.synthetic import write_synthetic_workload

_COV_ALLELES = [int(a) for a in COVERAGE_CONTRIBUTING_ALLELES]
INS, DEL, MNV = (AlleleCategory.INSERTION, AlleleCategory.DELETION,
                 AlleleCategory.MNV)


# -- the frozen per-allele oracle ---------------------------------------------

def _frozen_window_sum(arr_last_axis, anchor_size, min_anchor, max_anchor,
                       from_end):
    a = anchor_size
    k = num_anchor_indexes(a)
    well = a
    true_min = min(well, min_anchor)
    if max_anchor is None:
        initial_max = well
    elif max_anchor >= well:
        initial_max = well - 1
    else:
        initial_max = max_anchor
    idx = []
    if from_end:
        for i in range(true_min, initial_max + 1):
            idx.append(k - i - 1)
        if max_anchor is None:
            for i in range(0, initial_max):
                idx.append(i)
    else:
        for i in range(true_min, initial_max + 1):
            idx.append(i)
        if max_anchor is None:
            for i in range(initial_max + 1, k):
                idx.append(i)
    if not idx:
        return np.zeros(arr_last_axis.shape[:-1], dtype=arr_last_axis.dtype)
    return arr_last_axis[..., np.array(idx, dtype=np.intp)].sum(axis=-1)


_ANCHORED_MAPS = {}


def _anchored_row(pc, position):
    """The row of anchored_counts/quals for a position, -1 if none, from a
    {position: row} map kept for each PileupCounts the tests build."""
    key = id(pc)
    if key not in _ANCHORED_MAPS or _ANCHORED_MAPS[key][0] is not pc:
        _ANCHORED_MAPS[key] = (pc, {int(p): i for i, p in
                                    enumerate(pc.anchored_positions)})
    return _ANCHORED_MAPS[key][1].get(int(position), -1)


def _frozen_lookup(source, quals, position, allele_type, direction,
                   min_anchor=0, max_anchor=None, from_end=False):
    pc = source.pc
    if min_anchor == 0 and max_anchor is None:
        row = int(pc.pos_index(position))
        flat = pc.totals_flat()[1 if quals else 0]
        if row < 0:
            return 0.0 if quals else 0
        v = flat[row, allele_type, direction]
        return float(v) if quals else int(v)
    ar = _anchored_row(pc, position)
    if ar < 0:
        return 0.0 if quals else 0
    table = pc.anchored_quals if quals else pc.anchored_counts
    v = _frozen_window_sum(table[ar, allele_type, direction], pc.anchor_size,
                           min_anchor, max_anchor, from_end)
    return float(v) if quals else int(v)


def _count(source, *a, **k):
    return _frozen_lookup(source, False, *a, **k)


def _qual(source, *a, **k):
    return _frozen_lookup(source, True, *a, **k)


def _flat_rows(source, position):
    row = source.pc.pos_index(position)
    if row < 0:
        return None
    counts, quals = source.pc.totals_flat()
    return counts[row], quals[row]


def _redistribute_stitched(cov):
    st = int(cov[DirectionType.STITCHED])
    cov[DirectionType.FORWARD] += math.ceil(st / 2)
    cov[DirectionType.REVERSE] += st // 2
    cov[DirectionType.STITCHED] = 0


def frozen_spanning_coverage(source, category, position, ref_allele,
                             alt_allele, allele_support,
                             well_anchored_support,
                             consider_anchor_information):
    """CoverageCalculator.CalculateSpanning (cs:171-331), per allele, as the
    port computed it before the column pass."""
    length = (len(alt_allele) - 1 if category == AlleleCategory.INSERTION
              else len(ref_allele) - 1 if category == AlleleCategory.DELETION
              else len(alt_allele))
    if category == AlleleCategory.DELETION:
        start_pos, end_pos = position + 1, position + length
        presume_anchored = True
    elif category == AlleleCategory.MNV:
        start_pos, end_pos = position, position + length - 1
        presume_anchored = True
    else:  # insertion
        start_pos, end_pos = position, position + 1
        presume_anchored = source.expect_stitched_reads

    res = CoverageResult()
    start_cov = np.zeros(3, dtype=np.int64)
    end_cov = np.zeros(3, dtype=np.int64)
    start_cov_unanch = np.zeros(3, dtype=np.int64)
    end_cov_unanch = np.zeros(3, dtype=np.int64)
    unanch_start_qual = 0.0
    unanch_end_qual = 0.0
    conf_l = conf_r = susp_l = susp_r = 0

    be_picky = consider_anchor_information and category == AlleleCategory.INSERTION
    if be_picky:
        first_base = int(get_allele_type(alt_allele[1]))
        last_base = int(get_allele_type(alt_allele[-1]))
    else:
        first_base = last_base = int(AlleleType.N)

    unanchored_support = allele_support - well_anchored_support

    if not be_picky:
        rs = _flat_rows(source, start_pos)
        re_ = _flat_rows(source, end_pos)
        zc = [[0] * 3 for _ in range(6)]
        zq = [[0.0] * 3 for _ in range(6)]
        cs, qs = (rs[0].tolist(), rs[1].tolist()) if rs else (zc, zq)
        ce, qe = (re_[0].tolist(), re_[1].tolist()) if re_ else (zc, zq)
        sum_q = res.sum_of_base_quality
        s0 = s1 = s2 = e0 = e1 = e2 = 0
        for a in _COV_ALLELES:
            ca_ = cs[a]
            cb_ = ce[a]
            s0 += ca_[0]
            e0 += cb_[0]
            s1 += ca_[1]
            e1 += cb_[1]
            s2 += ca_[2]
            e2 += cb_[2]
        for d in range(NUM_DIRECTION_TYPES):
            for a in _COV_ALLELES:
                sum_q += qs[a][d]
                sum_q += qe[a][d]
        res.sum_of_base_quality = sum_q
        conf_l += s0 + s1 + s2
        conf_r += e0 + e1 + e2
        s0 += -(-s2 // 2)
        s1 += s2 // 2
        e0 += -(-e2 // 2)
        e1 += e2 // 2
        exact_total = np.float32(0.0)
        for d, (sc_d, ec_d) in enumerate(((s0, e0), (s1, e1))):
            if presume_anchored:
                exact = np.float32(sc_d + ec_d) / np.float32(2.0)
            else:
                exact = np.float32(min(sc_d, ec_d))
            res.coverage_by_direction[d] = int(exact)
            exact_total += exact
        res.total_coverage = int(exact_total)
        res.reference_support = max(0, res.total_coverage - allele_support)
        res.suspicious_coverage_start = susp_l
        res.confident_coverage_start = conf_l
        res.suspicious_coverage_end = susp_r
        res.confident_coverage_end = conf_r
        return res

    for d in range(NUM_DIRECTION_TYPES):
        for a in _COV_ALLELES:
            anchored_only_end = be_picky and a == first_base
            anchored_only_start = be_picky and a == last_base
            min_anchor_end = length if anchored_only_end else 0
            min_anchor_start = length if anchored_only_start else 0

            sc = _count(source, start_pos, a, d, min_anchor_start)
            start_cov[d] += sc
            ec = _count(source, end_pos, a, d, min_anchor_end, from_end=True)
            end_cov[d] += ec
            conf_l += sc
            conf_r += ec
            res.sum_of_base_quality += _qual(source, start_pos, a, d,
                                             min_anchor_start)
            res.sum_of_base_quality += _qual(source, end_pos, a, d,
                                             min_anchor_end, from_end=True)

            if be_picky and unanchored_support > 0:
                if min_anchor_start > 0:
                    u = _count(source, start_pos, a, d, 0,
                               max_anchor=min_anchor_start - 1)
                    start_cov_unanch[d] += u
                    susp_l += u
                    unanch_start_qual += _qual(
                        source, start_pos, a, d, 0,
                        max_anchor=min_anchor_start - 1)
                if min_anchor_end > 0:
                    u = _count(source, end_pos, a, d, 0, from_end=True,
                               max_anchor=min_anchor_end - 1)
                    end_cov_unanch[d] += u
                    susp_r += u
                    unanch_end_qual += _qual(
                        source, start_pos, a, d, 0, from_end=True,
                        max_anchor=min_anchor_end - 1)

    if be_picky:
        truly_anchored = ((conf_l - susp_r) + (conf_r - susp_l)) / 2.0
        anchored_vf = 0.0 if truly_anchored <= 0 else well_anchored_support / truly_anchored
        total_susp = susp_l + susp_r
        unanch_vf = 0.0 if total_susp == 0 else unanchored_support / float(total_susp)
        weight = max(0.0, 1.0 if anchored_vf == 0 else min(1.0, unanch_vf / anchored_vf))
        res.unanchored_coverage_weight = weight
        for d in range(NUM_DIRECTION_TYPES):
            start_cov[d] += int(start_cov_unanch[d] * weight)
            end_cov[d] += int(end_cov_unanch[d] * weight)
            res.sum_of_base_quality += unanch_start_qual * weight
            res.sum_of_base_quality += unanch_end_qual * weight

    _redistribute_stitched(start_cov)
    _redistribute_stitched(end_cov)

    exact_total = np.float32(0.0)
    for d in range(2):
        if presume_anchored:
            exact = np.float32(int(start_cov[d]) + int(end_cov[d])) / np.float32(2.0)
        else:
            exact = np.float32(min(int(start_cov[d]), int(end_cov[d])))
        res.coverage_by_direction[d] = int(exact)
        exact_total += exact

    res.total_coverage = int(exact_total)
    res.reference_support = max(0, res.total_coverage - allele_support)
    res.suspicious_coverage_start = susp_l
    res.confident_coverage_start = conf_l
    res.suspicious_coverage_end = susp_r
    res.confident_coverage_end = conf_r
    return res


def coverage_fields(res):
    """A CoverageResult's fields, floats as their f64 bits."""
    out = {}
    for name in ("total_coverage", "reference_support", "num_no_calls",
                 "confident_coverage_start", "confident_coverage_end",
                 "suspicious_coverage_start", "suspicious_coverage_end",
                 "allele_support_adjustment"):
        v = getattr(res, name)
        assert isinstance(v, int), name
        out[name] = v
    for name in ("sum_of_base_quality", "unanchored_coverage_weight"):
        v = getattr(res, name)
        assert isinstance(v, float), name
        out[name] = struct.pack("<d", v)
    cov = res.coverage_by_direction
    assert cov.dtype == np.int64 and cov.shape == (NUM_DIRECTION_TYPES,)
    out["coverage_by_direction"] = cov.tolist()
    return out


# -- counts and alleles -------------------------------------------------------

@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """{flow: (PileupCounts, the spanning alleles the caller scored)} from
    one run of each read flow on a messy 20 kb workload at 300x."""
    tmp = str(tmp_path_factory.mktemp("spanning"))
    bam, genome = write_synthetic_workload(tmp, 1, 20_000, 60_000, seed=11)
    out = {}
    for flow in ("native", "python"):
        seen, copies = [], {}
        coverage = AlleleCaller._coverage

        def spy(self, source, alleles):
            # the native pass's tables live in the reader's memory, which
            # goes with the run: keep copies
            pc = copies.get(id(source.pc))
            if pc is None:
                pc = copies[id(source.pc)] = dataclasses.replace(
                    source.pc, **{f: getattr(source.pc, f).copy() for f in (
                        "block_keys", "counts_t", "qual_t",
                        "anchored_positions", "anchored_counts",
                        "anchored_quals")})
            seen.append((pc, [
                (a.category, a.position, a.ref_allele, a.alt_allele,
                 a.allele_support, a.well_anchored_support)
                for a in alleles if a.category in (INS, DEL, MNV)]))
            return coverage(self, source, alleles)

        mp = pytest.MonkeyPatch()
        mp.setattr(AlleleCaller, "_coverage", spy)
        if flow == "python":
            mp.setattr(torch_app, "open_bam", lambda path:
                       native.open_bam(path, prefer_native=False))
        try:
            assert torch_main(["-bam", bam, "-g", genome, "-o",
                               os.path.join(tmp, flow), "-backend", "numpy",
                               "-device", "cpu"]) == 0
        finally:
            mp.undo()
        assert len(copies) == 1
        out[flow] = (seen[0][0], [r for _, rows in seen for r in rows])
    return out


def _hand_counts(rng, anchor_size=5, block_size=50):
    """Random PileupCounts over blocks 1, 2 and 4 (positions 101-150
    untouched), anchored rows at every other position of 1-230."""
    keys = np.array([1, 2, 4], np.int64)
    k = num_anchor_indexes(anchor_size)
    shape = (len(keys), block_size, 6, 3)
    counts = rng.integers(0, 40, shape).astype(np.int32)
    quals = rng.random(shape) * 10.0 ** rng.integers(-3, 4, shape)
    ap = np.arange(1, 231, 2, dtype=np.int64)
    ac = rng.integers(0, 9, (len(ap), 6, 3, k)).astype(np.int32)
    aq = rng.random((len(ap), 6, 3, k)) * 10.0 ** rng.integers(
        -3, 4, (len(ap), 6, 3, k))
    return PileupCounts(keys, block_size, anchor_size, counts, quals, ap, ac,
                        aq)


def _insertion(rng, ref, n_ins, first=None, last=None):
    bases = list(rng.choice(list("ACGTN"), n_ins))
    if first is not None:
        bases[0] = first
    if last is not None:
        bases[-1] = last
    return ref + "".join(bases)


def _hand_rows(rng, positions, kinds, lengths):
    rows = []
    for pos in positions:
        for kind in kinds:
            for n in lengths:
                ref = str(rng.choice(list("ACGT")))
                if kind == "I":
                    rows.append((INS, pos, ref, _insertion(rng, ref, n)))
                elif kind == "D":
                    rows.append((DEL, pos, ref + "A" * n, ref))
                else:
                    rows.append((MNV, pos, "C" * (n + 1), "G" * (n + 1)))
    return rows


def _supports(rng, rows, unanchored):
    """Each (category, position, ref, alt) with a support and a
    well-anchored support: unanchored "zero" (all well anchored), "above"
    (some not), or "mixed"."""
    out = []
    for i, r in enumerate(rows):
        sup = int(rng.integers(1, 60))
        if unanchored == "zero" or (unanchored == "mixed" and i % 3 == 0):
            well = sup
        else:
            well = int(rng.integers(0, sup))
        out.append((*r, sup, well))
    return out


CASES = {
    # read flows: the caller's own alleles, then the same positions again
    # with every kind and with support that is partly unanchored
    "native_indels": dict(flow="native"),
    "python_indels": dict(flow="python"),
    "native_all_kinds_unanchored": dict(flow="native", kinds="IDM",
                                        unanchored="above"),
    "python_all_kinds_well_anchored": dict(flow="python", kinds="IDM",
                                           unanchored="zero"),
    "native_no_anchor_information": dict(flow="native", kinds="IDM",
                                         anchor=False),
    "native_stitched": dict(flow="native", kinds="ID", stitched=True),
    "python_stitched_no_anchor_information": dict(
        flow="python", kinds="ID", stitched=True, anchor=False),
    # hand-built counts
    "hand_deletions": dict(kinds="D"),
    "hand_insertions": dict(kinds="I"),
    "hand_mnvs": dict(kinds="M"),
    "hand_insertions_well_anchored": dict(kinds="I", unanchored="zero"),
    "hand_no_anchor_information": dict(kinds="IDM", anchor=False),
    "hand_stitched": dict(kinds="IDM", stitched=True),
    "hand_equal_first_and_last_base": dict(kinds="I", equal_ends=True),
    "hand_lengths_at_and_above_anchor": dict(kinds="ID", lengths=(4, 5, 6, 13)),
    "hand_untouched_and_unanchored": dict(kinds="IDM", untouched=True),
    "hand_anchor_size_2": dict(kinds="IDM", anchor_size=2,
                               lengths=(1, 2, 3)),
    "empty": dict(kinds=""),
}


def _case_rows(case, flows):
    spec = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    unanchored = spec.get("unanchored", "mixed")
    if "flow" in spec:
        pc, alleles = flows[spec["flow"]]
        assert {r[0] for r in alleles} == {INS, DEL}
        rows = list(alleles)
        if "kinds" in spec:
            positions = sorted({r[1] for r in alleles})[::4]
            rows = _supports(rng, _hand_rows(rng, positions, spec["kinds"],
                                             (1, 2, 6)), unanchored)
    else:
        pc = _hand_counts(rng, spec.get("anchor_size", 5))
        if spec.get("untouched"):
            # block 3 is untouched; the even positions have no anchored row
            positions = list(range(96, 156, 2)) + list(range(97, 157, 6))
        else:
            positions = list(range(2, 240, 3))
        lengths = spec.get("lengths", (1, 2, 3))
        rows = _hand_rows(rng, positions, spec["kinds"], lengths)
        if spec.get("equal_ends"):
            rows = [(c, p, r, _insertion(rng, r, n, first=b, last=b))
                    for (c, p, r, _), n, b in zip(
                        rows, rng.integers(1, 8, len(rows)),
                        rng.choice(list("ACGTN"), len(rows)))]
        rows = _supports(rng, rows, unanchored)
    source = AlleleSource(pc, expect_stitched_reads=spec.get("stitched",
                                                             False))
    return spec, source, rows, spec.get("anchor", True)


def _columns(source, rows, anchor):
    first = [int(get_allele_type(alt[1])) if c == INS else int(AlleleType.N)
             for c, _, _, alt, _, _ in rows]
    last = [int(get_allele_type(alt[-1])) if c == INS else int(AlleleType.N)
            for c, _, _, alt, _, _ in rows]
    return spanning_coverage_columns(
        source, [int(r[0]) for r in rows], [r[1] for r in rows],
        [len(r[2]) for r in rows], [len(r[3]) for r in rows], first, last,
        [r[4] for r in rows], [r[5] for r in rows], anchor)


@pytest.mark.parametrize("case", list(CASES))
def test_columns_equal_the_frozen_per_allele_oracle(flows, case):
    spec, source, rows, anchor = _case_rows(case, flows)
    cols = _columns(source, rows, anchor)
    assert len(cols.total_coverage) == len(rows)
    want = [frozen_spanning_coverage(source, *r, anchor) for r in rows]
    for i, (r, w) in enumerate(zip(rows, want)):
        assert coverage_fields(cols.result(i)) == coverage_fields(w), r
    # the one-row case, on a share of the rows
    for r, w in list(zip(rows, want))[::7]:
        got = spanning_coverage(source, *r, anchor)
        assert coverage_fields(got) == coverage_fields(w), r

    # what each case claims to hold, it holds
    if spec.get("kinds") == "":
        assert rows == []
        return
    assert len(rows) > 20
    cats = {r[0] for r in rows}
    assert cats == {{"I": INS, "D": DEL, "M": MNV}[k]
                    for k in spec.get("kinds", "ID")}
    picky = [w for r, w in zip(rows, want) if r[0] == INS and anchor]
    if picky and "kinds" in spec and spec.get("unanchored") != "zero":
        # unanchored support met anchor-windowed counts, and weighed them
        assert any(w.suspicious_coverage_start + w.suspicious_coverage_end
                   for w in picky)
        assert any(0.0 < w.unanchored_coverage_weight < 1.0 for w in picky)
    if spec.get("unanchored") == "zero" or not picky:
        assert all(w.suspicious_coverage_start == w.suspicious_coverage_end
                   == 0 for w in want)
    if not anchor:
        assert all(w.unanchored_coverage_weight == 0.0 for w in want)
    if spec.get("equal_ends"):
        assert all(alt[1] == alt[-1] for _, _, _, alt, _, _ in rows)
    if spec.get("lengths"):
        ins_or_del = {max(len(r[2]), len(r[3])) - 1 for r in rows}
        a = source.pc.anchor_size
        assert min(ins_or_del) < a <= max(ins_or_del) and a in ins_or_del
    if spec.get("untouched"):
        pc = source.pc
        assert any(pc.pos_index(r[1]) < 0 for r in rows)
        assert any(_anchored_row(pc, r[1]) < 0 <= pc.pos_index(r[1])
                   for r in rows)
        assert any(w.total_coverage == 0 for w in want)
    if spec.get("stitched"):
        assert any(r[0] == INS for r in rows)


def test_anchored_rows_find_each_position_s_row():
    rng = np.random.default_rng(5)
    pc = _hand_counts(rng)
    pos = np.arange(-3, 260)
    assert pc.anchored_rows(pos).tolist() == [_anchored_row(pc, p)
                                              for p in pos.tolist()]
    assert (pc.anchored_rows(pos) >= 0).sum() == len(pc.anchored_positions)
    empty = PileupCounts(pc.block_keys, pc.block_size, pc.anchor_size,
                         pc.counts_t, pc.qual_t, np.empty(0, np.int64),
                         pc.anchored_counts[:0], pc.anchored_quals[:0])
    assert empty.anchored_rows(pos).tolist() == [-1] * len(pos)
