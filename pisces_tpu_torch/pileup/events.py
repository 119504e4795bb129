"""CIGAR expansion: columnar read batches -> flat per-base event streams.

This replaces the reference's per-read hot loops
(RegionStateManager.AddAlleleCounts, Pisces.Processing/RegionState/
RegionStateManager.cs:118-220) with vectorized event generation. The output
is a flat stream of (genomic position, allele type, direction, anchor index,
base-quality error) tuples that the device scatter-add kernel folds into the
count tensor.

All genomic positions here are 1-based (reference/VCF convention).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pisces_tpu_torch.domain.types import AlleleType, DirectionType
from pisces_tpu_torch.io.bam import (
    OP_CONSUMES_READ, OP_CONSUMES_REF, OP_D, OP_S, FLAG_REVERSE,
    ReadBatch,
)

# precomputed 10^(-q/10) for q in [0,127] (RegionStateManager.AddAlleleCounts
# stores Math.Pow(10, -q/10) per base)
QUAL_TO_ERR = np.power(10.0, -np.arange(128, dtype=np.float64) / 10.0)


@dataclass
class BaseEvents:
    """Flat per-base pileup events for one chromosome batch."""

    gpos: np.ndarray       # int64 [E] 1-based genomic position
    allele: np.ndarray     # int8  [E] AlleleType code (N substituted if low qual)
    direction: np.ndarray  # int8  [E] DirectionType
    anchor: np.ndarray     # int8  [E] anchor index in [0, 2A]
    qerr: np.ndarray       # float32 [E] 10^(-q/10); 0 for deletion events
    is_deletion_gap: np.ndarray  # bool [E] True for gap/terminal deletion events
    read_start: np.ndarray = None  # int64 [E] 1-based start of the source read
    # (shard routing key for mesh execution: all events of a read are owned
    # by the position shard containing the read's start, mirroring the
    # reference's read-to-block ingestion at RegionStateManager.cs:118-220)


@dataclass
class ExpandedBases:
    """Per-sequenced-base expansion of a read batch."""

    read_idx: np.ndarray   # int32 [B] which read
    seq_idx: np.ndarray    # int64 [B] global index into batch.seq/qual
    gpos: np.ndarray       # int64 [B] 1-based ref position; -1 if not mapped (S/I)


def expand_batch(batch: ReadBatch, keep: np.ndarray) -> ExpandedBases:
    """Build the position map for every sequenced base of the kept reads.

    Fully vectorized over the flat cigar arrays (no per-read Python loop);
    cached on the batch so events/candidates share one expansion.
    """
    cache = getattr(batch, "_expand_cache", None)
    if cache is not None and np.array_equal(cache[0], keep):
        return cache[1]
    if keep.sum() == 0:
        z = np.empty(0, dtype=np.int64)
        ex = ExpandedBases(z.astype(np.int32), z, z)
        batch._expand_cache = (keep.copy(), ex)
        return ex

    n_ops_per_read = np.diff(batch.cigar_off)
    op_read_idx = np.repeat(np.arange(batch.n, dtype=np.int32), n_ops_per_read)
    ops = batch.cigar_ops
    lens = batch.cigar_lens.astype(np.int64)
    consumes_read = OP_CONSUMES_READ[ops]
    consumes_ref = OP_CONSUMES_REF[ops]

    # per-op exclusive prefix sums that reset at read starts
    g_read = np.concatenate(([0], np.cumsum(lens * consumes_read)))[:-1]
    g_ref = np.concatenate(([0], np.cumsum(lens * consumes_ref)))[:-1]
    first_op = batch.cigar_off[:-1]
    # reads with zero ops map to 0 safely (clipped below by op mask)
    safe_first = np.minimum(first_op, max(len(ops) - 1, 0))
    read_cum = g_read - g_read[safe_first][op_read_idx] if len(ops) else g_read
    ref_cum = g_ref - g_ref[safe_first][op_read_idx] if len(ops) else g_ref

    op_keep = keep[op_read_idx] & consumes_read
    rd_ops_idx = np.nonzero(op_keep)[0]
    rd_lens = lens[rd_ops_idx]
    total = int(rd_lens.sum())
    rep = np.repeat(rd_ops_idx, rd_lens)
    starts = np.concatenate(([0], np.cumsum(rd_lens)))[:-1]
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, rd_lens)

    read_idx = op_read_idx[rep]
    seq_idx = batch.seq_off[read_idx] + read_cum[rep] + within
    mapped = OP_CONSUMES_REF[ops[rep]]
    pos1 = batch.pos.astype(np.int64) + 1
    gpos = np.where(mapped, pos1[read_idx] + ref_cum[rep] + within, -1)
    ex = ExpandedBases(read_idx, seq_idx, gpos)
    batch._expand_cache = (keep.copy(), ex)
    return ex


def read_directions(batch: ReadBatch) -> np.ndarray:
    """Per-read direction (no stitched XD support yet: reverse-strand flag)."""
    return np.where((batch.flag & FLAG_REVERSE) != 0,
                    np.int8(DirectionType.REVERSE),
                    np.int8(DirectionType.FORWARD))


def anchor_indexes(gpos, start_pos, end_pos, anchor_size: int) -> np.ndarray:
    """Vectorized RegionStateManager.GetAnchorType (cs:83-116).

    left = pos - start, right = end - pos (both >= 0 for mapped bases);
    well-anchored index A if min(left,right) >= A, else the small-side index:
    left side -> left, right side -> 2A - right.
    """
    left = (gpos - start_pos).astype(np.int32)
    right = (end_pos - gpos).astype(np.int32)
    num_idx = 2 * anchor_size + 1
    out = np.full(gpos.shape, anchor_size, dtype=np.int8)
    right_small = (left >= right) & (right < anchor_size)
    np.copyto(out, (num_idx - right - 1).astype(np.int8), where=right_small)
    left_small = (left < right) & (left < anchor_size)
    np.copyto(out, left.astype(np.int8), where=left_small)
    return out


def build_base_events(batch: ReadBatch, keep: np.ndarray, min_base_quality: int,
                      anchor_size: int,
                      base_dirs: np.ndarray = None) -> BaseEvents:
    """Generate the full pileup event stream (mapped bases + deletion gaps +
    terminal deletions) for the kept reads.

    base_dirs: optional per-sequenced-base direction codes (stitched XD
    support, pileup/directions.batch_base_directions); defaults to per-read
    strand directions.
    """
    ex = expand_batch(batch, keep)
    dirs = read_directions(batch)
    num_idx = 2 * anchor_size + 1

    mapped = ex.gpos >= 0
    m_read = ex.read_idx[mapped]
    m_seq = ex.seq_idx[mapped]
    m_gpos = ex.gpos[mapped]

    start1 = batch.pos.astype(np.int64) + 1
    end1 = batch.end_pos.astype(np.int64) + 1

    quals = batch.qual[m_seq]
    allele = batch.seq[m_seq].astype(np.int8)
    allele = np.where(quals < min_base_quality, np.int8(AlleleType.N), allele)
    anchor = anchor_indexes(m_gpos, start1[m_read], end1[m_read], anchor_size)
    direction = base_dirs[m_seq] if base_dirs is not None else dirs[m_read]
    qerr = QUAL_TO_ERR[quals].astype(np.float32)

    # --- deletion gap events -------------------------------------------------
    # prev mapped gpos within the same read; first mapped base uses pos-1
    first_of_read = np.empty(len(m_read), dtype=bool)
    if len(m_read):
        first_of_read[0] = True
        first_of_read[1:] = m_read[1:] != m_read[:-1]
    prev_gpos = np.empty_like(m_gpos)
    if len(m_gpos):
        prev_gpos[1:] = m_gpos[:-1]
    prev_gpos[first_of_read] = start1[m_read[first_of_read]] - 1
    gap = m_gpos - prev_gpos - 1

    # deletion quality: qual at current sequenced base and at sequenced base-1
    # (CandidateVariantFinder.CheckDeletionQuality; note index-1 is the previous
    # *sequenced* base which may be soft-clipped or inserted)
    local_idx = m_seq - batch.seq_off[m_read]
    prev_qual = np.where(local_idx > 0,
                         batch.qual[np.maximum(m_seq - 1, 0)], quals)
    del_q_ok = (quals >= min_base_quality) & (prev_qual >= min_base_quality)

    has_gap = (gap > 0) & del_q_ok
    gap_src = np.nonzero(has_gap)[0]
    gap_counts = gap[gap_src]
    rep = np.repeat(gap_src, gap_counts)
    starts = np.concatenate(([0], np.cumsum(gap_counts)))[:-1]
    within = np.arange(int(gap_counts.sum()), dtype=np.int64) - np.repeat(starts, gap_counts)
    d_gpos = prev_gpos[rep] + 1 + within
    d_dir = direction[rep]
    d_anchor = anchor[rep]  # anchor of the current (following) base

    # --- terminal deletion events -------------------------------------------
    t_gpos_l, t_dir_l, t_anchor_l, t_start_l = [], [], [], []
    # vectorized pre-filter: only reads whose cigar ends in D (or D before S)
    n_ops = np.diff(batch.cigar_off)
    last_i = np.maximum(batch.cigar_off[1:] - 1, 0)
    prev_i = np.maximum(batch.cigar_off[1:] - 2, 0)
    last_op_arr = batch.cigar_ops[last_i] if len(batch.cigar_ops) else np.empty(0, np.uint8)
    prev_op_arr = batch.cigar_ops[prev_i] if len(batch.cigar_ops) else np.empty(0, np.uint8)
    has_term_d = keep & (n_ops > 0) & (
        (last_op_arr == OP_D) | ((n_ops >= 2) & (last_op_arr == OP_S)
                                 & (prev_op_arr == OP_D)))
    kept = np.nonzero(has_term_d)[0]
    for i in kept:
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        ops = batch.cigar_ops[s:e]
        lens = batch.cigar_lens[s:e]
        if len(ops) == 0:
            continue
        ends_in_d = ops[-1] == OP_D
        ends_in_d_before_s = len(ops) >= 2 and ops[-1] == OP_S and ops[-2] == OP_D
        if not (ends_in_d or ends_in_d_before_s):
            continue
        rl = batch.read_len(i)
        dlen = int(lens[-2] if ends_in_d_before_s else lens[-1])
        len_before_del = rl - int(lens[-1]) if ends_in_d_before_s else rl
        q = batch.qual[batch.seq_off[i]:batch.seq_off[i + 1]]
        chk_idx = len_before_del if ends_in_d_before_s else rl - 1
        if len(q) == 0:
            continue
        after = q[chk_idx] if chk_idx < len(q) else q[chk_idx - 1]
        before = q[chk_idx - 1] if chk_idx > 0 else after
        if not (after >= min_base_quality and before >= min_base_quality):
            continue
        # last mapped position of the read
        last_mapped = int(end1[i]) if not ends_in_d else int(end1[i]) - dlen
        if ends_in_d_before_s:
            last_mapped = int(end1[i]) - dlen
        if base_dirs is not None:
            # direction of the check-index base (reference semantics)
            di = min(chk_idx, rl - 1)
            t_direction = np.int8(base_dirs[batch.seq_off[i] + di])
        else:
            t_direction = dirs[i]
        t_gpos_l.append(np.arange(last_mapped + 1, last_mapped + dlen + 1, dtype=np.int64))
        t_dir_l.append(np.full(dlen, t_direction, dtype=np.int8))
        t_anchor_l.append(np.full(dlen, num_idx - 1, dtype=np.int8))
        t_start_l.append(np.full(dlen, start1[i], dtype=np.int64))

    t_gpos = np.concatenate(t_gpos_l) if t_gpos_l else np.empty(0, np.int64)
    t_dir = np.concatenate(t_dir_l) if t_dir_l else np.empty(0, np.int8)
    t_anchor = np.concatenate(t_anchor_l) if t_anchor_l else np.empty(0, np.int8)
    t_start = np.concatenate(t_start_l) if t_start_l else np.empty(0, np.int64)

    n_del = len(d_gpos) + len(t_gpos)
    gpos = np.concatenate([m_gpos, d_gpos, t_gpos])
    allele_all = np.concatenate([
        allele,
        np.full(n_del, np.int8(AlleleType.DELETION)),
    ])
    dir_all = np.concatenate([direction, d_dir, t_dir])
    anchor_all = np.concatenate([anchor, d_anchor, t_anchor])
    qerr_all = np.concatenate([qerr, np.zeros(n_del, dtype=np.float32)])
    is_del = np.concatenate([np.zeros(len(m_gpos), bool), np.ones(n_del, bool)])
    read_start = np.concatenate([start1[m_read], start1[m_read[rep]], t_start])

    return BaseEvents(gpos, allele_all, dir_all, anchor_all, qerr_all, is_del,
                      read_start)
