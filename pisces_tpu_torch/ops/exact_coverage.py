"""Exact (read-spanning) coverage for spanning variants.

Port of ExactCoverageCalculator.cs:18-201 (CoverageMethod.Exact): instead of
reconciling endpoint pileup counts, count the reads that actually span the
variant window, assigning each spanning read its direction from its
direction map.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import (
    COVERAGE_CONTRIBUTING_ALLELES, AlleleCategory, DirectionType,
)
from pisces_tpu_torch.io.bam import OP_CONSUMES_READ, OP_CONSUMES_REF, ReadBatch
from pisces_tpu_torch.calling.source import AlleleSource

_COV = [int(a) for a in COVERAGE_CONTRIBUTING_ALLELES]


@dataclass
class ReadSummaries:
    """Per-read coverage summaries (RegionState.AddReadSummary source data):
    clip-adjusted start/end, per-base position + direction maps."""

    clip_start: np.ndarray      # [n] 1-based clip-adjusted start
    clip_end: np.ndarray        # [n] 1-based clip-adjusted end
    pos_maps: list              # [n] int arrays: per-base ref pos, -1 ins, -2 clip
    dir_maps: list              # [n] int8 arrays per sequenced base
    starts_with_ins: np.ndarray
    ends_with_ins: np.ndarray


def build_read_summaries(batch: ReadBatch, keep: np.ndarray,
                         base_dirs: Optional[np.ndarray] = None
                         ) -> ReadSummaries:
    kept = np.nonzero(keep)[0]
    n = len(kept)
    clip_start = np.zeros(n, np.int64)
    clip_end = np.zeros(n, np.int64)
    starts_ins = np.zeros(n, bool)
    ends_ins = np.zeros(n, bool)
    pos_maps = []
    dir_maps = []
    from pisces_tpu_torch.pileup.events import read_directions
    uniform = read_directions(batch)
    for j, i in enumerate(kept):
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        ops = batch.cigar_ops[s:e]
        lens = batch.cigar_lens[s:e]
        pos1 = int(batch.pos[i]) + 1
        prefix_clip = int(lens[0]) if len(ops) and ops[0] == 4 else 0
        suffix_clip = int(lens[-1]) if len(ops) and ops[-1] == 4 else 0
        clip_start[j] = pos1 - prefix_clip
        clip_end[j] = int(batch.end_pos[i]) + 1 + suffix_clip
        starts_ins[j] = len(ops) > 0 and ops[0] == 1
        ends_ins[j] = len(ops) > 0 and ops[-1] == 1
        read_len = int(batch.seq_off[i + 1] - batch.seq_off[i])
        pm = np.full(read_len, -1, np.int64)
        ref = pos1
        idx = 0
        for op, ln in zip(ops, lens):
            ln = int(ln)
            if op == 4:  # S -> -2 marker
                pm[idx:idx + ln] = -2
                idx += ln
            elif OP_CONSUMES_READ[op] and OP_CONSUMES_REF[op]:
                pm[idx:idx + ln] = np.arange(ref, ref + ln)
                ref += ln
                idx += ln
            elif OP_CONSUMES_READ[op]:
                idx += ln
            else:
                ref += ln
        pos_maps.append(pm)
        if base_dirs is not None:
            so = batch.seq_off[i]
            dir_maps.append(base_dirs[so:so + read_len])
        else:
            dir_maps.append(np.full(read_len, uniform[i], np.int8))
    return ReadSummaries(clip_start, clip_end, pos_maps, dir_maps,
                         starts_ins, ends_ins)


def _get_index_boundaries(start_pos: int, end_pos: int,
                          pm: np.ndarray) -> Tuple[int, int]:
    start_idx = -1
    end_idx = -1
    for i, p in enumerate(pm):
        if 0 <= p <= start_pos:
            start_idx = i
        if end_idx == -1 and p >= end_pos:
            end_idx = i
    if start_idx >= 0 and end_idx == -1 and len(pm) and pm[-1] == -2:
        for i in range(start_idx + 1, len(pm)):
            if pm[i] == -2:
                end_idx = i
                break
    if end_idx >= 0 and start_idx == -1 and len(pm) and pm[0] == -2:
        for i in range(end_idx - 1, -1, -1):
            if pm[i] == -2:
                start_idx = i
                break
    return start_idx, end_idx


def _get_direction(pre: int, post: int, dm: np.ndarray) -> int:
    if pre == -1 and post == -1:
        raise ValueError("invalid indices")
    if post == pre + 1:
        if pre == -1:
            return int(dm[post])
        if post == -1:
            return int(dm[pre])
        d = int(dm[pre])
        if d == int(DirectionType.STITCHED):
            d = int(dm[post])
        return d
    if post == -1:
        post = len(dm)
    direction = int(DirectionType.FORWARD)
    for i in range(pre + 1, post):
        direction = int(dm[i])
        if direction == int(DirectionType.STITCHED):
            break
    return direction


def exact_spanning_coverage(source: AlleleSource, summaries: ReadSummaries,
                            category: AlleleCategory, position: int,
                            length: int, allele_support: int):
    """Returns (coverage_by_direction[3], total, ref_support, sum_bq)."""
    if category == AlleleCategory.DELETION:
        preceding, trailing = position, position + length + 1
    elif category == AlleleCategory.MNV:
        preceding, trailing = position - 1, position + length
    else:  # insertion
        preceding, trailing = position, position + 1

    sum_bq = 0.0
    for d in range(3):
        for a in _COV:
            sum_bq += source.get_sum_of_base_qualities(preceding, a, d)
            sum_bq += source.get_sum_of_base_qualities(trailing, a, d)

    cov = np.zeros(3, np.int64)
    cand = np.nonzero((summaries.clip_end >= preceding)
                      & (summaries.clip_start <= trailing))[0]
    for j in cand:
        if (summaries.clip_end[j] == preceding and not summaries.ends_with_ins[j]):
            continue
        if (summaries.clip_start[j] == trailing and not summaries.starts_with_ins[j]):
            continue
        dm = summaries.dir_maps[j]
        uniq = np.unique(dm)
        if len(uniq) == 1:
            cov[int(uniq[0])] += 1
        else:
            pm = summaries.pos_maps[j]
            pre_i, post_i = _get_index_boundaries(preceding, trailing, pm)
            cov[_get_direction(pre_i, post_i, dm)] += 1

    total = int(cov.sum())
    ref_support = max(0, total - allele_support)
    return cov, total, ref_support, sum_bq
