"""Block-tiled pileup count tensors.

The reference's RegionState holds, per 1000-bp block, dense tensors
  _alleleCounts[blockSize, 6 alleleTypes, 3 directions, 2A+1 anchorIndexes]
  _sumOfAlleleBaseQualities[same shape]
(RegionState.cs:18-66). The anchor axis is only ever consulted through
windowed reductions at spanning-variant endpoints (AlleleCountHelper.cs),
so this build keeps two structures:

  - dense anchor-summed totals [NB, B, 6, 3] for every touched block (the
    gVCF / single-point hot path; 18 ints per position instead of 198), and
  - anchor-resolved rows [K, 6, 3, 2A+1] only for the sparse positions named
    by the candidate set (spanning coverage windows).

The default read flow builds both in the C++ pileup pass
(io/native.native_pileup). The Python flow builds them from read events with
one scatter-add on a torch device (index_add_) or on the host in numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pisces_tpu_torch.domain.types import (
    NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, num_anchor_indexes,
)
from pisces_tpu_torch.options import REGION_SIZE
from pisces_tpu_torch.pileup.events import BaseEvents

_AD = NUM_ALLELE_TYPES * NUM_DIRECTION_TYPES  # 18


@dataclass
class PileupCounts:
    """Counts for the touched blocks of one chromosome."""

    block_keys: np.ndarray    # int64 [NB] sorted block keys (key k covers
                              # positions (k-1)*B+1 .. k*B; RegionStateManager.GetBlockKey)
    block_size: int
    anchor_size: int
    counts_t: np.ndarray      # int32 [NB, B, 6, 3] anchor-summed totals
    qual_t: np.ndarray        # float64 [NB, B, 6, 3]
    anchored_positions: np.ndarray  # int64 [K] sorted 1-based positions
    anchored_counts: np.ndarray     # int32 [K, 6, 3, 2A+1]
    anchored_quals: np.ndarray      # float64 [K, 6, 3, 2A+1]
    # native pileup only (io/native.native_pileup with reference codes):
    # int32 [NB*B, 8] per-position scoring tuples
    # [sup_f, sup_r, sup_s, cov_f, cov_r, cov_s, n_total, 0], and the
    # covered in-reference loci deduped to unique tuples: (positions int64
    # [L], unique tuples int64 [U, 6] in first-occurrence order, inverse
    # index int32 [L])
    pos_tuples: Optional[np.ndarray] = None
    gvcf_unique: Optional[tuple] = None
    # lazy {block_key: slot} map backing the scalar pos_index fast path
    _slot_map: Optional[dict] = None

    def block_slot(self, pos) -> np.ndarray:
        keys = (np.asarray(pos, dtype=np.int64) + self.block_size - 1) // self.block_size
        slot = np.searchsorted(self.block_keys, keys)
        slot = np.minimum(slot, max(len(self.block_keys) - 1, 0))
        ok = (len(self.block_keys) > 0) & (self.block_keys[slot] == keys)
        return np.where(ok, slot, -1)

    def pos_index(self, pos) -> np.ndarray:
        """Row index into the flattened totals; -1 when untouched.
        Scalar queries (per-allele coverage walks, the collapser's
        frequencies) take a dict-lookup fast path: the numpy scalar
        round-trip measured ~20us per call."""
        if isinstance(pos, (int, np.integer)):
            m = self._slot_map
            if m is None:
                m = {int(k): i for i, k in enumerate(self.block_keys)}
                object.__setattr__(self, "_slot_map", m)
            slot = m.get((int(pos) + self.block_size - 1) // self.block_size)
            if slot is None:
                return -1
            return slot * self.block_size + (int(pos) - 1) % self.block_size
        pos = np.asarray(pos, dtype=np.int64)
        slot = self.block_slot(pos)
        within = (pos - 1) % self.block_size
        return np.where(slot >= 0, slot * self.block_size + within, -1)

    def totals_flat(self):
        nb = len(self.block_keys)
        return (self.counts_t.reshape(nb * self.block_size, NUM_ALLELE_TYPES,
                                      NUM_DIRECTION_TYPES),
                self.qual_t.reshape(nb * self.block_size, NUM_ALLELE_TYPES,
                                    NUM_DIRECTION_TYPES))

    def anchored_rows(self, pos) -> np.ndarray:
        """Rows of anchored_counts/quals for positions, one searchsorted on
        anchored_positions; -1 where a position has no anchored row."""
        pos = np.asarray(pos, dtype=np.int64)
        ap = self.anchored_positions
        if len(ap) == 0:
            return np.full(pos.shape, -1, np.int64)
        i = np.minimum(np.searchsorted(ap, pos), len(ap) - 1)
        return np.where(ap[i] == pos, i, -1)


def _empty(block_size, anchor_size):
    k = num_anchor_indexes(anchor_size)
    return PileupCounts(
        np.empty(0, np.int64), block_size, anchor_size,
        np.zeros((0, block_size, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES), np.int32),
        np.zeros((0, block_size, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES), np.float64),
        np.empty(0, np.int64),
        np.zeros((0, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k), np.int32),
        np.zeros((0, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k), np.float64))


def _totals_indices(ev: BaseEvents, block_keys, block_size):
    keys = (ev.gpos + block_size - 1) // block_size
    slot = np.searchsorted(block_keys, keys)
    within = (ev.gpos - 1) % block_size
    row = slot * block_size + within
    return (row * NUM_ALLELE_TYPES + ev.allele.astype(np.int64)) \
        * NUM_DIRECTION_TYPES + ev.direction.astype(np.int64)


def _anchored_indices(ev: BaseEvents, anchored_positions, anchor_size):
    """Linear indices into the sparse anchored tensor; -1 for events not at
    anchored positions."""
    k = num_anchor_indexes(anchor_size)
    i = np.searchsorted(anchored_positions, ev.gpos)
    i = np.minimum(i, max(len(anchored_positions) - 1, 0))
    hit = (len(anchored_positions) > 0) & (anchored_positions[i] == ev.gpos)
    lin = ((i * NUM_ALLELE_TYPES + ev.allele.astype(np.int64))
           * NUM_DIRECTION_TYPES + ev.direction.astype(np.int64)) * k \
        + ev.anchor.astype(np.int64)
    return np.where(hit, lin, -1)


def build_counts_host(ev: BaseEvents, block_size: int = REGION_SIZE,
                      anchor_size: int = 5,
                      anchored_positions: Optional[np.ndarray] = None
                      ) -> PileupCounts:
    """Host (numpy, f64 qual sums) pileup build - the parity reference."""
    if len(ev.gpos) == 0:
        return _empty(block_size, anchor_size)
    k = num_anchor_indexes(anchor_size)
    keys = (ev.gpos + block_size - 1) // block_size
    block_keys = np.unique(keys)
    nb = len(block_keys)

    lin = _totals_indices(ev, block_keys, block_size)
    size = nb * block_size * _AD
    # sort-based reduction (bincount with huge minlength thrashes memory)
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    qerr_s = ev.qerr.astype(np.float64)[order]
    uniq, start = np.unique(lin_s, return_index=True)
    counts_u = np.diff(np.append(start, len(lin_s)))
    qual_u = np.add.reduceat(qerr_s, start)
    counts_t = np.zeros(size, np.int32)
    qual_t = np.zeros(size, np.float64)
    counts_t[uniq] = counts_u
    qual_t[uniq] = qual_u
    shape_t = (nb, block_size, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES)

    if anchored_positions is None or len(anchored_positions) == 0:
        ap = np.empty(0, np.int64)
        ac = np.zeros((0, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k), np.int32)
        aq = np.zeros((0, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k), np.float64)
    else:
        ap = np.unique(np.asarray(anchored_positions, dtype=np.int64))
        alin = _anchored_indices(ev, ap, anchor_size)
        hit = alin >= 0
        asz = len(ap) * _AD * k
        ac = np.zeros(asz, np.int32)
        aq = np.zeros(asz, np.float64)
        np.add.at(ac, alin[hit], 1)
        np.add.at(aq, alin[hit], ev.qerr.astype(np.float64)[hit])
        ac = ac.reshape(len(ap), NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k)
        aq = aq.reshape(len(ap), NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k)

    return PileupCounts(block_keys, block_size, anchor_size,
                        counts_t.reshape(shape_t), qual_t.reshape(shape_t),
                        ap, ac, aq)


def _scatter_add(lin_idx: np.ndarray, qerr: np.ndarray, total: int,
                 device: torch.device):
    """Count and quality-sum scatter of one index stream on `device`:
    int32 counts, f32 quality sums (atomic adds on CUDA, so the order of the
    f32 additions is free there)."""
    idx = torch.from_numpy(np.ascontiguousarray(lin_idx, np.int64)).to(device)
    counts = torch.zeros(total, dtype=torch.int32, device=device)
    counts.index_add_(0, idx, torch.ones(len(idx), dtype=torch.int32,
                                         device=device))
    quals = torch.zeros(total, dtype=torch.float32, device=device)
    quals.index_add_(0, idx, torch.from_numpy(
        np.ascontiguousarray(qerr, np.float32)).to(device))
    return counts.cpu().numpy(), quals.cpu().numpy().astype(np.float64)


def build_counts_device(ev: BaseEvents, block_size: int = REGION_SIZE,
                        anchor_size: int = 5,
                        anchored_positions: Optional[np.ndarray] = None,
                        device: Optional[torch.device] = None
                        ) -> PileupCounts:
    """Device (torch index_add_) pileup build on `device`."""
    if device is None:
        raise ValueError("build_counts_device needs a torch device")
    if len(ev.gpos) == 0:
        return _empty(block_size, anchor_size)
    k = num_anchor_indexes(anchor_size)
    keys = (ev.gpos + block_size - 1) // block_size
    block_keys = np.unique(keys)
    nb = len(block_keys)
    lin = _totals_indices(ev, block_keys, block_size)
    size = nb * block_size * _AD

    counts, quals = _scatter_add(lin, ev.qerr, size, device)
    shape_t = (nb, block_size, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES)
    counts_t = counts.reshape(shape_t)
    qual_t = quals.reshape(shape_t)

    if anchored_positions is None or len(anchored_positions) == 0:
        ap = np.empty(0, np.int64)
        ac = np.zeros((0, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k), np.int32)
        aq = np.zeros((0, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k), np.float64)
    else:
        ap = np.unique(np.asarray(anchored_positions, dtype=np.int64))
        alin = _anchored_indices(ev, ap, anchor_size)
        hit = alin >= 0
        asz = len(ap) * _AD * k
        ac, aq = _scatter_add(alin[hit], ev.qerr[hit], asz, device)
        ac = ac.reshape(len(ap), NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k)
        aq = aq.reshape(len(ap), NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k)

    return PileupCounts(block_keys, block_size, anchor_size, counts_t, qual_t,
                        ap, ac, aq)


# ---------------------------------------------------------------------------
# Anchor-windowed lookups (AlleleCountHelper semantics)
# ---------------------------------------------------------------------------

def anchor_window_sum(arr_last_axis: np.ndarray, anchor_size: int, min_anchor: int,
                      max_anchor: Optional[int], from_end: bool) -> np.ndarray:
    """Sum counts over the anchor axis per AlleleCountHelper.GetAnchorAdjusted*.

    arr_last_axis: [..., K] with K = 2A+1; returns [...]. The selected
    entries are summed as a C-contiguous copy along its last axis: numpy
    sums each row of such a copy as it sums a 1-D array (pairwise, from
    the row's first entry), while a fancy index on the last axis leaves
    that axis strided and the reduction takes another order.
    """
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
    return np.ascontiguousarray(
        arr_last_axis[..., np.array(idx, dtype=np.intp)]).sum(axis=-1)


def candidate_anchor_positions(candidates, pad: int = 1) -> np.ndarray:
    """Positions whose anchor-resolved counts the spanning-coverage queries
    will need: a window around every non-SNV candidate."""
    from pisces_tpu_torch.domain.types import AlleleCategory
    out = []
    for c in candidates:
        if c.category in (AlleleCategory.SNV, AlleleCategory.REFERENCE):
            continue
        length = max(len(c.ref_allele), len(c.alt_allele))
        out.append(np.arange(c.position - pad, c.position + length + pad + 1))
    if not out:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate(out)).astype(np.int64)