"""AlleleSource: query facade over the pileup count tensors.

Provides the reference IAlleleSource queries (GetAlleleCount /
GetSumOfAlleleBaseQualities / GetGappedMnvRefCount) against the block-tiled
PileupCounts (RegionStateManager query side, cs:225-260): full-anchor-range
totals by position, one at a time or as columns. The anchor-windowed
queries of spanning coverage read the sparse anchor-resolved rows directly
(ops/coverage.spanning_coverage_columns).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pisces_tpu_torch.pileup.counts import PileupCounts


class AlleleSource:
    def __init__(self, counts: PileupCounts, expect_stitched_reads: bool = False,
                 amplicon_coverage: Optional[Dict[int, Dict[str, int]]] = None):
        self.pc = counts
        self.expect_stitched_reads = expect_stitched_reads
        self.gapped_mnv_ref_counts: Dict[int, int] = {}
        self.amplicon_coverage = amplicon_coverage or {}
        self._flat_counts, self._flat_quals = counts.totals_flat()

    def get_amplicon_coverage(self, position: int) -> Dict[str, int]:
        """GetCoverageByAmplicon equivalent (RegionState amplicon slots)."""
        return self.amplicon_coverage.get(position, {})

    def get_sum_of_base_qualities(self, position: int, allele_type: int,
                                  direction: int) -> float:
        """GetSumOfAlleleBaseQualities over the full anchor range."""
        row = int(self.pc.pos_index(position))
        if row < 0:
            return 0.0
        return float(self._flat_quals[row, allele_type, direction])

    def flat_rows(self, position: int):
        """(counts_row, quals_row) views [6,3] for a position's full-range
        totals, or None when untouched — lets a per-allele coverage walk
        (CoverageCalculator.CalculateSinglePoint) fetch its position ONCE
        instead of issuing a scalar query per allele and direction."""
        row = self.pc.pos_index(position)
        if row < 0:
            return None
        return self._flat_counts[row], self._flat_quals[row]

    def flat_columns(self, pos):
        """(counts, quals) [n, 6, 3] of the full-range totals at 1-based
        positions `pos`, one gather; zeros where a position is untouched."""
        rows = np.atleast_1d(self.pc.pos_index(pos))
        counts, quals = self._flat_counts, self._flat_quals
        if len(counts) == 0:
            shape = (len(rows),) + counts.shape[1:]
            return np.zeros(shape, counts.dtype), np.zeros(shape, quals.dtype)
        safe = np.maximum(rows, 0)
        c, q = counts[safe], quals[safe]
        miss = rows < 0
        if miss.any():
            c = np.where(miss[:, None, None], 0, c)
            q = np.where(miss[:, None, None], 0.0, q)
        return c, q

    def get_gapped_mnv_ref_count(self, position: int) -> int:
        return self.gapped_mnv_ref_counts.get(position, 0)

    def add_gapped_mnv_ref_counts(self, support: Dict[int, int]) -> None:
        for pos, count in support.items():
            self.gapped_mnv_ref_counts[pos] = (
                self.gapped_mnv_ref_counts.get(pos, 0) + count)
