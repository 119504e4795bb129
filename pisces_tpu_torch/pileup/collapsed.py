"""UMI-collapsed read-type tracking (duplex/simplex x stitched).

Ports the collapsed-read machinery: XV/XW UMI tags mark collapsed reads
(duplex iff both nonzero), XR (or proper-pair flags) gives the read-pair
direction template, and each counted base contributes to per-position
ReadCollapsedType totals (Read extensions in Pisces.Domain/Models/Read.cs:17-71,
CollapsedRegionState / CollapedRegionStateManager.cs). Candidate support
carries the same categories (CandidateVariantFinder.Create:346-385), surfaced
in the VCF US column.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from pisces_tpu_torch.domain.types import (
    NUM_READ_COLLAPSED_TYPES, AlleleType, DirectionType, ReadCollapsedType,
)
from pisces_tpu_torch.io.bam import (
    FLAG_FIRST_MATE, FLAG_PROPER_PAIR, FLAG_REVERSE, ReadBatch,
)

RCT = ReadCollapsedType


def pair_direction(flag: int, xr: Optional[str]) -> Optional[str]:
    """Read.GetReadPairDirection: XR tag, else inferred from proper-pair flags."""
    if xr:
        return xr
    if flag & FLAG_PROPER_PAIR:
        d = "R" if flag & FLAG_REVERSE else "F"
        dm = "R" if d == "F" else "F"
        return d + dm if flag & FLAG_FIRST_MATE else dm + d
    return None


def is_collapsed(tags: Optional[dict]) -> bool:
    return bool(tags) and ("XV" in tags or "XW" in tags)


def is_duplex(tags: Optional[dict]) -> bool:
    if not tags:
        return False
    xv = tags.get("XV") or 0
    xw = tags.get("XW") or 0
    try:
        return int(xv) != 0 and int(xw) != 0
    except (TypeError, ValueError):
        return False


def collapsed_type(direction: int, duplex: bool,
                   pair_dir: Optional[str]) -> Optional[int]:
    """Read.GetReadCollapsedType."""
    stitched = direction == int(DirectionType.STITCHED)
    if duplex:
        return int(RCT.DUPLEX_STITCHED if stitched else RCT.DUPLEX_NON_STITCHED)
    if pair_dir == "FR":
        return int(RCT.SIMPLEX_FORWARD_STITCHED if stitched
                   else RCT.SIMPLEX_FORWARD_NON_STITCHED)
    if pair_dir == "RF":
        return int(RCT.SIMPLEX_REVERSE_STITCHED if stitched
                   else RCT.SIMPLEX_REVERSE_NON_STITCHED)
    return None  # FF/RR non-proper templates are not considered


def candidate_collapsed_counts(direction: int, duplex: bool,
                               pair_dir: Optional[str]) -> np.ndarray:
    """The per-candidate increment pattern (CandidateVariantFinder.Create):
    simplex fwd/rev types also bump the aggregate simplex bucket."""
    out = np.zeros(NUM_READ_COLLAPSED_TYPES, dtype=np.int64)
    t = collapsed_type(direction, duplex, pair_dir)
    if t is None:
        return out
    t = ReadCollapsedType(t)
    if t in (RCT.DUPLEX_NON_STITCHED, RCT.DUPLEX_STITCHED,
             RCT.SIMPLEX_STITCHED, RCT.SIMPLEX_NON_STITCHED):
        out[int(t)] += 1
    elif t == RCT.SIMPLEX_REVERSE_STITCHED:
        out[int(RCT.SIMPLEX_STITCHED)] += 1
        out[int(RCT.SIMPLEX_REVERSE_STITCHED)] += 1
    elif t == RCT.SIMPLEX_FORWARD_STITCHED:
        out[int(RCT.SIMPLEX_STITCHED)] += 1
        out[int(RCT.SIMPLEX_FORWARD_STITCHED)] += 1
    elif t == RCT.SIMPLEX_REVERSE_NON_STITCHED:
        out[int(RCT.SIMPLEX_NON_STITCHED)] += 1
        out[int(RCT.SIMPLEX_REVERSE_NON_STITCHED)] += 1
    elif t == RCT.SIMPLEX_FORWARD_NON_STITCHED:
        out[int(RCT.SIMPLEX_NON_STITCHED)] += 1
        out[int(RCT.SIMPLEX_FORWARD_NON_STITCHED)] += 1
    return out


def total_lookup_position(allele) -> int:
    """CollapsedCoverageCalculator start-point rule: totals for a spanning
    allele come from the spanning START position that CoverageCalculator
    passes down (CoverageCalculator.cs:30-41 — deletion spans
    [pos+1, pos+len], MNV/insertion start at pos), and
    CollapsedCoverageCalculator.CalculateSpanning always reads the
    collapsed counts at that start (CollapsedCoverageCalculator.cs:27-36).
    Point alleles use their own position (CalculateSinglePoint :18-25)."""
    from pisces_tpu_torch.domain.types import AlleleCategory
    if allele.category == AlleleCategory.DELETION:
        return allele.position + 1
    return allele.position


def assign_collapsed_totals(by_position, totals: Dict[int, np.ndarray]) -> None:
    """Attach per-position ReadCollapsedCountTotal to called alleles, the
    CollapsedCoverageCalculator pass (it runs inside Compute for collapsed+
    stitched sources, Factory.cs:197)."""
    for _pos, alleles_at in by_position.items():
        for a in alleles_at:
            t = totals.get(total_lookup_position(a))
            if t is not None:
                a.read_collapsed_count_total = t


def collapsed_total_counts(batch: ReadBatch, keep: np.ndarray,
                           min_base_quality: int,
                           base_dirs: Optional[np.ndarray] = None
                           ) -> Dict[int, np.ndarray]:
    """Per-position total collapsed-type counts: every counted base of a
    collapsed read (not N-typed) contributes its read-collapsed type
    (CollapsedRegionState.AddCollapsedReadCount call points)."""
    from pisces_tpu_torch.pileup.events import expand_batch, read_directions
    out: Dict[int, np.ndarray] = defaultdict(
        lambda: np.zeros(NUM_READ_COLLAPSED_TYPES, dtype=np.int64))
    if batch.extra_tags is None:
        return {}
    uniform = read_directions(batch)
    ex = expand_batch(batch, keep)
    mapped = ex.gpos >= 0
    m_read = ex.read_idx[mapped]
    m_seq = ex.seq_idx[mapped]
    m_gpos = ex.gpos[mapped]
    quals = batch.qual[m_seq]
    codes = batch.seq[m_seq]
    ok = (quals >= min_base_quality) & (codes != int(AlleleType.N))
    for ri, si, pos in zip(m_read[ok], m_seq[ok], m_gpos[ok]):
        tags = batch.extra_tags[ri]
        if not is_collapsed(tags):
            continue
        d = int(base_dirs[si]) if base_dirs is not None else int(uniform[ri])
        t = collapsed_type(d, is_duplex(tags),
                           pair_direction(int(batch.flag[ri]), tags.get("XR")))
        if t is not None:
            out[int(pos)][t] += 1
    return dict(out)
