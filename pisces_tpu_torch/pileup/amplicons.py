"""Per-position amplicon coverage tracking (XN tags).

Host-side name->count interning replacing RegionState's per-position amplicon
name/count slots (RegionState.cs:269-307): device tensors stay numeric, the
string work stays here.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

from pisces_tpu_torch.domain.types import AlleleType
from pisces_tpu_torch.io.bam import ReadBatch
from pisces_tpu_torch.pileup.events import expand_batch


def amplicon_coverage(batch: ReadBatch, keep: np.ndarray,
                      min_base_quality: int) -> Dict[int, Dict[str, int]]:
    """position (1-based) -> {amplicon name: coverage count}.

    A base contributes when it is mapped and not N-typed (low-quality bases
    count as N and are excluded, RegionStateManager.AddAlleleCounts:178-183).
    """
    out: Dict[int, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    if batch.xn_tags is None or not any(batch.xn_tags):
        return {}
    ex = expand_batch(batch, keep)
    mapped = ex.gpos >= 0
    m_read = ex.read_idx[mapped]
    m_seq = ex.seq_idx[mapped]
    m_gpos = ex.gpos[mapped]
    quals = batch.qual[m_seq]
    codes = batch.seq[m_seq]
    ok = (quals >= min_base_quality) & (codes != int(AlleleType.N))
    for ri, pos in zip(m_read[ok], m_gpos[ok]):
        name = batch.xn_tags[ri]
        if name:
            out[int(pos)][name] += 1
    return {p: dict(v) for p, v in out.items()}
