"""Pileup counts of the plain reference, from the generated single-end read
arrays (the single_end layout's counts, with an empty stitched direction).

Per 1-based position, allele (A, G, C, T, N, deletion) and direction
(forward, reverse): every mapped base of every read counts once, as N
when its quality is under the minimum base quality; each deleted base
counts as a deletion when the bases on both sides of the gap pass that
minimum (the reference caller's RegionStateManager.AddAlleleCounts and
CandidateVariantFinder.CheckDeletionQuality). The read layout comes from
the generator's read classes, not from a BAM decode.
"""
from __future__ import annotations

import numpy as np

from portbench import gen
from portbench.reference.scoring import BASE_TO_ALLELE, DEL, N

# reads per block: bounds the int64 index arrays to a few hundred MB
BLOCK = 200_000


def chrom_counts(sample: gen.Sample, ch: gen.ChromReads,
                 min_base_quality: int) -> np.ndarray:
    """int64 [len(seq) + 1, 6, 2] counts (row 0 unused)."""
    L = sample.read_len
    layouts, dels, _spans, _cig = gen.class_layout(L)
    n_pos = len(ch.seq) + 1
    flat = np.zeros(n_pos * 12, np.int64)
    low_cols = np.arange(L - sample.tail_len, L)
    low_q_is_bad = sample.low_q < min_base_quality
    for c in range(5):
        idx_all = np.flatnonzero(ch.cls == c)
        m = layouts[c]
        cols = np.flatnonzero(m >= 0)
        offs = m[cols]
        for b0 in range(0, idx_all.size, BLOCK):
            idx = idx_all[b0:b0 + BLOCK]
            pos1 = ch.pos0[idx, None] + 1 + offs[None, :]
            allele = BASE_TO_ALLELE[ch.reads[idx][:, cols]].astype(np.int64)
            if low_q_is_bad:
                bad = ch.dip[idx, None] & np.isin(cols, low_cols)[None, :]
                allele[bad] = N
            d = ch.rev[idx].astype(np.int64)[:, None]
            key = (pos1 * 6 + allele) * 2 + d
            flat += np.bincount(key.ravel(), minlength=flat.size)
            if dels[c].size:
                # the gap's flanking bases: read columns before and after it
                h = L // 2
                before, after = h - 2, h - 1
                q_ok = ~(ch.dip[idx] & low_q_is_bad
                         & (np.isin(before, low_cols) | np.isin(after,
                                                               low_cols)))
                dpos = ch.pos0[idx, None] + 1 + dels[c][None, :]
                dkey = ((dpos * 6 + DEL) * 2 + d)[q_ok]
                flat += np.bincount(dkey.ravel(), minlength=flat.size)
    return flat.reshape(n_pos, 6, 2)
