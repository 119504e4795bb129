"""Least time of the score_tuples kernel on one H100, from its inputs.

Frozen copy of chip_smoke.py's tuple_kernel_ops, series_terms, the
per-term constants, TUPLE_BYTES, bound() and the peak table (commit
68f5a3446fa7), reading the tuples and the two outputs it needs (frequency,
genotype) as numpy arrays that the plain reference computed, not from the
program. Every add, multiply, divide, compare and transcendental counts as
one f32 operation, each Poisson series to its exact exit on these inputs:
a lower bound on the work.
"""
from __future__ import annotations

import numpy as np

# published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): f32 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# tuple in (six int32), seven int32 and two f32 out
TUPLE_BYTES = 6 * 4 + 7 * 4 + 2 * 4
GT_HOM_REF = 4
# per term: add, multiply, divide, accumulate, two compares (the exit)
_UPPER_TERM = 6
# per term: subtract, max, multiply, divide, accumulate, two compares
_LOWER_TERM = 7


def _lgamma_ops(k):
    shifts = np.clip(7.0 - np.floor(k), 0.0, 8.0)
    return 8 + 3 * shifts + 14


def _log_pmf_ops(k):
    return _lgamma_ops(k) + 5


def series_terms(k, lam, lower: bool):
    """Terms each Poisson series of csrc/score_locus.cuh runs on these
    inputs, in f32 as the kernel computes them."""
    f32 = np.float32
    k = np.asarray(k, f32)
    lam = np.asarray(lam, f32)
    if lower:
        lam = np.maximum(lam, f32(1e-30))
    term = np.ones_like(k)
    acc = np.ones_like(k)
    terms = np.full(k.shape, 64, np.int64)
    live = np.ones(k.shape, bool)
    with np.errstate(all="ignore"):
        for j in range(1, 65):
            if lower:
                nxt = term * np.maximum(k - f32(j - 1), f32(0)) / lam
            else:
                nxt = term * lam / (k + f32(j))
            s = acc + nxt
            stop = live & (nxt <= term) & (s == acc)
            terms[stop] = j
            live &= ~stop
            if not live.any():
                break
            term = np.where(live, nxt, term)
            acc = np.where(live, s, acc)
    return terms


def _tail_ops(k, lam):
    m = np.maximum(k - np.float32(1), np.float32(0))
    up = _log_pmf_ops(k) + _UPPER_TERM * series_terms(k, lam, False) + 6
    low = 2 + _log_pmf_ops(m) + 1 + _LOWER_TERM * series_terms(m, lam, True) \
        + 6
    return np.where(k <= 0, 1, np.where(k > lam, up, low))


def _lower_cdf_ops(m, lam):
    mt = np.trunc(np.maximum(m, np.float32(0)))
    up = _log_pmf_ops(mt + 1) + _UPPER_TERM * series_terms(mt + 1, lam, False)
    low = _log_pmf_ops(mt) + 1 + _LOWER_TERM * series_terms(mt, lam, True)
    return 3 + np.where(mt + 1 > lam, up + 4, low + 3)


def tuple_kernel_ops(tuples: np.ndarray, frequency: np.ndarray,
                     genotype: np.ndarray, noise_q: int,
                     target_lod: float) -> float:
    """f32 operations the scoring math needs on these [U, 6] tuples."""
    f32 = np.float32
    t = np.asarray(tuples).astype(f32)
    nf = f32(10.0 ** (-noise_q / 10.0))
    sup = t[:, :3]
    cov = t[:, 3:]
    total = cov[:, 0] + cov[:, 1] + cov[:, 2]
    support = sup[:, 0] + sup[:, 1] + sup[:, 2]
    half_s = np.floor(t[:, 2] / 2)
    half_c = np.floor(t[:, 5] / 2)
    ops = 4 + 1 + np.where(support <= 0, 3, _tail_ops(support, nf * total)
                           + 3) + 4 + 3 + 2 + 2
    for s, c in ((sup[:, 0] + half_s, cov[:, 0] + half_c),
                 (sup[:, 1] + half_s, cov[:, 1] + half_c)):
        ops = ops + 2 + np.where(s <= 0, 3, _tail_ops(s, c * nf) + 3)
    ops = ops + 5 + 3 + 6
    freq = np.asarray(frequency).astype(f32)
    non_allele = (f32(1) - freq) * total
    expected = f32(target_lod) * total
    gated = (np.asarray(genotype) == GT_HOM_REF) & (non_allele < expected)
    ops = ops + 3 + np.where(gated, 5 + _lower_cdf_ops(non_allele, expected)
                             + 4, 2) + 3 + 4
    return float(ops.sum())


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds on one H100 at its published peaks."""
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)
