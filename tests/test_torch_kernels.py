"""The reference-locus scoring kernels of the port
(pisces_tpu_torch/ops/scoring_kernels.py; csrc/score_tuples.cu for tuples,
csrc/score_loci.cu for raw counts).

On the CPU each wrapper runs its plain torch version, which is held against
the Pallas kernel it replaces (score_reference_tuples_pallas and
score_reference_loci_pallas in interpret mode, as
tests/test_pallas_scoring.py runs them) and against the XLA scoring, at the
sizes around the Pallas tile edge and in the k ~ lambda band. The counts
version takes support from the row the reference code names for any code,
as the XLA path it serves does; at a reference N (code 4) the Pallas kernel
gives zero support instead, so N rows are held against XLA alone. Integer outputs are exact. sb_gatk is compared in the range the
gVCF writer emits (clipped to [-100, 0] dB, fast_gvcf.format_reference_lines):
within 1e-3 dB above -40 dB and 5% below, where the fixed 64-term series
drifts from igamma (the tolerances of tests/test_pallas_scoring.py). The
clip also folds the no-bias sentinels together: -1e38 in the kernels and
10*log10 of an f32 subnormal where XLA flushes it to zero. Against the XLA
igamma form, loci where XLA's score underflows to -inf are left out, as
tests/test_pallas_scoring.py leaves them out.

The CUDA kernels themselves run only on the card: the tests marked `cuda`
compare them with the plain versions there and skip elsewhere. The module
imports JAX only inside the CPU tests, so that the card's machine, which has
no JAX, can run the `cuda` tests:
    python -m pytest tests/test_torch_kernels.py -m cuda -q
"""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (keeps JAX on the CPU)
from pisces_tpu_torch.ops import scoring_kernels as K
from pisces_tpu_torch.ops.scoring_params import ScoringParams

INT_KEYS = ("total_coverage", "support", "variant_qscore", "gq", "genotype",
            "filter_bits")


def _tuples(rng, L):
    cov = rng.integers(0, 500, size=(L, 3)).astype(np.int32)
    sup = (cov * rng.random((L, 3))).astype(np.int32)
    return sup, cov


def _noise_band(rng, L=1024):
    """Support near the noise floor (k ~ lambda), as in
    test_pallas_scoring.test_low_support_noise_band: reference support on
    the forward strand under a deep non-reference pileup on the reverse."""
    sup = np.zeros((L, 3), np.int32)
    cov = np.zeros((L, 3), np.int32)
    sup[:, 0] = rng.integers(0, 12, L)
    cov[:, 0] = sup[:, 0]
    cov[:, 1] = rng.integers(0, 500, L)
    return sup, cov


def _assert_sb_close(got, want):
    keep = np.isfinite(want)
    got = np.clip(got[keep], -100.0, 0.0)
    want = np.clip(want[keep], -100.0, 0.0)
    shallow = want > -40.0
    np.testing.assert_allclose(got[shallow], want[shallow], atol=1e-3)
    np.testing.assert_allclose(got[~shallow], want[~shallow], rtol=0.05)


def _plain(sup, cov, nc=None):
    t = torch.from_numpy(np.ascontiguousarray(np.concatenate([sup, cov], 1)))
    n = None if nc is None else torch.from_numpy(nc)
    return K.score_reference_tuples(t, ScoringParams(), num_no_calls=n)


@pytest.mark.parametrize("L", [1, 7, 511, 513, 2000, "noise_band"])
def test_plain_matches_pallas_and_xla(L):
    from pisces_tpu.ops.jax_scoring import ScoringParams as JParams
    from pisces_tpu.ops.jax_scoring import (
        score_reference_tuples as xla_tuples,
    )
    from pisces_tpu.ops.pallas_scoring import score_reference_tuples_pallas
    rng = np.random.default_rng(3)
    if L == "noise_band":
        sup, cov = _noise_band(rng)
    else:
        sup, cov = _tuples(rng, L)
    nc = rng.integers(0, 8, size=len(sup)).astype(np.int32)
    out = _plain(sup, cov, nc)
    pal = score_reference_tuples_pallas(sup, cov, JParams(), num_no_calls=nc,
                                        interpret=True)
    xla = xla_tuples(sup, cov, JParams())
    for k in INT_KEYS:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(pal[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(xla[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(out["num_no_calls"].numpy(), nc)
    for k in ("coverage_by_dir", "support_by_dir"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(pal[k]))
    np.testing.assert_array_equal(out["frequency"].numpy(),
                                  np.asarray(pal["frequency"]))
    _assert_sb_close(out["sb_gatk"].numpy(), np.asarray(pal["sb_gatk"]))
    _assert_sb_close(out["sb_gatk"].numpy(), np.asarray(xla["sb_gatk"]))


def _series_exit(k, lam, lower):
    """One Poisson series of csrc/score_locus.cuh in scalar f32, with its
    exact exit: each term as the 64-term plain series computes it, stopping
    at the first term that is no larger than the one before and leaves the
    sum unchanged. Returns (sum, terms run)."""
    f32 = np.float32
    k, lam = f32(k), f32(lam)
    if lower:
        lam = max(lam, f32(1e-30))
    term = acc = f32(1.0)
    for j in range(1, K.N_SERIES + 1):
        if lower:
            nxt = term * max(k - f32(j - 1), f32(0.0)) / lam
        else:
            nxt = term * lam / (k + f32(j))
        s = acc + nxt
        if nxt <= term and s == acc:
            return acc, j
        term, acc = nxt, s
    return acc, K.N_SERIES


def _series_grid(rng, grid, lower, n=1500):
    """f32 (k, lam) pairs on the branch each series serves: the upper series
    for k > lam, the lower for m = k - 1 with k <= lam."""
    f32 = np.float32
    if grid == "m0":
        return np.zeros(n, f32), rng.uniform(0.0, 1e4, n).astype(f32)
    if grid == "deep":              # coverage up to 5,000, lam = 0.01 x cov
        cov = rng.integers(1, 5001, n).astype(f32)
        lam = f32(0.01) * cov
        k = (np.floor(lam * rng.random(n)) if lower
             else np.maximum(cov - rng.integers(0, 4, n), np.floor(lam) + 1))
    elif grid == "band":            # k ~ lam
        lam = rng.uniform(0.5, 50.0, n).astype(f32)
        k = (np.floor(lam) - rng.integers(0, 4, n) if lower
             else np.floor(lam) + rng.integers(1, 5, n))
    else:                           # large lam, up to 1e5
        lam = rng.uniform(1e3, 1e5, n).astype(f32)
        k = (np.floor(lam * rng.uniform(0.95, 1.0, n)) if lower
             else np.ceil(lam * rng.uniform(1.0, 1.05, n)) + 1)
    k = np.maximum(k, 1).astype(f32)
    return (np.maximum(k - 1, 0).astype(f32) if lower else k), lam


@pytest.mark.parametrize("series,grid", [
    ("upper", "deep"), ("upper", "band"), ("upper", "large_lambda"),
    ("lower", "deep"), ("lower", "band"), ("lower", "large_lambda"),
    ("lower", "m0")])
def test_series_exit_rule_is_bit_equal_to_64_terms(series, grid):
    """The kernels' exact exit gives the 64-term plain series' f32 sum, bit
    for bit: the terms do not grow, and once one leaves the sum unchanged
    every later one does."""
    lower = series == "lower"
    k, lam = _series_grid(np.random.default_rng(21), grid, lower)
    plain = (K._lower_series if lower else K._upper_series)(
        torch.from_numpy(k), torch.from_numpy(lam)).numpy()
    got = np.array([_series_exit(a, b, lower)[0] for a, b in zip(k, lam)],
                   np.float32)
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))


def test_series_exit_rule_stops_early_on_deep_loci():
    """At the main path's deep reference loci (support 750, lam 7.5) the
    upper series stops after 4 terms; the lower series after m + 1."""
    assert _series_exit(750, np.float32(0.01) * np.float32(750), False)[1] \
        == 4
    assert _series_exit(3, 40.0, True)[1] <= 4
    assert _series_exit(0, 5.0, True)[1] == 1


def test_overall_tail_is_the_q_tail():
    """Q's tail P(X >= support; noise_freq * total) and the overall
    strand-bias side's tail (support; total * noise_freq) are one f32 call:
    the products are bit-equal, so the kernels compute the tail once."""
    rng = np.random.default_rng(22)
    total = torch.from_numpy(rng.integers(1, 20_000, 4000).astype(np.float32))
    support = torch.floor(total * torch.from_numpy(
        rng.random(4000).astype(np.float32)))
    nf, l1m = K.noise_constants(ScoringParams())
    noise_freq = torch.tensor(nf, dtype=torch.float32)
    lam_q = noise_freq * total
    lam_sb = total * noise_freq
    assert torch.equal(lam_q.view(torch.int32), lam_sb.view(torch.int32))
    tail, _ = K._poisson_tail(support, lam_q)
    cfp, cvfgz = K._sb_stats(support, total, noise_freq,
                             torch.tensor(l1m, dtype=torch.float32))
    has = support > 0
    assert torch.equal(cfp[has], torch.clamp(tail, min=0.0)[has])
    assert torch.equal(cvfgz[has], torch.clamp(1.0 - tail, min=0.0)[has])


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    K.reset_launch_counts()
    rng = np.random.default_rng(5)
    sup, cov = _tuples(rng, 100)
    out = _plain(sup, cov)
    ref = K.score_reference_tuples_plain(
        torch.from_numpy(np.concatenate([sup, cov], 1)), ScoringParams())
    for k in INT_KEYS:
        assert torch.equal(out[k], ref[k])
    assert K.launch_counts["score_tuples"] == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "num_nc"])
def test_wrapper_rejects_bad_inputs(bad):
    t = torch.zeros((10, 6), dtype=torch.int32)
    nc = None
    if bad == "dtype":
        t = t.to(torch.int64)
    elif bad == "shape":
        t = torch.zeros((10, 5), dtype=torch.int32)
    elif bad == "strided":
        t = torch.zeros((10, 12), dtype=torch.int32)[:, ::2]
    else:
        nc = torch.zeros(9, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.score_reference_tuples(t, ScoringParams(), num_no_calls=nc)


def _loci_case(rng, L):
    """(counts [L, 6, 3, K] int32, ref_code [L] int32 in 0-3): the cases of
    tests/test_pallas_scoring.py (random tiles with zero and deep rows,
    small counts around the tile edge, the k ~ lambda band)."""
    if L == "noise_band":
        n = 1024
        counts4 = np.zeros((n, 6, 3, 1), np.int32)
        counts4[:, 0, 0, 0] = rng.integers(0, 12, n)     # A = reference
        counts4[:, 2, 1, 0] = rng.integers(0, 500, n)    # deep C pileup
        return counts4, np.zeros(n, np.int32)
    if L >= 2000:
        counts4 = rng.integers(0, 30, size=(L, 6, 3, 11)).astype(np.int32)
        counts4[:50] = 0              # zero coverage
        counts4[50:60] *= 50          # deep coverage (lam ~ 50)
    else:
        counts4 = rng.integers(0, 12, size=(L, 6, 3, 11)).astype(np.int32)
    return counts4, rng.integers(0, 4, size=L).astype(np.int32)


def _ref_n_case(rng, L=600):
    """Every reference code 0-5, a third of the rows a reference N (code 4)
    with N counts on them."""
    counts4 = rng.integers(0, 30, size=(L, 6, 3, 11)).astype(np.int32)
    ref = rng.integers(0, 6, size=L).astype(np.int32)
    ref[::3] = 4
    return counts4, ref


def _loci(counts4, ref, device="cpu"):
    c = torch.from_numpy(np.ascontiguousarray(counts4.sum(-1),
                                              dtype=np.int32)).to(device)
    return K.score_reference_loci(c, torch.from_numpy(ref).to(device),
                                  ScoringParams())


LOCI_EXACT = INT_KEYS + ("num_no_calls", "coverage_by_dir", "support_by_dir")


@pytest.mark.parametrize("L", [1, 7, 511, 513, 3000, "noise_band"])
def test_loci_plain_matches_pallas(L):
    from pisces_tpu.ops.jax_scoring import ScoringParams as JParams
    from pisces_tpu.ops.pallas_scoring import score_reference_loci_pallas
    counts4, ref = _loci_case(np.random.default_rng(4), L)
    out = _loci(counts4, ref)
    pal = score_reference_loci_pallas(counts4.sum(-1).astype(np.int32), ref,
                                      JParams(), interpret=True)
    for k in LOCI_EXACT + ("frequency",):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(pal[k]),
                                      err_msg=k)
    _assert_sb_close(out["sb_gatk"].numpy(), np.asarray(pal["sb_gatk"]))


def test_loci_plain_takes_the_n_count_at_a_reference_n():
    """At reference codes 0-5 the plain counts version equals the XLA
    score_reference_loci (the semantics of the mesh step); at a reference N
    the Pallas kernel's support is zero where XLA's and the port's is the
    N count."""
    from pisces_tpu.ops.jax_scoring import ScoringParams as JParams
    from pisces_tpu.ops.jax_scoring import score_reference_loci as xla_loci
    from pisces_tpu.ops.pallas_scoring import score_reference_loci_pallas
    counts4, ref = _ref_n_case(np.random.default_rng(6))
    out = _loci(counts4, ref)
    xla = xla_loci(counts4, ref, JParams())
    for k in LOCI_EXACT:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(xla[k]),
                                      err_msg=k)
    _assert_sb_close(out["sb_gatk"].numpy(), np.asarray(xla["sb_gatk"]))
    is_n = ref == 4
    n_count = counts4.sum(-1)[:, 4, :].sum(-1)
    np.testing.assert_array_equal(out["support"].numpy()[is_n],
                                  n_count[is_n])
    pal = score_reference_loci_pallas(counts4.sum(-1).astype(np.int32), ref,
                                      JParams(), interpret=True)
    assert (np.asarray(pal["support"])[is_n] == 0).all()
    np.testing.assert_array_equal(out["support"].numpy()[~is_n],
                                  np.asarray(pal["support"])[~is_n])


def test_cpu_loci_wrapper_counts_no_launch():
    K.reset_launch_counts()
    counts4, ref = _loci_case(np.random.default_rng(8), 100)
    out = _loci(counts4, ref)
    c = torch.from_numpy(counts4.sum(-1).astype(np.int32))
    plain = K.score_reference_loci_plain(c, torch.from_numpy(ref),
                                         ScoringParams())
    for k in LOCI_EXACT:
        assert torch.equal(out[k], plain[k]), k
    assert K.launch_counts == {"score_tuples": 0, "score_loci": 0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "ref_len",
                                 "ref_dtype"])
def test_loci_wrapper_rejects_bad_inputs(bad):
    c = torch.zeros((10, 6, 3), dtype=torch.int32)
    ref = torch.zeros(10, dtype=torch.int32)
    if bad == "dtype":
        c = c.to(torch.int64)
    elif bad == "shape":
        c = torch.zeros((10, 5, 3), dtype=torch.int32)
    elif bad == "strided":
        c = torch.zeros((20, 6, 3), dtype=torch.int32)[::2]
    elif bad == "ref_len":
        ref = torch.zeros(9, dtype=torch.int32)
    else:
        ref = ref.to(torch.int64)
    with pytest.raises(ValueError):
        K.score_reference_loci(c, ref, ScoringParams())


def test_wrappers_raise_on_a_device_without_a_kernel():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.score_reference_tuples(
            torch.zeros((4, 6), dtype=torch.int32, device=meta),
            ScoringParams())
    with pytest.raises(ValueError, match="no kernel for device"):
        K.score_reference_loci(
            torch.zeros((4, 6, 3), dtype=torch.int32, device=meta),
            torch.zeros(4, dtype=torch.int32, device=meta), ScoringParams())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _deep(rng, L=4099):
    """Deep reference loci: coverage up to 5,000, support the coverage less
    a few reads."""
    cov = rng.integers(0, 1667, size=(L, 3)).astype(np.int32)
    sup = np.maximum(cov - rng.integers(0, 4, size=(L, 3)), 0).astype(np.int32)
    return sup, cov


def _large_lambda(rng, L=4099):
    """Coverage up to 10 million (lam up to 1e5), support 0-3% of it."""
    cov = rng.integers(0, 3_333_333, size=(L, 3)).astype(np.int32)
    sup = (cov * 0.03 * rng.random((L, 3))).astype(np.int32)
    return sup, cov


# the tile edges, the main path's tuple count and mesh tiles (ragged against
# a 32-locus tile), a large batch, and the series' long and short exits
CARD_CASES = [1, 7, 511, 513, 6_119, 50_176, 200_000, 200_192, "noise_band",
              "deep", "large_lambda"]


def _card_tuples(rng, L):
    if L == "noise_band":
        return _noise_band(rng)
    if L == "deep":
        return _deep(rng)
    if L == "large_lambda":
        return _large_lambda(rng)
    return _tuples(rng, L)


@pytest.mark.cuda
@pytest.mark.parametrize("L", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, L):
    rng = np.random.default_rng(9)
    sup, cov = _card_tuples(rng, L)
    t = torch.from_numpy(np.concatenate([sup, cov], 1)).to(cuda_device)
    nc = torch.from_numpy(rng.integers(0, 8, len(sup)).astype(np.int32)
                          ).to(cuda_device)
    before = K.launch_counts["score_tuples"]
    out = K.score_reference_tuples(t, ScoringParams(), num_no_calls=nc)
    torch.cuda.synchronize()
    assert K.launch_counts["score_tuples"] == before + 1
    ref = K.score_reference_tuples_plain(t, ScoringParams(), num_no_calls=nc)
    for k in INT_KEYS + ("num_no_calls",):
        assert torch.equal(out[k], ref[k]), k
    _assert_sb_close(out["sb_gatk"].cpu().numpy(),
                     ref["sb_gatk"].cpu().numpy())


def _tuple_counts(rng, sup, cov):
    """(counts [L, 6, 3, 1], ref codes) whose derived tuples are (sup, cov):
    support on the reference row, the rest of the coverage on another
    base."""
    L = len(sup)
    ref = rng.integers(0, 4, L)
    other = (ref + 1 + rng.integers(0, 3, L)) % 4
    counts = np.zeros((L, 6, 3, 1), np.int32)
    counts[np.arange(L), ref, :, 0] = sup
    counts[np.arange(L), other, :, 0] = cov - sup
    return counts, ref.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("L", CARD_CASES + ["ref_n"])
def test_loci_kernel_matches_plain_on_card(cuda_device, L):
    rng = np.random.default_rng(10)
    if L == "ref_n":
        counts4, ref = _ref_n_case(rng)
    elif L in ("deep", "large_lambda"):
        counts4, ref = _tuple_counts(rng, *_card_tuples(rng, L))
    elif isinstance(L, int) and L >= 6_119:
        counts4 = rng.integers(0, 60, size=(L, 6, 3, 1)).astype(np.int32)
        ref = rng.integers(0, 6, size=L).astype(np.int32)
    else:
        counts4, ref = _loci_case(rng, L)
    before = K.launch_counts["score_loci"]
    out = _loci(counts4, ref, cuda_device)
    torch.cuda.synchronize()
    assert K.launch_counts["score_loci"] == before + 1
    c = torch.from_numpy(counts4.sum(-1).astype(np.int32)).to(cuda_device)
    plain = K.score_reference_loci_plain(
        c, torch.from_numpy(ref).to(cuda_device), ScoringParams())
    for k in LOCI_EXACT:
        assert torch.equal(out[k], plain[k]), k
    _assert_sb_close(out["sb_gatk"].cpu().numpy(),
                     plain["sb_gatk"].cpu().numpy())


@pytest.mark.cuda
def test_kernels_stage_unaligned_inputs_on_card(cuda_device):
    """Contiguous views that start one row in (24 or 72 bytes, and 4 for
    the per-locus rows) are not 16-byte aligned: the kernels stage them one
    int32 a thread instead of 16-byte copies, with the same outputs."""
    rng = np.random.default_rng(14)
    sup, cov = _tuples(rng, 1001)
    t = torch.from_numpy(np.concatenate([sup, cov], 1)).to(cuda_device)[1:]
    nc = torch.from_numpy(rng.integers(0, 8, 1001).astype(np.int32)
                          ).to(cuda_device)[1:]
    out = K.score_reference_tuples(t, ScoringParams(), num_no_calls=nc)
    counts4, ref = _loci_case(rng, 1001)
    c = torch.from_numpy(counts4.sum(-1).astype(np.int32)).to(cuda_device)[1:]
    r = torch.from_numpy(ref).to(cuda_device)[1:]
    lout = K.score_reference_loci(c, r, ScoringParams())
    torch.cuda.synchronize()
    assert t.data_ptr() % 16 and c.data_ptr() % 16 and r.data_ptr() % 16
    ref_t = K.score_reference_tuples_plain(t, ScoringParams(), num_no_calls=nc)
    ref_l = K.score_reference_loci_plain(c, r, ScoringParams())
    for k in INT_KEYS + ("num_no_calls",):
        assert torch.equal(out[k], ref_t[k]), k
    for k in LOCI_EXACT:
        assert torch.equal(lout[k], ref_l[k]), k


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_device(cuda_device):
    """Each launcher makes its tensors' card current and then the previous
    one again: on the last card, outputs equal the plain version and
    torch's current device is unchanged (on a one-card machine the last
    card is the current one)."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    current = torch.cuda.current_device()
    counts4, ref = _ref_n_case(np.random.default_rng(12))
    out = _loci(counts4, ref, dev)
    sup, cov = _tuples(np.random.default_rng(13), 1000)
    t = torch.from_numpy(np.concatenate([sup, cov], 1)).to(dev)
    tout = K.score_reference_tuples(t, ScoringParams())
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == current
    c = torch.from_numpy(counts4.sum(-1).astype(np.int32)).to(dev)
    plain = K.score_reference_loci_plain(c, torch.from_numpy(ref).to(dev),
                                         ScoringParams())
    tplain = K.score_reference_tuples_plain(t, ScoringParams())
    for k in INT_KEYS:
        assert torch.equal(out[k], plain[k]), k
        assert torch.equal(tout[k], tplain[k]), k
