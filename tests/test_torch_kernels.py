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


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 7, 511, 513, 200_000, "noise_band"])
def test_kernel_matches_plain_on_card(cuda_device, L):
    rng = np.random.default_rng(9)
    if L == "noise_band":
        sup, cov = _noise_band(rng)
    else:
        sup, cov = _tuples(rng, L)
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


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 7, 511, 513, 200_000, "noise_band",
                               "ref_n"])
def test_loci_kernel_matches_plain_on_card(cuda_device, L):
    rng = np.random.default_rng(10)
    if L == "ref_n":
        counts4, ref = _ref_n_case(rng)
    elif L == 200_000:
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
