"""Adaptive (binomial mixture model) genotyping.

Port of Adaptive/MixtureModel.cs (3-component binomial mixture, EM fit,
per-site posteriors -> GT/GQ/GP), Adaptive/AdaptiveGenotyperCalculator.cs and
Adaptive/DiploidAdaptiveGenotyper.cs.

The EM fit runs vectorized over all (AD, DP) observations: numpy (f64 parity
path) and a fixed-iteration torch version (fit_mixture_model_torch) with the
observations resident on a torch device, for genome-wide fits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import stats as sps
from scipy.special import gammaln

from pisces_tpu_torch.domain.types import AlleleCategory, Genotype
from pisces_tpu_torch.genotype.diploid import (
    check_depth_issue, convert_simple_to_complex, filter_and_order_by_frequency,
    get_alleles_to_prune,
)

MAX_Q = 100.0
MAX_EFFECTIVE_DEPTH = 1000
DEFAULT_MEANS = np.array([0.01, 0.45, 0.95])
DEFAULT_QSCORE_EFFECTIVE_N = np.array([25, 25, 10])


def p_to_q_cap300(p):
    """MathOperations.PToQ_CapAt300."""
    p = np.asarray(p, dtype=np.float64)
    out = np.where(p < 1e-300, 3000.0, -10.0 * np.log10(np.maximum(p, 1e-320)))
    return out


def _binom_pmf(p, n, k):
    """MathNet Binomial.PMF(p, n, k) vectorized."""
    p = np.asarray(p, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        logpmf = (gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
                  + k * np.log(np.where(p > 0, p, 1.0))
                  + (n - k) * np.log(np.where(p < 1, 1 - p, 1.0)))
    pmf = np.exp(logpmf)
    pmf = np.where((p == 0) & (k == 0), 1.0, pmf)
    pmf = np.where((p == 0) & (k > 0), 0.0, pmf)
    pmf = np.where((p == 1) & (k == n), 1.0, pmf)
    pmf = np.where((p == 1) & (k != n), 0.0, pmf)
    return pmf


def _normal_pdf(mean, std, x):
    return np.exp(-0.5 * ((x - mean) / std) ** 2) / (std * math.sqrt(2 * math.pi))


def _posteriors_matrix(ad, dp, means, weights):
    """E-step posteriors [N, K] with the reference's normal-approximation
    fallback when the binomial row underflows (MixtureModel.UpdateExpectation)."""
    ad = np.asarray(ad, dtype=np.float64)
    dp = np.asarray(dp, dtype=np.float64)
    tp = _binom_pmf(means[None, :], dp[:, None], ad[:, None]) * weights[None, :]
    row_sum = tp.sum(axis=1)
    bad = row_sum == 0
    if bad.any():
        with np.errstate(divide="ignore", invalid="ignore"):
            vf = np.where(dp > 0, ad / np.maximum(dp, 1), 0.0)
        std = np.sqrt(np.maximum(dp[:, None] * means[None, :] * (1 - means[None, :]),
                                 1e-300))
        normal = _normal_pdf(means[None, :], std, vf[:, None])
        tp[bad] = normal[bad]
        row_sum = tp.sum(axis=1)
    posts = tp / np.maximum(row_sum[:, None], 1e-300)
    return posts, row_sum


@dataclass
class MixtureModelFit:
    means: np.ndarray
    weights: np.ndarray
    posteriors: np.ndarray       # [N, 3]
    clustering: np.ndarray       # [N]
    qscores: np.ndarray          # [N]
    genotype_posteriors: np.ndarray  # [N, 3] phred
    qscore_effective_n: np.ndarray
    log_likelihoods: List[float]


def fit_mixture_model(ad: Sequence[int], dp: Sequence[int],
                      starting_means: Optional[np.ndarray] = None,
                      max_iter: int = 1000, tol: float = 1e-6
                      ) -> MixtureModelFit:
    """MixtureModel.FitBinomialModel (EM over all observations)."""
    ad = np.asarray(ad, dtype=np.int64)
    dp = np.asarray(dp, dtype=np.int64)
    means = np.sort(np.array(starting_means if starting_means is not None
                             else DEFAULT_MEANS, dtype=np.float64))
    weights = np.full(len(means), 0.01 / (len(means) - 1))
    weights[int(np.argmin(means))] = 0.99

    posts, row_sum = _posteriors_matrix(ad, dp, means, weights)
    lls = [float(np.log(np.maximum(row_sum, 1e-300)).sum())]

    old_ll = lls[0] + 100
    for it in range(max_iter):
        posts, row_sum = _posteriors_matrix(ad, dp, means, weights)
        ll = float(np.log(np.maximum(row_sum, 1e-300)).sum())
        lls.append(ll)
        # M-step
        n_scaled = (posts * dp[:, None]).sum(axis=0)
        n_unscaled = posts.sum(axis=0)
        means = (posts * ad[:, None]).sum(axis=0) / np.maximum(n_scaled, 1e-300)
        weights = n_unscaled / len(ad)
        if abs(ll - old_ll) <= tol:
            break
        old_ll = ll

    order = np.argsort(means)
    means = means[order]
    weights = weights[order]
    posts = posts[:, order]

    clustering = posts.argmax(axis=1)
    counts = np.bincount(clustering, minlength=3)
    if (counts == 0).any():
        raise ValueError(
            "Germline adaptive genotyper failed: not enough variants to fit "
            "the model; check the sample is diploid or use a pre-fit model.")

    # per-cluster effective N from VF variance (UpdateClusteringAndQScore)
    vf = ad / np.maximum(dp, 1)
    eff_n = np.zeros(3, dtype=np.int64)
    fallback = False
    for k in range(3):
        sel = vf[clustering == k]
        var = np.var(sel, ddof=1) if len(sel) > 1 else np.nan
        if not np.isfinite(var) or var == 0:
            fallback = True
            break
        eff_n[k] = int(round(means[k] * (1 - means[k]) / var))
    if fallback:
        eff_n = DEFAULT_QSCORE_EFFECTIVE_N.copy()

    q, gp = qscores_and_posteriors(ad, dp, clustering, means, weights, eff_n)
    return MixtureModelFit(means, weights, posts, clustering, q, gp, eff_n, lls)


def use_prefit_model(ad, dp, means, priors) -> MixtureModelFit:
    """MixtureModel.UsePrefitModel."""
    ad = np.asarray(ad, dtype=np.int64)
    dp = np.asarray(dp, dtype=np.int64)
    means = np.array(means, dtype=np.float64)
    order = np.argsort(means)
    means = means[order]
    weights = np.array(priors, dtype=np.float64)[order]
    posts, _ = _posteriors_matrix(ad, dp, means, weights)
    clustering = posts.argmax(axis=1)
    vf = ad / np.maximum(dp, 1)
    eff_n = np.zeros(3, dtype=np.int64)
    fallback = False
    for k in range(3):
        sel = vf[clustering == k]
        var = np.var(sel, ddof=1) if len(sel) > 1 else np.nan
        if not np.isfinite(var) or var == 0:
            fallback = True
            break
        eff_n[k] = int(round(means[k] * (1 - means[k]) / var))
    if fallback:
        eff_n = DEFAULT_QSCORE_EFFECTIVE_N.copy()
    q, gp = qscores_and_posteriors(ad, dp, clustering, means, weights, eff_n)
    return MixtureModelFit(means, weights, posts, clustering, q, gp, eff_n, [])


def _posteriors_with_max_n(ad, dp, means, priors, max_n):
    """CalculatePosteriorsWithMaxN, vectorized over observations [N]."""
    ad = np.asarray(ad, dtype=np.int64)
    dp = np.asarray(dp, dtype=np.int64)
    max_n = np.asarray(max_n, dtype=np.int64)
    vf = ad / np.maximum(dp, 1)
    over = dp[:, None] > max_n[None, :]
    k_arr = np.where(over, np.round(vf[:, None] * max_n[None, :]), ad[:, None])
    n_arr = np.where(over, max_n[None, :], dp[:, None])
    tp = _binom_pmf(means[None, :], n_arr, k_arr) * np.asarray(priors)[None, :]
    row_sum = tp.sum(axis=1)
    bad = row_sum == 0
    if bad.any():
        # normal approximation fallback per reference CalculatePosteriors
        std = np.sqrt(np.maximum(n_arr * means[None, :] * (1 - means[None, :]),
                                 1e-300))
        normal = _normal_pdf(means[None, :], std, (k_arr / np.maximum(n_arr, 1)))
        tp[bad] = normal[bad]
        row_sum = tp.sum(axis=1)
    return tp / np.maximum(row_sum[:, None], 1e-300)


def qscores_and_posteriors(ad, dp, category, means, priors, max_n):
    """CalculateQScoreAndGenotypePosteriors, vectorized."""
    posts = _posteriors_with_max_n(ad, dp, means, priors, max_n)
    gp = np.minimum(MAX_Q, p_to_q_cap300(posts)).astype(np.float32)
    cat_post = posts[np.arange(len(posts)), np.asarray(category)]
    q = np.minimum(int(MAX_Q),
                   np.round(p_to_q_cap300(1 - cat_post)).astype(np.int64))
    return q, gp


def calculate_q_and_posteriors(ad: int, dp: int, means, priors
                               ) -> Tuple[int, int, np.ndarray]:
    """MixtureModel.CalculateQScoreAndGenotypePosteriors for one site.
    Returns (category, qscore, gp)."""
    means = np.asarray(means, dtype=np.float64)
    posts = _posteriors_with_max_n([ad], [dp], means, priors,
                                   DEFAULT_QSCORE_EFFECTIVE_N)
    # category from non-capped posteriors (GetSimplifiedGenotype)
    raw_posts = _posteriors_with_max_n([ad], [dp], means, priors,
                                       np.array([2 ** 31] * 3))
    category = int(raw_posts[0].argmax())
    q, gp = qscores_and_posteriors([ad], [dp], [category], means, priors,
                                   DEFAULT_QSCORE_EFFECTIVE_N)
    return category, int(q[0]), gp[0]


def get_multinomial_qscores(ad3, dp, means_list):
    """MixtureModel.GetMultinomialQScores for 1/2 loci."""
    if dp > 500:
        return (int(MAX_Q),
                np.array([MAX_Q, MAX_Q, MAX_Q, MAX_Q, 0, MAX_Q], np.float32))
    temp = np.zeros(6)
    count = 0
    for m2 in range(3):
        for m1 in range(3):
            if (m1 == 2 and m2 != 0) or (m2 == 2 and m1 != 0):
                continue
            p1 = means_list[0][m1]
            p2 = means_list[1][m2]
            p0 = 1 - p1 - p2
            if p0 <= 0:
                if m1 == 2:
                    p0 = 1 - p1
                elif m2 == 2:
                    p0 = 1 - p2
                elif m1 == 1 and m2 == 1:
                    p0 = 1 - means_list[0][2]
            prior = 0.99 if (m1 == 0 and m2 == 0) else 0.01 / 5
            pvec = np.array([max(p0, 0.0), p1, p2])
            pvec = pvec / pvec.sum()
            temp[count] = float(sps.multinomial.pmf(ad3, dp, pvec)) * prior
            count += 1
    norm = temp.sum()
    gp = np.minimum(MAX_Q, p_to_q_cap300(temp / max(norm, 1e-300))).astype(np.float32)
    q = min(int(MAX_Q), int(round(float(p_to_q_cap300(1 - temp[4] / max(norm, 1e-300))))))
    return q, gp


class DiploidAdaptiveGenotyper:
    """DiploidAdaptiveGenotyper.SetGenotypes."""

    def __init__(self, config):
        from pisces_tpu_torch.options import AdaptiveGenotypingParameters
        self.params = getattr(config, "adaptive_parameters", None) or \
            AdaptiveGenotypingParameters()
        self.min_gq = config.min_gq_score
        self.max_gq = config.max_gq_score
        self.min_depth = config.min_depth_to_genotype

    def _models_for(self, allele):
        if allele.category in (AlleleCategory.SNV, AlleleCategory.REFERENCE,
                               AlleleCategory.MNV):
            return (np.array(self.params.snv_model),
                    np.array(self.params.snv_prior))
        return (np.array(self.params.indel_model),
                np.array(self.params.indel_prior))

    @staticmethod
    def _preprocess(allele) -> Tuple[int, int]:
        dp = allele.total_coverage
        if allele.ref_allele != allele.alt_allele:
            ad = allele.allele_support
        else:
            ad = max(dp - allele.allele_support, 0)
        if dp > MAX_EFFECTIVE_DEPTH:
            ad = int(ad / dp * MAX_EFFECTIVE_DEPTH)
            dp = MAX_EFFECTIVE_DEPTH
        return min(ad, dp), dp

    @staticmethod
    def _min_var_frequency(n, model, priors) -> float:
        mu1, mu2 = model[0], model[1]
        p1, p2 = priors[0], priors[1]
        if n <= 0:
            return 0.18
        min_vq = ((math.log(p2) - math.log(p1) - n * math.log(1 - mu1)
                   + n * math.log(1 - mu2))
                  / (math.log(mu1) - math.log(1 - mu1) - math.log(mu2)
                     + math.log(1 - mu2)) / n)
        return float(np.float32(min_vq))

    def set_genotypes(self, alleles: List) -> List:
        if not alleles:
            return []
        prune: List = []
        min_vf = self._min_var_frequency(alleles[0].total_coverage,
                                         self.params.snv_model,
                                         self.params.snv_prior)
        ref_freq = 1.0
        for a in alleles:
            if a.category == AlleleCategory.REFERENCE:
                ref_freq = a.frequency
                break
            ref_freq -= a.frequency
        ref_freq = max(ref_freq, 0.0)

        depth_issue = check_depth_issue(alleles, self.min_depth)
        ref_exists = ref_freq > min_vf
        ordered = filter_and_order_by_frequency(alleles, prune, min_vf)
        ref_call = not ordered

        preliminary = 0
        if not ref_call:
            model, priors = self._models_for(ordered[0])
            ad, dp = self._preprocess(ordered[0])
            raw = _posteriors_with_max_n([ad], [dp], model, priors,
                                         np.array([2 ** 31] * 3))
            preliminary = int(raw[0].argmax())
            min_vf = self._min_var_frequency(ordered[0].total_coverage,
                                             model, priors)

        gt = convert_simple_to_complex(alleles, ordered, ref_freq, ref_exists,
                                       depth_issue, ref_call, min_vf,
                                       self.params.sum_vf_for_multi_allelic_site,
                                       preliminary)
        prune = get_alleles_to_prune(gt, ordered, prune)

        phase_set = 1
        for a in alleles:
            a.genotype = gt
            if a.total_coverage == 0:
                a.genotype_qscore = self.min_gq
                a.genotype_posteriors = np.full(
                    3, self.params.max_genotype_posteriors, np.float32)
            else:
                model, priors = self._models_for(a)
                ad, dp = self._preprocess(a)
                _, q, gp = calculate_q_and_posteriors(ad, dp, model, priors)
                a.genotype_qscore = max(min(q, self.max_gq), self.min_gq)
                a.genotype_posteriors = gp
            if a.is_ref_type:
                a.phase_set_index = 0
            else:
                a.phase_set_index = phase_set
                phase_set += 1

        if alleles and alleles[0].genotype == Genotype.HETEROZYGOUS_ALT1_ALT2 \
                and len(alleles) >= 2:
            a1, a2 = alleles[0], alleles[1]
            m1, _ = self._models_for(a1)
            m2, _ = self._models_for(a2)
            dp = a1.total_coverage
            ad3 = [max(dp - a1.allele_support - a2.allele_support, 0),
                   a1.allele_support, a2.allele_support]
            q, gp = get_multinomial_qscores(ad3, dp, [m1, m2])
            for a in alleles:
                a.genotype_qscore = max(min(q, self.max_gq), self.min_gq)
                a.genotype_posteriors = gp
        return prune


# ---------------------------------------------------------------------------
# torch device EM (genome-scale fits)
# ---------------------------------------------------------------------------

def fit_mixture_model_torch(ad, dp, starting_means=None, iters: int = 200,
                            device="cuda"):
    """Device EM: `iters` fixed EM steps over f32 tensors with all
    observations resident on `device` ("cuda" unless the caller asks for
    "cpu"; raises when CUDA is absent). Returns (means, weights), both
    sorted by mean.

    Each step is the 3-component binomial mixture's E-step in log space
    (log-sum-exp over the components) and its M-step. The log binomial
    coefficient does not change between steps, so it is computed once; every
    other operation is the step's own, in its order."""
    import torch

    from pisces_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    f32 = torch.float32
    ad = torch.as_tensor(np.asarray(ad), dtype=f32, device=dev)
    dp = torch.as_tensor(np.asarray(dp), dtype=f32, device=dev)
    means = torch.sort(torch.as_tensor(
        np.asarray(starting_means if starting_means is not None
                   else DEFAULT_MEANS), dtype=f32, device=dev)).values
    weights = torch.full((3,), 0.005, dtype=f32, device=dev)
    weights[torch.argmin(means)] = 0.99
    n_obs = ad.shape[0]
    k = ad[:, None]
    n = dp[:, None]
    log_coef = (torch.lgamma(n + 1) - torch.lgamma(k + 1)
                - torch.lgamma(n - k + 1))
    for _ in range(iters):
        p = means[None, :]
        logp = (log_coef + k * torch.log(torch.clamp(p, min=1e-30))
                + (n - k) * torch.log(torch.clamp(1 - p, min=1e-30))
                + torch.log(torch.clamp(weights[None, :], min=1e-30)))
        logp = logp - torch.logsumexp(logp, dim=1, keepdim=True)
        posts = torch.exp(logp)
        n_scaled = (posts * n).sum(dim=0)
        means = (posts * k).sum(dim=0) / torch.clamp(n_scaled, min=1e-30)
        weights = posts.sum(dim=0) / n_obs
    means = means.cpu().numpy()
    weights = weights.cpu().numpy()
    order = np.argsort(means)
    return means[order], weights[order]
