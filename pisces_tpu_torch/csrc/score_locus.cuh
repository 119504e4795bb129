// The reference-locus scoring math shared by the two Hopper (sm_90a)
// scoring kernels: score_tuples.cu (the port of the Pallas `_tuples_kernel`)
// and score_loci.cu (the port of `_scoring_kernel`). Both Pallas kernels
// run the same body, `_score_rows` (pisces_tpu/ops/pallas_scoring.py:130-217),
// with its f32 helpers (:49-127); `score_locus` below is that body for one
// locus, and each kernel is only the prologue that feeds it.
//
// The math is the Pallas helpers' f32 arithmetic step for step, built
// without fast math and without FMA contraction (-fmad=false), so the plain
// PyTorch version (ops/scoring_kernels.score_reference_tuples_plain) rounds
// the same way: jnp.round's half-to-even is rintf, the integer halving of
// stitched counts is integer division, and the no-bias sentinel is -1e38 as
// in the Pallas kernel. Each Poisson tail evaluates only the series branch
// it selects (the Pallas kernel computes both and selects per lane, which a
// SIMD TPU core must do anyway).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeries = 64;
constexpr float kLn10 = 2.302585092994046f;
constexpr float kHalfLn2Pi = 0.9189385332046727f;

}  // namespace

// Scoring configuration. The floats are the Pallas kernel's f32 constants,
// computed in f64 on the host and cast; the ints are the genotype codes and
// filter bits of pisces_tpu_torch/domain/types.py and ops/scoring_params.py.
struct ScoreParams {
  float noise_freq;
  float log1m_noise;
  float max_variant_qscore;
  float min_frequency_filter;
  float min_depth;
  float target_lod;
  float min_gq;
  float max_gq;
  float low_depth_filter;
  int32_t variant_qscore_filter;
  int32_t min_gq_int;
  int32_t gt_hom_ref;
  int32_t gt_ref_like_nocall;
  int32_t gt_ref_and_nocall;
  int32_t bit_low_depth;
  int32_t bit_low_variant_qscore;
};

// lgamma(k+1) for k >= 0: 8-step shift, then Stirling (_lgamma1p).
__device__ inline float lgamma1p(float k) {
  float z = k + 1.0f;
  float shift = 0.0f;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (z < 8.0f) {
      shift = shift - logf(z);
      z = z + 1.0f;
    }
  }
  const float zi = 1.0f / z;
  const float zi2 = zi * zi;
  const float stir = (z - 0.5f) * logf(z) - z + kHalfLn2Pi +
                     zi * ((float)(1.0 / 12.0) -
                           zi2 * ((float)(1.0 / 360.0) - zi2 / 1260.0f));
  return stir + shift;
}

// ln Poisson pmf(k; lam), safe at k=0 / lam=0 (_log_pmf).
__device__ inline float log_pmf(float k, float lam) {
  return k * logf(fmaxf(lam, 1e-30f)) - lam - lgamma1p(k);
}

// sum_{j>=0} prod_{i=1..j} lam/(k+i) (_upper_series).
__device__ inline float upper_series(float k, float lam) {
  float term = 1.0f, acc = 1.0f;
  for (int j = 1; j <= kSeries; ++j) {
    term = term * lam / (k + (float)j);
    acc = acc + term;
  }
  return acc;
}

// sum_{j>=0} prod_{i=0..j-1} (m-i)/lam (_lower_series).
__device__ inline float lower_series(float m, float lam) {
  const float safe_lam = fmaxf(lam, 1e-30f);
  float term = 1.0f, acc = 1.0f;
  for (int j = 1; j <= kSeries; ++j) {
    term = term * fmaxf(m - (float)(j - 1), 0.0f) / safe_lam;
    acc = acc + term;
  }
  return acc;
}

// P(X >= k) and its log10 (_poisson_tail): the upper series when k > lam,
// the lower-series complement otherwise; k <= 0 means "always".
__device__ inline void poisson_tail(float k, float lam, float* tail,
                                    float* log10_tail) {
  if (k <= 0.0f) {
    *tail = 1.0f;
    *log10_tail = 0.0f;
    return;
  }
  if (k > lam) {
    const float up_log = (log_pmf(k, lam) + logf(upper_series(k, lam))) /
                         kLn10;
    *log10_tail = up_log;
    *tail = expf(up_log * kLn10);
  } else {
    const float m = fmaxf(k - 1.0f, 0.0f);
    const float low = expf(log_pmf(m, lam)) * lower_series(m, lam);
    const float low_tail = fmaxf(1.0f - low, 1e-38f);
    *log10_tail = log10f(low_tail);
    *tail = low_tail;
  }
}

// P(X <= trunc(m)) in linear space (_lower_cdf), the GQ Poisson gate.
__device__ inline float lower_cdf(float m, float lam) {
  const float mt = truncf(fmaxf(m, 0.0f));
  if (mt + 1.0f > lam) {
    const float upper = expf(log_pmf(mt + 1.0f, lam)) *
                        upper_series(mt + 1.0f, lam);
    return fmaxf(1.0f - upper, 0.0f);
  }
  const float low = expf(log_pmf(mt, lam)) * lower_series(mt, lam);
  return fminf(low, 1.0f);
}

// Extended-model PopulateStats (_sb_stats): chance of a false positive and
// chance that the variant frequency is above zero.
__device__ inline void sb_stats(float support, float coverage,
                                const ScoreParams& p, float* cfp,
                                float* cvfgz) {
  if (support <= 0.0f) {
    const float z = expf(coverage * p.log1m_noise);
    *cvfgz = z;
    *cfp = 1.0f - z;
    return;
  }
  float tail, lt;
  poisson_tail(support, coverage * p.noise_freq, &tail, &lt);
  *cvfgz = fmaxf(0.0f, 1.0f - tail);
  *cfp = fmaxf(tail, 0.0f);
}

struct ScoreOut {
  int32_t total, support, q, gt, gq, filter_bits;
  float freq, sb_gatk;
};

// `_score_rows` for one locus: sup/cov are the (F, R, S) support and
// coverage as f32, sup_s/cov_s the stitched counts as integers (halved by
// integer division for the strand-bias sides).
__device__ inline ScoreOut score_locus(const float sup[3], const float cov[3],
                                       int32_t sup_s, int32_t cov_s,
                                       const ScoreParams& p) {
  ScoreOut o;
  const float total = cov[0] + cov[1] + cov[2];
  const float support = sup[0] + sup[1] + sup[2];

  // Poisson q-score: p = P(X >= support), lam = err * cov
  const float lam = p.noise_freq * total;
  float tail, log10_p;
  poisson_tail(support, lam, &tail, &log10_p);
  const float q = fminf(fmaxf(-10.0f * log10_p, 0.0f), p.max_variant_qscore);
  int32_t qi = (int32_t)rintf(q);
  if (support <= 0.0f || total <= 0.0f) qi = 0;

  const float freq =
      total <= 0.0f ? 0.0f : fminf(support / fmaxf(total, 1.0f), 1.0f);

  // strand bias (Extended model); stitched counts split by integer halving
  const float half_s = (float)(sup_s / 2);
  const float half_c = (float)(cov_s / 2);
  float ov_cfp, ov_cvfgz, fw_cfp, fw_cvfgz, rv_cfp, rv_cvfgz;
  sb_stats(support, total, p, &ov_cfp, &ov_cvfgz);
  sb_stats(sup[0] + half_s, cov[0] + half_c, p, &fw_cfp, &fw_cvfgz);
  sb_stats(sup[1] + half_s, cov[1] + half_c, p, &rv_cfp, &rv_cvfgz);
  float score;
  if (ov_cvfgz == 0.0f) {
    score = 1.0f;
  } else {
    const float fwd = fw_cvfgz * rv_cfp / ov_cvfgz;
    const float rev = rv_cvfgz * fw_cfp / ov_cvfgz;
    score = fmaxf(fwd, rev);
  }
  const bool cov_both = (cov[0] + half_c > 0.0f) && (cov[1] + half_c > 0.0f);
  if (!cov_both) score = 0.0f;
  float gatk =
      score > 0.0f ? 10.0f * log10f(fmaxf(score, 1e-38f)) : -1e38f;
  if (!(support > 0.0f)) gatk = 0.0f;

  // somatic genotype of a reference locus
  int32_t gt = p.gt_hom_ref;
  if (freq < p.min_frequency_filter) gt = p.gt_ref_like_nocall;
  if (freq >= p.min_frequency_filter &&
      (1.0f - freq) > p.min_frequency_filter)
    gt = p.gt_ref_and_nocall;
  if (total < p.min_depth) gt = p.gt_ref_like_nocall;

  // GQ (SomaticGenotypeQualityCalculator, hom branch)
  const float non_allele = (1.0f - freq) * total;
  const float expected = p.target_lod * total;
  float raw;
  if (gt == p.gt_hom_ref) {
    if (non_allele >= expected) {
      raw = p.min_gq;
    } else {
      const float p1 = powf(10.0f, -(float)qi / 10.0f);
      const float p2 = lower_cdf(non_allele, expected);
      raw = -10.0f * log10f(fmaxf(p1 + p2, 1e-38f));
    }
  } else {
    raw = (float)qi;
  }
  int32_t gq = (int32_t)rintf(fminf(fmaxf(raw, p.min_gq), p.max_gq));
  if (total <= 0.0f || gt == p.gt_ref_like_nocall) gq = p.min_gq_int;

  int32_t fb = 0;
  if (total < p.low_depth_filter) fb |= 1 << p.bit_low_depth;
  if (qi < p.variant_qscore_filter && total != 0.0f)
    fb |= 1 << p.bit_low_variant_qscore;

  o.total = (int32_t)total;
  o.support = (int32_t)support;
  o.q = qi;
  o.gt = gt;
  o.gq = gq;
  o.filter_bits = fb;
  o.freq = freq;
  o.sb_gatk = gatk;
  return o;
}

// Launch on `device` (the CUDA ordinal of the caller's tensors). The kernel
// libraries link the static CUDA runtime, whose current device is not the
// one torch.cuda.device(...) sets, so each launcher makes the tensors'
// device current, launches on the caller's stream, and makes the previous
// device current again (the current context is the thread's, shared with
// PyTorch's runtime). Returns the first CUDA error, or 0.
template <typename Launch>
inline int launch_on(int device, Launch launch) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  launch();
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
