// The reference-locus scoring math and tile shape shared by the two Hopper
// (sm_90a) scoring kernels: score_tuples.cu (the port of the Pallas
// `_tuples_kernel`) and score_loci.cu (the port of `_scoring_kernel`). Both
// Pallas kernels run the same body, `_score_rows`
// (pisces_tpu/ops/pallas_scoring.py:130-217), with its f32 helpers
// (:49-127); run_role and write_group below are that body, split into the
// four Poisson tails it needs and the outputs it writes, and each kernel is
// only the prologue that stages its tile and feeds them.
//
// The math is the Pallas helpers' f32 arithmetic step for step, built
// without fast math and without FMA contraction (-fmad=false), so the plain
// PyTorch version (ops/scoring_kernels.score_reference_tuples_plain) rounds
// the same way: jnp.round's half-to-even is rintf, the integer halving of
// stitched counts is integer division, and the no-bias sentinel is -1e38 as
// in the Pallas kernel. Three departures change the work, not one output
// bit: each Poisson tail evaluates only the series branch it selects (the
// Pallas kernel computes both and selects per lane, which a SIMD TPU core
// must do anyway); each series stops at its exact exit instead of running
// all 64 terms; and the overall tail, which `_score_rows` computes twice (Q
// and the overall strand-bias side), is computed once. No series is summed
// in parallel: a tree sum rounds differently and moves the integer Q at
// rounding boundaries.

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

// The two series below keep the 64-term plain series' order of operations
// per term and stop at the exact exit: the first term that is no larger
// than the one before and leaves the sum unchanged. On the branch each
// serves the terms do not grow (each is the last times a ratio below one),
// and f32 rounding is monotone, so once acc + term == acc every later term
// leaves acc unchanged too: the sum is bit-equal to the 64-term one. A
// series that never exits (a NaN, a growing term) still runs all 64.

// sum_{j>=0} prod_{i=1..j} lam/(k+i) (_upper_series).
__device__ inline float upper_series(float k, float lam) {
  float term = 1.0f, acc = 1.0f;
  for (int j = 1; j <= kSeries; ++j) {
    const float next = term * lam / (k + (float)j);
    const float sum = acc + next;
    if (next <= term && sum == acc) break;
    term = next;
    acc = sum;
  }
  return acc;
}

// sum_{j>=0} prod_{i=0..j-1} (m-i)/lam (_lower_series); its terms are
// exactly 0 from j = m + 2 on.
__device__ inline float lower_series(float m, float lam) {
  const float safe_lam = fmaxf(lam, 1e-30f);
  float term = 1.0f, acc = 1.0f;
  for (int j = 1; j <= kSeries; ++j) {
    const float next = term * fmaxf(m - (float)(j - 1), 0.0f) / safe_lam;
    const float sum = acc + next;
    if (next <= term && sum == acc) break;
    term = next;
    acc = sum;
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

// Extended-model PopulateStats (_sb_stats) of one strand side: chance of a
// false positive and chance that the variant frequency is above zero.
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

// ---------------------------------------------------------------------------
// The tile: the shape both kernels share
// ---------------------------------------------------------------------------
//
// A block of kThreads threads scores one tile of loci. Each kernel's
// prologue stages its tile's inputs into shared memory with coalesced
// 16-byte cp.async copies and fills the Tile's (support, coverage) by
// direction; score_tile then runs the four roles below and the epilogue. The tile
// comes in two shapes, chosen per launch by split_roles:
//
// - split (kSplit): 32 loci, and warp w runs role w for all of them, lane j
//   on locus j: every lane of a warp runs the same function, so a warp
//   diverges only where its loci take different series branches, and a
//   block waits for its longest tail, not for four in a row. Then warp w
//   writes epilogue group w's rows, each store a contiguous run of the
//   tile's columns. It gives four times the warps of one thread per locus,
//   which is what a small grid needs (the main path's few thousand tuples).
// - one thread per locus: 128 loci, each thread runs every role for its own
//   locus and each warp every group over its 32. On a large grid it keeps
//   every warp busy, where in the split the warps whose tails are short
//   wait at the barrier for the longest.

namespace {

constexpr int kThreads = 128;
constexpr int kRoles = 4;  // = the block's warps, one role each when split

template <bool kSplit>
__host__ __device__ constexpr int tile_loci() {
  return kSplit ? 32 : kThreads;
}

// the grid of a launch over n loci in tiles of one shape
template <bool kSplit>
unsigned int tile_blocks(int64_t n) {
  return (unsigned int)((n + tile_loci<kSplit>() - 1) / tile_loci<kSplit>());
}

}  // namespace

// One tile's loci in shared memory: each kernel's prologue writes the
// inputs, each role its results, and the epilogue reads both.
template <bool kSplit>
struct Tile {
  static constexpr int kLoci = tile_loci<kSplit>();
  float sup[3][kLoci];    // support F, R, S
  float cov[3][kLoci];    // coverage F, R, S
  int32_t sup_s[kLoci];   // stitched support and coverage as integers,
  int32_t cov_s[kLoci];   // halved by integer division for the sides
  int32_t q[kLoci];                                  // role 0
  float ov_cfp[kLoci], ov_cvfgz[kLoci];              // role 0
  float side_cfp[2][kLoci], side_cvfgz[2][kLoci];    // roles 1, 2
  float gq_cdf[kLoci];                               // role 3
};

// Copy `count` int32 from global `src` to shared `dst` (16-byte aligned)
// with the whole block, coalesced: 16-byte asynchronous copies (cp.async,
// past L1 and the registers) where src is 16-byte aligned, then one int32 a
// thread for the rest. A kernel's stage() calls are all in flight at once;
// stage_wait() before the block's barrier waits for this thread's. (On an
// H100, cp.async measured up to 5% faster than plain 16-byte loads and no
// slower on any aligned tile; one cp.async.bulk per array onto an mbarrier
// measured within about 3% of it: PERF.md, from
// python -m pisces_tpu_torch.kernel_ab.)
__device__ inline void stage(int32_t* dst, const int32_t* __restrict__ src,
                             int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int quads = count >> 2;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < quads; i += blockDim.x) {
      const uint32_t to = (uint32_t)__cvta_generic_to_shared(d + i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                   "l"(s + i)
                   : "memory");
    }
    done = quads << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

__device__ inline void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kSplit>
__device__ inline float total_of(const Tile<kSplit>& t, int j) {
  return t.cov[0][j] + t.cov[1][j] + t.cov[2][j];
}

template <bool kSplit>
__device__ inline float support_of(const Tile<kSplit>& t, int j) {
  return t.sup[0][j] + t.sup[1][j] + t.sup[2][j];
}

__device__ inline float frequency(float support, float total) {
  return total <= 0.0f ? 0.0f : fminf(support / fmaxf(total, 1.0f), 1.0f);
}

// somatic genotype of a reference locus
__device__ inline int32_t genotype(float freq, float total,
                                   const ScoreParams& p) {
  int32_t gt = p.gt_hom_ref;
  if (freq < p.min_frequency_filter) gt = p.gt_ref_like_nocall;
  if (freq >= p.min_frequency_filter &&
      (1.0f - freq) > p.min_frequency_filter)
    gt = p.gt_ref_and_nocall;
  if (total < p.min_depth) gt = p.gt_ref_like_nocall;
  return gt;
}

// Role r of `_score_rows` for locus j, each one Poisson tail:
//   0  the overall tail P(X >= support), lam = noise_freq * total, once for
//      both the Poisson Q and the overall strand-bias side (the Pallas
//      kernel and the plain version compute it twice, the second time with
//      lam = total * noise_freq: IEEE multiplication commutes, so it is the
//      same f32 call);
//   1, 2  the forward and the reverse strand-bias side;
//   3  the GQ Poisson gate's lower CDF, where the genotype is hom-ref and
//      non_allele < expected (recomputing both costs a few operations).
template <bool kSplit>
__device__ inline void run_role(int role, int j, Tile<kSplit>& t,
                                const ScoreParams& p) {
  const float total = total_of(t, j);
  const float support = support_of(t, j);
  if (role == 0) {
    int32_t qi = 0;
    if (support <= 0.0f) {
      const float z = expf(total * p.log1m_noise);
      t.ov_cvfgz[j] = z;
      t.ov_cfp[j] = 1.0f - z;
    } else {
      float tail, log10_p;
      poisson_tail(support, p.noise_freq * total, &tail, &log10_p);
      const float q =
          fminf(fmaxf(-10.0f * log10_p, 0.0f), p.max_variant_qscore);
      if (total > 0.0f) qi = (int32_t)rintf(q);
      t.ov_cvfgz[j] = fmaxf(0.0f, 1.0f - tail);
      t.ov_cfp[j] = fmaxf(tail, 0.0f);
    }
    t.q[j] = qi;
  } else if (role < 3) {
    // stitched counts split by integer halving
    const int d = role - 1;
    sb_stats(t.sup[d][j] + (float)(t.sup_s[j] / 2),
             t.cov[d][j] + (float)(t.cov_s[j] / 2), p, &t.side_cfp[d][j],
             &t.side_cvfgz[d][j]);
  } else {
    const float freq = frequency(support, total);
    const float non_allele = (1.0f - freq) * total;
    const float expected = p.target_lod * total;
    if (genotype(freq, total, p) == p.gt_hom_ref && non_allele < expected)
      t.gq_cdf[j] = lower_cdf(non_allele, expected);
  }
}

// Epilogue group g of locus j, written to column i of out_i [7, n] and
// out_f [2, n]:
//   0  Poisson Q, genotype, GQ (SomaticGenotypeQualityCalculator, hom
//      branch): out_i rows 2, 3, 4;
//   1  Extended-model strand bias (GATK dB): out_f row 1;
//   2  total coverage, support, filter bits: out_i rows 0, 1, 5; frequency:
//      out_f row 0.
// Group 3 (the N-call count, row 6, and the counts kernel's by-direction
// rows) is each kernel's own.
template <bool kSplit>
__device__ inline void write_group(int g, int j, const Tile<kSplit>& t,
                                   const ScoreParams& p, int64_t i,
                                   int64_t n, int32_t* __restrict__ out_i,
                                   float* __restrict__ out_f) {
  const float total = total_of(t, j);
  const float support = support_of(t, j);
  const int32_t qi = t.q[j];
  if (g == 0) {
    const float freq = frequency(support, total);
    const int32_t gt = genotype(freq, total, p);
    const float non_allele = (1.0f - freq) * total;
    const float expected = p.target_lod * total;
    float raw;
    if (gt == p.gt_hom_ref) {
      if (non_allele >= expected) {
        raw = p.min_gq;
      } else {
        const float p1 = powf(10.0f, -(float)qi / 10.0f);
        raw = -10.0f * log10f(fmaxf(p1 + t.gq_cdf[j], 1e-38f));
      }
    } else {
      raw = (float)qi;
    }
    int32_t gq = (int32_t)rintf(fminf(fmaxf(raw, p.min_gq), p.max_gq));
    if (total <= 0.0f || gt == p.gt_ref_like_nocall) gq = p.min_gq_int;
    out_i[2 * n + i] = qi;
    out_i[3 * n + i] = gt;
    out_i[4 * n + i] = gq;
  } else if (g == 1) {
    const float ov = t.ov_cvfgz[j];
    float score;
    if (ov == 0.0f) {
      score = 1.0f;
    } else {
      const float fwd = t.side_cvfgz[0][j] * t.side_cfp[1][j] / ov;
      const float rev = t.side_cvfgz[1][j] * t.side_cfp[0][j] / ov;
      score = fmaxf(fwd, rev);
    }
    const float half_c = (float)(t.cov_s[j] / 2);
    if (!(t.cov[0][j] + half_c > 0.0f && t.cov[1][j] + half_c > 0.0f))
      score = 0.0f;
    float gatk =
        score > 0.0f ? 10.0f * log10f(fmaxf(score, 1e-38f)) : -1e38f;
    if (!(support > 0.0f)) gatk = 0.0f;
    out_f[n + i] = gatk;
  } else {
    int32_t fb = 0;
    if (total < p.low_depth_filter) fb |= 1 << p.bit_low_depth;
    if (qi < p.variant_qscore_filter && total != 0.0f)
      fb |= 1 << p.bit_low_variant_qscore;
    out_i[0 * n + i] = (int32_t)total;
    out_i[1 * n + i] = (int32_t)support;
    out_i[5 * n + i] = fb;
    out_f[i] = frequency(support, total);
  }
}

// The roles and the epilogue of the tile of `count` loci starting at locus
// `base`, once the kernel's prologue has filled t and synchronised.
// own(lo, cnt, lane) writes the kernel's own group for the warp's loci
// lo .. lo + cnt - 1.
template <bool kSplit, typename Own>
__device__ inline void score_tile(Tile<kSplit>& t, int count, int64_t base,
                                  int64_t n, int32_t* __restrict__ out_i,
                                  float* __restrict__ out_f,
                                  const ScoreParams& p, Own own) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (kSplit) {
    if (lane < count) run_role(warp, lane, t, p);
  } else if ((int)threadIdx.x < count) {
    for (int r = 0; r < kRoles; ++r) run_role(r, threadIdx.x, t, p);
  }
  __syncthreads();
  const int lo = kSplit ? 0 : warp * 32;
  const int cnt = min(32, count - lo);
  for (int g = kSplit ? warp : 0; g < (kSplit ? warp + 1 : kRoles); ++g) {
    if (g == kRoles - 1)
      own(lo, cnt, lane);
    else if (lane < cnt)
      write_group(g, lo + lane, t, p, base + lo + lane, n, out_i, out_f);
  }
}

// Whether a launch over n loci splits the roles over warps: while the
// one-thread-per-locus grid (n / 128 blocks) gives each SM fewer than four
// blocks, 16 warps, four per scheduler, too few to hide each thread's chain
// of dependent divides and transcendentals, the split's four times as many
// warps, each waiting on one tail, finish sooner; from there on, one thread
// per locus keeps every warp busy where the split's short roles wait at
// the barrier for the longest (PERF.md gives the crossover on an H100).
// Each device's SM count is read once and kept (a race only writes the
// same value twice).
inline bool split_roles(int64_t n, int device) {
  static int sms[64] = {};
  int count = device >= 0 && device < 64 ? sms[device] : 0;
  if (count == 0) {
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (device >= 0 && device < 64) sms[device] = count;
  }
  return (n + kThreads - 1) / kThreads < 4 * (int64_t)count;
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
