// Reference-locus scoring from raw pileup counts: the Hopper (sm_90a)
// version of the reference package's Pallas kernel `_scoring_kernel`
// (pisces_tpu/ops/pallas_scoring.py:220-242, reached through
// `score_reference_loci_pallas` :316-336). Its body `_score_rows` is
// score_locus in score_locus.cuh, shared with the tuple kernel; this file
// is the prologue that derives the by-direction tuple from 18 counts.
//
// Contract, per locus i of n:
//   in   counts   [n, 6, 3] int32  anchor-summed counts (allele, direction)
//        ref_code [n] int32        reference allele code
//   out  out_i    [7, n] int32     rows: total coverage, support, Poisson Q,
//                                  somatic reference genotype, GQ, filter
//                                  bits, N-call count
//        out_f    [2, n] f32       rows: frequency, Extended-model SB (dB)
//        out_dir  [2, n, 3] int32  coverage by direction, support by
//                                  direction
//
// Per direction, coverage is the f32 sum of the A, C, G, T and deletion
// counts in the Pallas kernel's order; support is the count of the row the
// reference code names. That is the XLA semantics of the path this kernel
// serves (jax_scoring.score_reference_loci, the mesh step), not the Pallas
// kernel's: Pallas adds a channel to support only for the codes of A, C, G,
// T and deletion, so at a reference N (code 4) it gives zero support where
// the XLA path takes the N count. A code outside 0-5 gives zero support.
//
// What bounds it: counted at one per f32 operation, bytes: 76 read and 60
// written per locus against the 36-operation prologue and the tails' series
// on the branches the data takes (under 2,700 operations a locus at 750x),
// below the card's 20 operations per byte. In practice the arithmetic: each
// series term is an IEEE divide of several instructions and the logs and
// exps run on the special-function units, so the kernel runs far above both
// bounds (PERF.md).
//
// What the design does about it: one thread per locus, no shared memory, no
// synchronisation, so every SM keeps as many warps in flight as its
// registers allow. Each thread reads its 72 bytes of counts itself; the
// strided loads cost little beside the series work.
//
// The launcher allocates nothing, runs on the caller's stream and device,
// and returns the CUDA error so the wrapper can raise on a refused launch.

#include "score_locus.cuh"

namespace {

// allele codes of pisces_tpu_torch/domain/types.py AlleleType
constexpr int kA = 0, kG = 1, kC = 2, kT = 3, kAlleleN = 4, kDel = 5;
constexpr int kAlleles = 6;

}  // namespace

__global__ void score_loci_kernel(const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ ref_code,
                                  int64_t n, int32_t* __restrict__ out_i,
                                  float* __restrict__ out_f,
                                  int32_t* __restrict__ out_dir,
                                  ScoreParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged edge: no padding to a tile
  const int32_t* c = counts + i * (kAlleles * 3);
  const int32_t ref = ref_code[i];
  const bool ref_ok = ref >= 0 && ref < kAlleles;
  float sup[3], cov[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // the order of COVERAGE_CONTRIBUTING_ALLELES: A, C, G, T, deletion
    float s = (float)c[kA * 3 + d];
    s = s + (float)c[kC * 3 + d];
    s = s + (float)c[kG * 3 + d];
    s = s + (float)c[kT * 3 + d];
    s = s + (float)c[kDel * 3 + d];
    cov[d] = s;
    sup[d] = ref_ok ? (float)c[ref * 3 + d] : 0.0f;
  }
  const int32_t num_nc =
      c[kAlleleN * 3] + c[kAlleleN * 3 + 1] + c[kAlleleN * 3 + 2];
  const ScoreOut o =
      score_locus(sup, cov, (int32_t)sup[2], (int32_t)cov[2], p);
  out_i[0 * n + i] = o.total;
  out_i[1 * n + i] = o.support;
  out_i[2 * n + i] = o.q;
  out_i[3 * n + i] = o.gt;
  out_i[4 * n + i] = o.gq;
  out_i[5 * n + i] = o.filter_bits;
  out_i[6 * n + i] = num_nc;
  out_f[0 * n + i] = o.freq;
  out_f[1 * n + i] = o.sb_gatk;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    out_dir[i * 3 + d] = (int32_t)cov[d];
    out_dir[(n + i) * 3 + d] = (int32_t)sup[d];
  }
}

extern "C" int score_loci_launch(const int32_t* counts,
                                 const int32_t* ref_code, int64_t n,
                                 int32_t* out_i, float* out_f,
                                 int32_t* out_dir, const ScoreParams* params,
                                 int device, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return launch_on(device, [&] {
    score_loci_kernel<<<(unsigned int)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(counts, ref_code, n, out_i,
                                                out_f, out_dir, *params);
  });
}
