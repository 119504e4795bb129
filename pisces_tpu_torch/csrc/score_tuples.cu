// Reference-locus scoring from unique (support, coverage)-by-direction
// tuples: the Hopper (sm_90a) version of the reference package's Pallas
// kernel `_tuples_kernel` (pisces_tpu/ops/pallas_scoring.py:245-258, body
// `_score_rows` :130-217 and its f32 helpers :49-127, shared with the
// counts kernel in score_locus.cuh).
//
// Contract, per locus i of n:
//   in   tuples [n, 6] int32  (support F, R, S, coverage F, R, S)
//        num_nc [n] int32 or null (N-call count, passed through)
//   out  out_i  [7, n] int32  rows: total coverage, support, Poisson Q,
//                             somatic reference genotype, GQ, filter bits,
//                             N-call count
//        out_f  [2, n] f32    rows: frequency, Extended-model SB (GATK dB)
//
// What bounds it: arithmetic. Each locus runs four Poisson tails (Q and the
// three strand-bias sides) plus the GQ lower CDF, each a fixed 64-term
// series with one f32 divide per term, and about ten lgamma shift steps
// with a logf each, against 28 bytes read and 36 bytes written. On an H100
// that is hundreds of divide and transcendental instructions per 64 bytes
// of memory traffic, so the card's memory rate is never the limit.
//
// What the design does about it: one thread per locus, no shared memory,
// no synchronisation, so every SM keeps as many warps in flight as its
// registers allow and the divide/SFU pipes stay busy.
//
// The launcher allocates nothing, runs on the caller's stream and device,
// and returns the CUDA error so the wrapper can raise on a refused launch.

#include "score_locus.cuh"

__global__ void score_tuples_kernel(const int32_t* __restrict__ tuples,
                                    const int32_t* __restrict__ num_nc,
                                    int64_t n, int32_t* __restrict__ out_i,
                                    float* __restrict__ out_f,
                                    ScoreParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged edge: no padding to a tile
  const int32_t* t = tuples + i * 6;
  const float sup[3] = {(float)t[0], (float)t[1], (float)t[2]};
  const float cov[3] = {(float)t[3], (float)t[4], (float)t[5]};
  const ScoreOut o = score_locus(sup, cov, t[2], t[5], p);
  out_i[0 * n + i] = o.total;
  out_i[1 * n + i] = o.support;
  out_i[2 * n + i] = o.q;
  out_i[3 * n + i] = o.gt;
  out_i[4 * n + i] = o.gq;
  out_i[5 * n + i] = o.filter_bits;
  out_i[6 * n + i] = num_nc != nullptr ? num_nc[i] : 0;
  out_f[0 * n + i] = o.freq;
  out_f[1 * n + i] = o.sb_gatk;
}

extern "C" int score_tuples_launch(const int32_t* tuples,
                                   const int32_t* num_nc, int64_t n,
                                   int32_t* out_i, float* out_f,
                                   const ScoreParams* params, int device,
                                   void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return launch_on(device, [&] {
    score_tuples_kernel<<<(unsigned int)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(tuples, num_nc, n, out_i,
                                                  out_f, *params);
  });
}
