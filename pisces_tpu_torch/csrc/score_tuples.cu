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
// What bounds it: counted at one per f32 operation, bytes: 28 read and 36
// written per tuple, against a few hundred operations once each series
// stops at its exact exit (the main path's deep loci exit the upper series
// after about 4 terms). In practice each tail is a dependent chain of IEEE
// divides, logs and exps, and the main path hands the kernel only a few
// thousand tuples, so latency bounds it: the chain's, and the launch's.
//
// What the design does about it: the exact exit cuts each chain to the
// terms that change the sum, and the overall tail runs once. Each block
// scores a tile of loci whose tuples come in as 16-byte cp.async copies
// and whose output rows leave as contiguous runs. While the grid is small,
// as at the main path's 6,119 tuples, the tile is 32 loci and the four tails of a
// locus run in four warps side by side, one role per warp (192 blocks of
// four busy warps for 132 SMs, each waiting on one tail, not four in a
// row); on a large grid one thread per locus keeps every warp busy
// (score_locus.cuh, split_roles).
//
// The launcher allocates nothing, runs on the caller's stream and device,
// and returns the CUDA error so the wrapper can raise on a refused launch.

#include "score_locus.cuh"

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    score_tuples_kernel(const int32_t* __restrict__ tuples,
                        const int32_t* __restrict__ num_nc, int64_t n,
                        int32_t* __restrict__ out_i,
                        float* __restrict__ out_f, ScoreParams p) {
  constexpr int kLoci = tile_loci<kSplit>();
  __shared__ __align__(16) int32_t s_in[kLoci * 6];
  __shared__ __align__(16) int32_t s_nc[kLoci];
  __shared__ Tile<kSplit> t;
  const int64_t base = (int64_t)blockIdx.x * kLoci;
  const int count = (int)min((int64_t)kLoci, n - base);  // ragged edge
  stage(s_in, tuples + base * 6, count * 6);
  if (num_nc != nullptr) stage(s_nc, num_nc + base, count);
  stage_wait();
  __syncthreads();
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int32_t* r = s_in + j * 6;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      t.sup[d][j] = (float)r[d];
      t.cov[d][j] = (float)r[3 + d];
    }
    t.sup_s[j] = r[2];
    t.cov_s[j] = r[5];
    if (num_nc == nullptr) s_nc[j] = 0;
  }
  __syncthreads();
  const int32_t* nc = s_nc;
  auto own = [=](int lo, int cnt, int lane) {  // the N-call count row
    if (lane < cnt) out_i[6 * n + base + lo + lane] = nc[lo + lane];
  };
  score_tile(t, count, base, n, out_i, out_f, p, own);
}

extern "C" int score_tuples_launch(const int32_t* tuples,
                                   const int32_t* num_nc, int64_t n,
                                   int32_t* out_i, float* out_f,
                                   const ScoreParams* params, int device,
                                   void* stream) {
  if (n <= 0) return 0;
  return launch_on(device, [&] {
    const cudaStream_t s = (cudaStream_t)stream;
    if (split_roles(n, device))
      score_tuples_kernel<true><<<tile_blocks<true>(n), kThreads, 0, s>>>(
          tuples, num_nc, n, out_i, out_f, *params);
    else
      score_tuples_kernel<false><<<tile_blocks<false>(n), kThreads, 0, s>>>(
          tuples, num_nc, n, out_i, out_f, *params);
  });
}
