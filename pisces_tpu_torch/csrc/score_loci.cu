// Reference-locus scoring from raw pileup counts: the Hopper (sm_90a)
// version of the reference package's Pallas kernel `_scoring_kernel`
// (pisces_tpu/ops/pallas_scoring.py:220-242, reached through
// `score_reference_loci_pallas` :316-336). Its body `_score_rows` is the
// roles and epilogue of score_locus.cuh, shared with the tuple kernel; this
// file is the prologue that derives the by-direction tuple from 18 counts.
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
// What bounds it: bytes. 76 read and 60 written per locus, against the
// 36-operation prologue and a few hundred operations of tails once each
// series stops at its exact exit (the mesh's deep loci exit the upper
// series after about 4 terms): under the card's 20 f32 operations per
// byte. The arithmetic is still dependent chains of IEEE divides, logs and
// exps, so the memory traffic has to overlap them.
//
// What the design does about it: a tile's counts are contiguous (72 bytes
// a locus) and are staged into shared memory with 16-byte cp.async
// copies by the whole block, so every copy of a warp is one coalesced run
// (a thread reading its own locus would load at a 72-byte stride, and
// write the by-direction rows at a 12-byte stride); each output row, the
// by-direction rows included, leaves as contiguous runs. The prologue
// derives each locus's tuple in shared memory. On the mesh's 200,192-locus
// tile each thread then runs the four tails of its locus, so every warp
// stays busy while others wait on memory; on a small tile (the 4-shard
// mesh's 50,176 loci) the four tails run in four warps side by side
// (score_locus.cuh, split_roles).
//
// The launcher allocates nothing, runs on the caller's stream and device,
// and returns the CUDA error so the wrapper can raise on a refused launch.

#include "score_locus.cuh"

namespace {

// allele codes of pisces_tpu_torch/domain/types.py AlleleType
constexpr int kA = 0, kG = 1, kC = 2, kT = 3, kAlleleN = 4, kDel = 5;
constexpr int kAlleles = 6;

}  // namespace

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    score_loci_kernel(const int32_t* __restrict__ counts,
                      const int32_t* __restrict__ ref_code, int64_t n,
                      int32_t* __restrict__ out_i, float* __restrict__ out_f,
                      int32_t* __restrict__ out_dir, ScoreParams p) {
  constexpr int kLoci = tile_loci<kSplit>();
  constexpr int kRow = kAlleles * 3;
  __shared__ __align__(16) int32_t s_in[kLoci * kRow];
  __shared__ __align__(16) int32_t s_ref[kLoci];
  __shared__ int32_t s_nc[kLoci];
  __shared__ Tile<kSplit> t;
  const int64_t base = (int64_t)blockIdx.x * kLoci;
  const int count = (int)min((int64_t)kLoci, n - base);  // ragged edge
  stage(s_in, counts + base * kRow, count * kRow);
  stage(s_ref, ref_code + base, count);
  stage_wait();
  __syncthreads();
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int32_t* c = s_in + j * kRow;
    const int32_t ref = s_ref[j];
    const bool ref_ok = ref >= 0 && ref < kAlleles;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      // the order of COVERAGE_CONTRIBUTING_ALLELES: A, C, G, T, deletion
      float s = (float)c[kA * 3 + d];
      s = s + (float)c[kC * 3 + d];
      s = s + (float)c[kG * 3 + d];
      s = s + (float)c[kT * 3 + d];
      s = s + (float)c[kDel * 3 + d];
      t.cov[d][j] = s;
      t.sup[d][j] = ref_ok ? (float)c[ref * 3 + d] : 0.0f;
    }
    t.sup_s[j] = (int32_t)t.sup[2][j];
    t.cov_s[j] = (int32_t)t.cov[2][j];
    s_nc[j] = c[kAlleleN * 3] + c[kAlleleN * 3 + 1] + c[kAlleleN * 3 + 2];
  }
  __syncthreads();
  const int32_t* nc = s_nc;
  const Tile<kSplit>* tile = &t;
  auto own = [=](int lo, int cnt, int lane) {
    if (lane < cnt) out_i[6 * n + base + lo + lane] = nc[lo + lane];
    // coverage then support by direction, [2, n, 3]: each half of the
    // warp's loci is 3 * cnt contiguous int32
    for (int idx = lane; idx < 3 * cnt; idx += 32) {
      const int j = lo + idx / 3, d = idx % 3;
      out_dir[(base + lo) * 3 + idx] = (int32_t)tile->cov[d][j];
      out_dir[(n + base + lo) * 3 + idx] = (int32_t)tile->sup[d][j];
    }
  };
  score_tile(t, count, base, n, out_i, out_f, p, own);
}

extern "C" int score_loci_launch(const int32_t* counts,
                                 const int32_t* ref_code, int64_t n,
                                 int32_t* out_i, float* out_f,
                                 int32_t* out_dir, const ScoreParams* params,
                                 int device, void* stream) {
  if (n <= 0) return 0;
  return launch_on(device, [&] {
    const cudaStream_t s = (cudaStream_t)stream;
    if (split_roles(n, device))
      score_loci_kernel<true><<<tile_blocks<true>(n), kThreads, 0, s>>>(
          counts, ref_code, n, out_i, out_f, out_dir, *params);
    else
      score_loci_kernel<false><<<tile_blocks<false>(n), kThreads, 0, s>>>(
          counts, ref_code, n, out_i, out_f, out_dir, *params);
  });
}
