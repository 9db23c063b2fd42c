// Shared device helpers of the RPCA ADMM tail kernels (admm_tail.cu,
// subspace_apply.cu, subspace_apply_factored.cu) and soft_threshold.cu: the
// soft-threshold shrink and a deterministic block-wide sum.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;  // every tail kernel launches 256-thread blocks

// sign(z) * max(|z| - t, 0), bit-compatible with the jnp/torch form: a
// negative z that shrinks to zero gives -0.0 (sign(z) * 0.0), and NaN
// propagates (NaN < 0 is false, so the NaN survives the clamp).
__device__ __forceinline__ float shrink(float z, float t) {
  float a = fabsf(z) - t;
  a = (a < 0.f) ? 0.f : a;
  return copysignf(a, z);
}

// Sum of one float per thread over a kThreads block.  Fixed shuffle tree
// inside each warp, then warp 0 adds the per-warp sums in warp order, so
// the result is the same bits on every launch (no atomics).  The value is
// valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  }
  return total;
}

}  // namespace repro
