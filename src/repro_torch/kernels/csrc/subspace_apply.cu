// Fused subspace-SVT sweep tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/svt_subspace.py::subspace_apply.  Per module b of a
// (B, vec, d2) float32 bucket, with the (B, d2, d2) shrink projector P:
//
//   X     = M - S + rho_b * Y
//   L     = X @ P                                  (not masked)
//   S'    = shrink(M - L + rho_b * Y, thresh_b) * mask
//   resid = (M - L - S') * mask
//   Y'    = (Y + mu_b * resid) * mask
//   rsq_b = sum(resid^2)
//   G'_b  = X'^T X',  X' = M - S' + rho_b * Y'     (next iteration's Gram)
//
// Bound: device-memory bytes.  Six tensors of B*vec*d2*4 bytes move once
// each (M, S, Y read; L, S', Y' written) plus P and G'; the two products
// add 4*d2 flops per element, which at the cohort widths the engine hands
// in (d2 <= 128) stays below the card's fp32 operations-per-byte balance.
// The design keeps X and X' out of device memory: a block stages a tile of
// X rows in shared memory, forms L = X @ P against P staged in shared
// memory (in column tiles of at most 128 when d2 > 128), runs the
// elementwise tail, stages X' in shared memory, and adds the tile's X'^T X'
// into its own Gram partial.  Both products are plain fp32 FMA loops: no
// TF32, no tensor cores, so L and G' keep full fp32 precision.
//
// The TPU kernel carried the residual sum and the Gram across its
// sequential inner grid axis.  Blocks here run in no order, so each block
// owns one group of rows of one module, walks its rows in tiles, and keeps
// a private Gram partial (B, n_groups, d2, d2) and residual partial
// (B, n_groups) in scratch; a second kernel adds the groups of each module
// in group order.  No float atomics: the same inputs give the same bits on
// every launch.
#include <cuda_runtime.h>

#include "tail_common.cuh"

namespace {

using repro::kThreads;

__global__ void __launch_bounds__(kThreads)
subspace_apply_kernel(const float* __restrict__ m, const float* __restrict__ s,
                      const float* __restrict__ y, const float* __restrict__ p,
                      const float* __restrict__ rho, const float* __restrict__ mu,
                      const float* __restrict__ thresh,
                      const float* __restrict__ mask, float* __restrict__ l_out,
                      float* __restrict__ s_out, float* __restrict__ y_out,
                      float* __restrict__ r_part, float* __restrict__ g_part,
                      int vec, int d2, int tile_rows, int pcols,
                      int group_rows, int n_groups) {
  extern __shared__ float smem[];
  float* xs = smem;                      // (tile_rows, d2)  X tile
  float* x2s = xs + tile_rows * d2;      // (tile_rows, d2)  X' tile
  float* ps = x2s + tile_rows * d2;      // (d2, pcols)      P column tile
  float* msk = ps + d2 * pcols;          // (d2,)            client mask

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float r = rho[b];
  const float u = mu[b];
  const float t = thresh[b];
  const size_t mod = static_cast<size_t>(b) * vec * d2;
  const float* pb = p + static_cast<size_t>(b) * d2 * d2;
  float* gp = g_part + (static_cast<size_t>(b) * n_groups + g) * d2 * d2;

  for (int j = tid; j < d2; j += kThreads) msk[j] = mask[j];

  const int row0 = g * group_rows;
  const int row_end = min(row0 + group_rows, vec);
  float acc = 0.f;
  bool first = true;
  for (int rt = row0; rt < row_end; rt += tile_rows) {
    const int nrows = min(tile_rows, row_end - rt);
    const int tile_elems = nrows * d2;
    const size_t tile0 = mod + static_cast<size_t>(rt) * d2;
    __syncthreads();  // the previous tile's readers of xs / x2s are done
    for (int idx = tid; idx < tile_elems; idx += kThreads) {
      const size_t i = tile0 + idx;
      xs[idx] = m[i] - s[i] + r * y[i];
    }
    for (int c0 = 0; c0 < d2; c0 += pcols) {
      const int ncols = min(pcols, d2 - c0);
      __syncthreads();  // xs is complete; the previous ps readers are done
      for (int idx = tid; idx < d2 * ncols; idx += kThreads) {
        const int k = idx / ncols;
        const int jj = idx - k * ncols;
        ps[k * pcols + jj] = pb[static_cast<size_t>(k) * d2 + c0 + jj];
      }
      __syncthreads();
      for (int idx = tid; idx < nrows * ncols; idx += kThreads) {
        const int rr = idx / ncols;
        const int jj = idx - rr * ncols;
        const float* xr = xs + rr * d2;
        float lv = 0.f;
        for (int k = 0; k < d2; ++k) lv = fmaf(xr[k], ps[k * pcols + jj], lv);
        const int c = c0 + jj;
        const size_t i = tile0 + static_cast<size_t>(rr) * d2 + c;
        const float mv = m[i];
        const float yv = y[i];
        const float mk = msk[c];
        const float sv = repro::shrink(mv - lv + r * yv, t) * mk;
        const float res = (mv - lv - sv) * mk;
        const float yn = (yv + u * res) * mk;
        l_out[i] = lv;
        s_out[i] = sv;
        y_out[i] = yn;
        acc += res * res;
        x2s[rr * d2 + c] = mv - sv + r * yn;
      }
    }
    __syncthreads();  // x2s is complete
    for (int idx = tid; idx < d2 * d2; idx += kThreads) {
      const int i = idx / d2;
      const int j = idx - i * d2;
      float gv = 0.f;
      for (int rr = 0; rr < nrows; ++rr) gv = fmaf(x2s[rr * d2 + i], x2s[rr * d2 + j], gv);
      gp[idx] = first ? gv : gp[idx] + gv;  // each entry has one owner thread
    }
    first = false;
  }
  const float total = repro::block_sum(acc);
  if (tid == 0) r_part[static_cast<size_t>(b) * n_groups + g] = total;
}

// G'[b] = sum over groups of the Gram partials, and rsq[b] likewise, both
// in group order.
__global__ void subspace_apply_finish(const float* __restrict__ r_part,
                                      const float* __restrict__ g_part,
                                      float* __restrict__ rsq,
                                      float* __restrict__ g_out, int d2,
                                      int n_groups) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t dd = static_cast<size_t>(d2) * d2;
  if (idx < static_cast<int>(dd)) {
    const float* src = g_part + static_cast<size_t>(b) * n_groups * dd + idx;
    float total = 0.f;
    for (int gi = 0; gi < n_groups; ++gi) total += src[gi * dd];
    g_out[static_cast<size_t>(b) * dd + idx] = total;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float* rp = r_part + static_cast<size_t>(b) * n_groups;
    float total = 0.f;
    for (int gi = 0; gi < n_groups; ++gi) total += rp[gi];
    rsq[b] = total;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block for this tiling.
long long repro_subspace_apply_smem(int d2, int tile_rows, int pcols) {
  return 4LL * (2LL * tile_rows * d2 + static_cast<long long>(d2) * pcols + d2);
}

// Launches both kernels on `stream`; returns the launch's cudaError_t.
// Scratch: r_part (n_modules, n_groups), g_part (n_modules, n_groups, d2, d2).
int repro_subspace_apply(const float* m, const float* s, const float* y,
                         const float* p, const float* rho, const float* mu,
                         const float* thresh, const float* mask, float* l_out,
                         float* s_out, float* y_out, float* r_part,
                         float* g_part, float* rsq, float* g_out, int n_modules,
                         int vec, int d2, int tile_rows, int pcols,
                         int group_rows, int n_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(repro_subspace_apply_smem(d2, tile_rows, pcols));
  cudaError_t err = cudaFuncSetAttribute(
      subspace_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_groups, n_modules);
  subspace_apply_kernel<<<grid, kThreads, smem, st>>>(
      m, s, y, p, rho, mu, thresh, mask, l_out, s_out, y_out, r_part, g_part,
      vec, d2, tile_rows, pcols, group_rows, n_groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dd = d2 * d2;
  dim3 grid2((dd + kThreads - 1) / kThreads, n_modules);
  subspace_apply_finish<<<grid2, kThreads, 0, st>>>(r_part, g_part, rsq, g_out,
                                                     d2, n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
