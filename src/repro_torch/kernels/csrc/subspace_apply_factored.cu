// Factored subspace-SVT tail of one client shard, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/svt_subspace.py::subspace_apply_factored.  Per module b
// of a (B, vec, d2) float32 shard of the bucket's client columns, with the
// replicated (B, vec, r) shrink factor F = (X Vr) diag(coef) and this
// shard's (B, d2, r) Ritz basis rows Vr:
//
//   L     = F Vr^T                                 (not masked)
//   S'    = shrink(M - L + rho_b * Y, thresh_b) * mask
//   resid = (M - L - S') * mask
//   Y'    = (Y + mu_b * resid) * mask
//   rsq_b = sum(resid^2)                           (this shard's partial)
//
// Bound: device-memory bytes.  M and Y are read and L, S', Y' written once
// each (five tensors of B*vec*d2*4 bytes), F once (B*vec*r*4); L costs 2r
// flops an element, far below the card's operations-per-byte balance at the
// basis widths the sharded loop hands in (r <= 8 by default).  No d2 x d2
// projector exists: each element of L is rebuilt from one row of F and one
// row of Vr.  A block owns one tile of rows of one module: it stages the
// module's Vr (d2 x r), the tile's slab of F (rows x r) and the mask in
// shared memory, then walks the tile's rows x d2 elements, which lie
// contiguously in M, Y and the outputs, neighbouring threads on
// neighbouring addresses.  Each element of L is a plain fp32 FMA chain over
// r in a fixed order: no TF32, no tensor cores.
//
// The TPU kernel carried the residual sum across its sequential inner grid
// axis.  Blocks here run in no order, so each block writes its tile's
// partial to a (B, n_groups) scratch and a second kernel adds the tiles of
// each module in tile order.  No float atomics: the same inputs give the
// same bits on every launch.  The tiling depends on vec, d2 and r only, not
// on B, so a module's results do not depend on which other modules share
// the launch (the B-chunked schedule of mesh_overlap gives the same bits).
#include <cuda_runtime.h>

#include "smem_opt_in.cuh"
#include "tail_common.cuh"

namespace {

using repro::kThreads;

__global__ void __launch_bounds__(kThreads)
factored_kernel(const float* __restrict__ m, const float* __restrict__ y,
                const float* __restrict__ f, const float* __restrict__ vr,
                const float* __restrict__ rho, const float* __restrict__ mu,
                const float* __restrict__ thresh,
                const float* __restrict__ mask, float* __restrict__ l_out,
                float* __restrict__ s_out, float* __restrict__ y_out,
                float* __restrict__ r_part, int vec, int d2, int r,
                int tile_rows, int n_groups) {
  extern __shared__ float smem[];
  float* vs = smem;                  // (d2, r)         this module's Vr
  float* fs = vs + d2 * r;           // (tile_rows, r)  the tile's rows of F
  float* msk = fs + tile_rows * r;   // (d2,)           client mask

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float rh = rho[b];
  const float u = mu[b];
  const float t = thresh[b];
  const int row0 = g * tile_rows;
  const int nrows = min(tile_rows, vec - row0);

  const float* vb = vr + static_cast<size_t>(b) * d2 * r;
  for (int i = tid; i < d2 * r; i += kThreads) vs[i] = vb[i];
  const float* fb = f + (static_cast<size_t>(b) * vec + row0) * r;
  for (int i = tid; i < nrows * r; i += kThreads) fs[i] = fb[i];
  for (int j = tid; j < d2; j += kThreads) msk[j] = mask[j];
  __syncthreads();

  const size_t base = (static_cast<size_t>(b) * vec + row0) * d2;
  const int n = nrows * d2;
  float acc = 0.f;
  for (int e = tid; e < n; e += kThreads) {
    const int rr = e / d2;
    const int c = e - rr * d2;
    const float* fr = fs + rr * r;
    const float* vc = vs + c * r;
    float lv = 0.f;
    for (int k = 0; k < r; ++k) lv = fmaf(fr[k], vc[k], lv);
    const size_t i = base + e;
    const float mv = m[i];
    const float yv = y[i];
    const float mk = msk[c];
    const float sv = repro::shrink(mv - lv + rh * yv, t) * mk;
    const float res = (mv - lv - sv) * mk;
    l_out[i] = lv;
    s_out[i] = sv;
    y_out[i] = (yv + u * res) * mk;
    acc += res * res;
  }
  const float total = repro::block_sum(acc);
  if (tid == 0) r_part[static_cast<size_t>(b) * n_groups + g] = total;
}

// One thread per module adds its tile partials in tile order.
__global__ void factored_finish(const float* __restrict__ r_part,
                                float* __restrict__ rsq, int n_modules,
                                int n_groups) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_modules) return;
  const float* p = r_part + static_cast<size_t>(b) * n_groups;
  float total = 0.f;
  for (int j = 0; j < n_groups; ++j) total += p[j];
  rsq[b] = total;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block for this tiling.
long long repro_subspace_apply_factored_smem(int d2, int r, int tile_rows) {
  return 4LL * (static_cast<long long>(d2) * r + static_cast<long long>(tile_rows) * r + d2);
}

// Launches both kernels on `stream`; returns the launch's cudaError_t.
// Scratch: r_part (n_modules, n_groups), n_groups = ceil(vec / tile_rows).
int repro_subspace_apply_factored(const float* m, const float* y, const float* f,
                                  const float* vr, const float* rho, const float* mu,
                                  const float* thresh, const float* mask, float* l_out,
                                  float* s_out, float* y_out, float* r_part, float* rsq,
                                  int n_modules, int vec, int d2, int r, int tile_rows,
                                  int n_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(repro_subspace_apply_factored_smem(d2, r, tile_rows));
  static repro::SmemOptIn opt_in;
  cudaError_t err = opt_in.need(factored_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_groups, n_modules);
  factored_kernel<<<grid, kThreads, smem, st>>>(m, y, f, vr, rho, mu, thresh, mask, l_out,
                                                s_out, y_out, r_part, vec, d2, r,
                                                tile_rows, n_groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  factored_finish<<<(n_modules + 127) / 128, 128, 0, st>>>(r_part, rsq, n_modules,
                                                           n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
