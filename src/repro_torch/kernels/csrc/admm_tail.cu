// Fused RPCA ADMM elementwise tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rpca_admm.py::admm_tail.
// Per module b of a (B, vec, nc) float32 bucket:
//
//   S     = shrink(M - L + rho_b * Y, thresh_b) * mask
//   resid = (M - L - S) * mask
//   Y'    = (Y + mu_b * resid) * mask
//   rsq_b = sum(resid^2)
//
// Bound: device-memory bytes.  Five tensors of B*vec*nc*4 bytes move once
// each (M, L, Y read; S, Y' written) against ~10 flops per element, far
// below the card's operations-per-byte balance.  The design therefore reads
// and writes every element exactly once, with neighbouring threads on
// neighbouring addresses: a module is one contiguous run of vec*nc floats,
// cut into tiles of kTile elements, one block per (tile, module).  The ragged
// end of a module is masked in the kernel, so no padded copies are made.
//
// The TPU kernel carried the residual sum across its sequential inner grid
// axis.  Blocks here run in no order, so each block writes its tile's
// partial sum to a (B, n_tiles) scratch and a second kernel adds the tiles
// of each module in tile order.  No float atomics: the same inputs give the
// same bits on every launch.
#include <cuda_runtime.h>

#include "tail_common.cuh"

namespace {

using repro::kThreads;
constexpr int kItems = 16;                  // elements per thread per tile
constexpr int kTile = kThreads * kItems;   // elements per block

__global__ void __launch_bounds__(kThreads)
admm_tail_kernel(const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ y, const float* __restrict__ rho,
                 const float* __restrict__ mu, const float* __restrict__ thresh,
                 const float* __restrict__ mask, float* __restrict__ s_out,
                 float* __restrict__ y_out, float* __restrict__ partial,
                 int per_module, int nc, int n_tiles) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const float r = rho[b];
  const float u = mu[b];
  const float t = thresh[b];
  const size_t base = static_cast<size_t>(b) * per_module;
  const int start = tile * kTile;
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const int e = start + k * kThreads + threadIdx.x;
    if (e < per_module) {
      const size_t i = base + e;
      const float mk = mask[e % nc];
      const float mv = m[i];
      const float lv = l[i];
      const float yv = y[i];
      const float sv = repro::shrink(mv - lv + r * yv, t) * mk;
      const float res = (mv - lv - sv) * mk;
      s_out[i] = sv;
      y_out[i] = (yv + u * res) * mk;
      acc += res * res;
    }
  }
  const float total = repro::block_sum(acc);
  if (threadIdx.x == 0) partial[static_cast<size_t>(b) * n_tiles + tile] = total;
}

// One thread per module adds its tile partials in tile order.
__global__ void admm_tail_finish(const float* __restrict__ partial,
                                 float* __restrict__ rsq, int n_modules,
                                 int n_tiles) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_modules) return;
  const float* p = partial + static_cast<size_t>(b) * n_tiles;
  float total = 0.f;
  for (int j = 0; j < n_tiles; ++j) total += p[j];
  rsq[b] = total;
}

}  // namespace

extern "C" {

// Scratch `partial` holds n_modules * repro_admm_tail_tiles(vec, nc) floats.
int repro_admm_tail_tiles(int vec, int nc) {
  const long long per_module = static_cast<long long>(vec) * nc;
  return static_cast<int>((per_module + kTile - 1) / kTile);
}

// Launches both kernels on `stream`; returns the launch's cudaError_t.
int repro_admm_tail(const float* m, const float* l, const float* y,
                    const float* rho, const float* mu, const float* thresh,
                    const float* mask, float* s_out, float* y_out,
                    float* partial, float* rsq, int n_modules, int vec, int nc,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_module = vec * nc;
  const int n_tiles = repro_admm_tail_tiles(vec, nc);
  dim3 grid(n_tiles, n_modules);
  admm_tail_kernel<<<grid, kThreads, 0, st>>>(m, l, y, rho, mu, thresh, mask,
                                              s_out, y_out, partial,
                                              per_module, nc, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_tail_finish<<<(n_modules + 127) / 128, 128, 0, st>>>(partial, rsq,
                                                            n_modules, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
