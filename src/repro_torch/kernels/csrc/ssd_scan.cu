// Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan.
// Per (batch*head) row of x (BH, S, P), log-decays da (BH, S) and the
// single-group B, C (G, S, N) (row bh reads group bh / (BH / G)):
//
//   h_t = exp(da_t) h_{t-1} + B_t^T x_t        (h is N x P, h_0 = 0)
//   y_t = C_t h_t
//
// evaluated in chunks of T positions, as the TPU kernel does with its chunk:
//
//   y_i  = sum_{j<=i, j in tile} exp(cum_i - cum_j) (C_i . B_j) x_j   (intra)
//        + exp(cum_i) C_i h                                        (inter)
//   h   <- exp(cum_last) h + sum_j exp(cum_last - cum_j) B_j^T x_j     (carry)
//
// with cum the inclusive sum of da inside the tile.  In exact arithmetic the
// result does not depend on the tile length, so the kernel's tile T = 64 is
// smaller than the model's chunk of 256: only the rounding differs.  The
// final h (BH, N, P) is written when asked (prefill hands it to decode).
// Every product and sum is fp32.
//
// Bound: at prefill, (BH, S, P, N) = (192, 512, 64, 128), the algorithm does
// 2 * (T(T+1)/2 * (N + P) + 2 T N P) operations per tile of every row, the
// upper triangle skipped: 4.45 GFLOP, 0.066 ms on the CUDA cores at
// 67 TFLOP/s, against 61 MB of operands (x and y 25 MB each, the final
// state 6 MB; B and C read once per batch row), 0.018 ms at 3.35 TB/s.
// Operations bind.
//
// Design.  The TPU kernel runs one grid row per (b*h) and carries h in VMEM
// from chunk to chunk.  Here the recurrence for column p of h and y reads
// column p of x only, so a block takes one row bh and PT = 32 columns of P:
// a grid of (P / PT, BH) blocks, 384 at prefill, with no traffic between
// blocks.  Each block walks its tiles in order with h in registers (16
// values a thread) and mirrored in shared memory for the inter-chunk
// product; C.B^T is shared by the column tiles and each block recomputes it.
// One tile of B and C in shared memory, transposed to [n][j] with rows
// padded to T + 4 floats, takes 2 x 34 KB; with x, the score tile and h a
// block uses 109 KB, two blocks an SM.  The decay of the upper triangle
// (i < j) is exp of a positive number and would overflow: those entries are
// selected to 0, never multiplied by a mask.  Positions past S take da = 0
// and B = C = x = 0, as the TPU kernel pads them, and are not stored.  Each
// output is written by one thread, sums run in a fixed order and there are
// no atomics: two launches give the same bits.  Scalar fp32 FMA; tensor
// cores are later work.
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;          // positions per tile
constexpr int NMAX = 128;      // largest state width N
constexpr int PT = 32;         // columns of P per block
constexpr int kThreads = 256;
constexpr int LD = T + 4;      // row stride of the transposed B, C tiles
constexpr int LDL = T + 1;     // row stride of the score tile

struct Smem {
  float bt[NMAX][LD];  // bt[n][j] = B[t0 + j][n]
  float ct[NMAX][LD];  // ct[n][i] = C[t0 + i][n]
  float x[T][PT];      // this block's columns of x
  float l[T][LDL];     // exp(cum_i - cum_j) * C_i . B_j for j <= i, else 0
  float h[NMAX][PT];   // state entering the tile
  float cum[T];        // inclusive sum of da within the tile
  float w[T];          // exp(cum_last - cum_j)
};

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ da,
                const float* __restrict__ b, const float* __restrict__ c,
                float* __restrict__ y, float* __restrict__ h_out, int S, int P, int N,
                int heads_per_group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int p_base = blockIdx.x * PT;
  const float* xr = x + static_cast<size_t>(bh) * S * P;
  const float* dar = da + static_cast<size_t>(bh) * S;
  const size_t grp = static_cast<size_t>(bh / heads_per_group);
  const float* br = b + grp * S * N;
  const float* cr = c + grp * S * N;
  float* yr = y + static_cast<size_t>(bh) * S * P;

  // State ownership: rows sn + 32 r (r < 4), columns sq0 .. sq0 + 3.
  const int sq0 = 4 * (tid % 8);
  const int sn = tid / 8;
  float hreg[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) hreg[r][q] = 0.f;
  for (int e = tid; e < NMAX * PT; e += kThreads) (&sm.h[0][0])[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int len = min(T, S - t0);
    // Load the tile: B and C transposed, x's columns, and the cumulative
    // decay (warp 0: two positions a lane, a fixed shuffle scan).
    for (int e = tid; e < T * NMAX; e += kThreads) {
      const int j = e / NMAX, n = e % NMAX;
      const bool ok = j < len && n < N;
      const size_t off = static_cast<size_t>(t0 + j) * N + n;
      sm.bt[n][j] = ok ? br[off] : 0.f;
      sm.ct[n][j] = ok ? cr[off] : 0.f;
    }
    for (int e = tid; e < T * PT; e += kThreads) {
      const int j = e / PT, q = e % PT;
      const int p = p_base + q;
      sm.x[j][q] = (j < len && p < P) ? xr[static_cast<size_t>(t0 + j) * P + p] : 0.f;
    }
    if (tid < 32) {
      const int j0 = 2 * tid;
      const float d0 = j0 < len ? dar[t0 + j0] : 0.f;
      const float d1 = j0 + 1 < len ? dar[t0 + j0 + 1] : 0.f;
      float s = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += v;
      }
      float prev = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) prev = 0.f;
      sm.cum[j0] = prev + d0;
      sm.cum[j0 + 1] = prev + d0 + d1;
    }
    __syncthreads();

    const float cum_last = sm.cum[T - 1];  // positions past S add 0
    if (tid < T) sm.w[tid] = expf(cum_last - sm.cum[tid]);

    // Scores: a 4 x 4 block of (i, j) a thread, blocks above the diagonal
    // skipped; inside a diagonal block j > i is selected to 0.
    {
      const int i0 = 4 * (tid % 16), j0 = 4 * (tid / 16);
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
      if (j0 <= i0) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(&sm.ct[n][i0]);
          const float4 bv = *reinterpret_cast<const float4*>(&sm.bt[n][j0]);
          const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(cs[a], bs[q], acc[a][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + a, j = j0 + q;
          sm.l[i][j] = j <= i ? expf(sm.cum[i] - sm.cum[j]) * acc[a][q] : 0.f;
        }
    }
    __syncthreads();

    // Outputs: rows yi + 32 a (a < 2), columns sq0 .. sq0 + 3.
    {
      const int yi = tid / 8;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = yi + 32 * a;
        float intra[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j <= i; ++j) {
          const float lv = sm.l[i][j];
          const float4 xv = *reinterpret_cast<const float4*>(&sm.x[j][sq0]);
          intra[0] = fmaf(lv, xv.x, intra[0]);
          intra[1] = fmaf(lv, xv.y, intra[1]);
          intra[2] = fmaf(lv, xv.z, intra[2]);
          intra[3] = fmaf(lv, xv.w, intra[3]);
        }
        float inter[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float cv = sm.ct[n][i];
          const float4 hv = *reinterpret_cast<const float4*>(&sm.h[n][sq0]);
          inter[0] = fmaf(cv, hv.x, inter[0]);
          inter[1] = fmaf(cv, hv.y, inter[1]);
          inter[2] = fmaf(cv, hv.z, inter[2]);
          inter[3] = fmaf(cv, hv.w, inter[3]);
        }
        if (i < len) {
          const float decay = expf(sm.cum[i]);
          float* out = yr + static_cast<size_t>(t0 + i) * P + p_base + sq0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (p_base + sq0 + q < P) out[q] = intra[q] + decay * inter[q];
        }
      }
    }

    // Carry: h <- exp(cum_last) h + sum_j w_j B_j^T x_j, in registers.
    {
      const float chunk_decay = expf(cum_last);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) hreg[r][q] *= chunk_decay;
      for (int j = 0; j < len; ++j) {
        const float wj = sm.w[j];
        const float4 xv = *reinterpret_cast<const float4*>(&sm.x[j][sq0]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bw = sm.bt[sn + 32 * r][j] * wj;
          hreg[r][0] = fmaf(bw, xv.x, hreg[r][0]);
          hreg[r][1] = fmaf(bw, xv.y, hreg[r][1]);
          hreg[r][2] = fmaf(bw, xv.z, hreg[r][2]);
          hreg[r][3] = fmaf(bw, xv.w, hreg[r][3]);
        }
      }
    }
    __syncthreads();  // every read of this tile's shared memory is done
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sm.h[sn + 32 * r][sq0 + q] = hreg[r][q];
  }

  if (h_out != nullptr) {
    float* hr = h_out + static_cast<size_t>(bh) * N * P;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = sn + 32 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p_base + sq0 + q;
        if (n < N && p < P) hr[static_cast<size_t>(n) * P + p] = hreg[r][q];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the launch's cudaError_t.  x, y
// (BH, S, P), da (BH, S), b, c (BH / heads_per_group, S, N), h_out
// (BH, N, P) or null; all contiguous float32.
int repro_ssd_scan(const void* x, const void* da, const void* b, const void* c, void* y,
                   void* h_out, int BH, int S, int P, int N, int heads_per_group,
                   void* stream) {
  if (BH < 1 || BH > 65535 || S < 0 || P < 1 || N < 1 || N > NMAX || heads_per_group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P + PT - 1) / PT, BH);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(da),
      static_cast<const float*>(b), static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(h_out), S, P, N, heads_per_group);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
