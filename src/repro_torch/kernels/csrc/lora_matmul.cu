// Fused base + LoRA projection for Hopper (sm_90a), single adapter and
// per-row gathered adapters:
//
//   y[m] = x[m] @ W + scale * round_T(x[m] @ A[s_m]) @ B[s_m]
//
// Replaces the Pallas TPU kernels src/repro/kernels/lora_matmul.py::
// lora_matmul and ::gathered_lora_matmul.  x (M, K) and W (K, N) are of the
// activation type T (float or bf16); the adapter pools A (n_slots, K, R) and
// B (n_slots, R, N) are of their own type P (float or bf16) and are rounded
// to T as they are loaded, as layers.dense casts them, so an fp32 pool serves
// bf16 activations with no per-call cast.  s_m is the row's slot; a null
// slot array means slot 0 for every row (the single-adapter kernel), and
// slot -1 gives the base projection only.  Both products accumulate in
// fp32; x @ A is rounded to T before the second product and the sum is
// rounded once, as the Pallas kernel does.
//
// Bound: at prefill (M = 4096, K = N = 2048) the base product is 34 GFLOP
// against 25 MB of bf16 operands, far above the card's operations-per-byte
// balance, so operations bind; at decode (M = 8) the 8 MB of W bind.  The
// rank-R correction adds 2*M*R*(K + N) operations, under 1% at R = 8.
//
// Design.  The TPU kernel padded R to 128 lanes and sorted rows into
// single-adapter 128-row tiles (segment_layout), so a decode batch of 8
// requests filled whole tiles.  Here no row is moved and R is not padded to
// a lane width:
//   1. lora_xa: one warp per row reads its own slot, takes x[m] @ A[s_m]
//      over K (lanes stride K, a fixed shuffle tree adds them: deterministic)
//      and writes the R values, rounded to T, to an (M, RP) fp32 scratch,
//      RP = 8 or 64 the register width at or above R.
//   2. lora_gemm: a 128 x 128 output tile per block of 256 threads, each
//      thread an 8 x 8 register tile, K in steps of 8 staged in shared memory
//      as fp32 (scalar FMA, no tensor cores yet).  The epilogue reads each
//      row's slot and R scratch values and adds scale * xa @ B[s_m] to the
//      fp32 accumulator before the single rounding.
//   3. When the output tiles cannot give the 132 SMs two blocks each (decode:
//      M = 8 is 16 tiles), K is split across blocks; each writes its fp32
//      partial sums and lora_finish adds the splits in split order (no
//      atomics, so a launch repeats bit for bit) before the same epilogue.
// A pool is addressed through its slot stride, so a layer's slice of a
// (n_slots, n_layers, K, R) pool is used where it lies, never copied.
// Ragged M, N and K are masked in the kernels.  Slots outside [-1, n_slots)
// trap rather than read another adapter's memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;  // shared rows of BM + 4 floats: no bank conflicts, 16-byte aligned

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A value of the pool's type, rounded to the activation type T, as fp32.
template <typename T, typename P>
__device__ __forceinline__ float round_to(P v) { return to_f(from_f<T>(to_f(v))); }

__device__ __forceinline__ int row_slot_of(const int* row_slot, int m, int n_slots) {
  const int s = row_slot ? row_slot[m] : 0;
  if (s < -1 || s >= n_slots) __trap();
  return s;
}

template <typename T, typename P, int RP>
__global__ void __launch_bounds__(kThreads)
lora_xa(const T* __restrict__ x, const P* __restrict__ a, const int* __restrict__ row_slot,
        float* __restrict__ xa, int M, int K, int R, long long a_slot_stride, int n_slots) {
  const int m = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (m >= M) return;
  const int slot = row_slot_of(row_slot, m, n_slots);
  float acc[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc[r] = 0.f;
  if (slot >= 0) {
    const P* as = a + slot * a_slot_stride;
    const T* xr = x + static_cast<size_t>(m) * K;
    for (int k = lane; k < K; k += 32) {
      const float xv = to_f(xr[k]);
      const P* ak = as + static_cast<size_t>(k) * R;
#pragma unroll
      for (int r = 0; r < RP; ++r)
        if (r < R) acc[r] = fmaf(xv, round_to<T>(ak[r]), acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RP; ++r)
      if (r < R) xa[static_cast<size_t>(m) * RP + r] = to_f(from_f<T>(acc[r]));
  }
}

// One output: the fp32 base sum plus scale * xa @ B[slot][:, col], rounded
// once.  Shared by the one-pass and split-K epilogues.
template <typename T, typename P>
__device__ __forceinline__ T finish(float acc, const float* __restrict__ xa_row,
                                    const P* __restrict__ b, int slot, long long b_slot_stride,
                                    int R, int N, int col, float scale) {
  float lora = 0.f;
  if (slot >= 0) {
    const P* bs = b + slot * b_slot_stride + col;
#pragma unroll 8
    for (int r = 0; r < R; ++r)
      lora = fmaf(xa_row[r], round_to<T>(bs[static_cast<size_t>(r) * N]), lora);
  }
  return from_f<T>(acc + scale * lora);
}

// The base product over K range [kz * k_chunk, +k_chunk) of one 128 x 128
// tile.  With `partial` null (one split) the epilogue runs here; otherwise
// the fp32 sums go to partial[kz] and lora_finish adds the splits in order.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
lora_gemm(const T* __restrict__ x, const T* __restrict__ w, const P* __restrict__ b,
          const int* __restrict__ row_slot, const float* __restrict__ xa, T* __restrict__ y,
          float* __restrict__ partial, int M, int N, int K, int R, int xa_stride,
          long long b_slot_stride, int n_slots, int k_chunk, float scale) {
  __shared__ __align__(16) float xs[BK][BM + kPad];
  __shared__ __align__(16) float ws[BK][BN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;  // rows    ty*4 .. +3 and 64 + ty*4 .. +3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / BK, kk = e % BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gm < M && gk < k_end) ? to_f(x[static_cast<size_t>(gm) * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gn = n0 + c;
      ws[kk][c] = (gk < k_end && gn < N) ? to_f(w[static_cast<size_t>(gk) * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
    const int slot = partial ? 0 : row_slot_of(row_slot, row, n_slots);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= N) continue;
      const size_t o = static_cast<size_t>(row) * N + col;
      if (partial)
        partial[static_cast<size_t>(blockIdx.z) * M * N + o] = acc[i][j];
      else
        y[o] = finish<T, P>(acc[i][j], xa + static_cast<size_t>(row) * xa_stride, b, slot,
                            b_slot_stride, R, N, col, scale);
    }
  }
}

// Split-K epilogue: one thread per output adds the splits in order.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
lora_finish(const float* __restrict__ partial, const P* __restrict__ b,
            const int* __restrict__ row_slot, const float* __restrict__ xa, T* __restrict__ y,
            int M, int N, int R, int xa_stride, long long b_slot_stride, int n_slots, int splits,
            float scale) {
  const size_t o = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= static_cast<size_t>(M) * N) return;
  const int row = static_cast<int>(o / N), col = static_cast<int>(o % N);
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += partial[static_cast<size_t>(z) * M * N + o];
  y[o] = finish<T, P>(acc, xa + static_cast<size_t>(row) * xa_stride, b,
                      row_slot_of(row_slot, row, n_slots), b_slot_stride, R, N, col, scale);
}

// Splits of K: one unless the output tiles leave the card's 132 SMs short of
// two blocks each, and never fewer than 16 K steps per split.
int k_splits(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int target = 2 * 132;
  if (tiles >= target) return 1;
  const int by_steps = max(1, ((K + BK - 1) / BK) / 16);
  return max(1, min((target + tiles - 1) / tiles, by_steps));
}

int rank_width(int R) { return R <= 8 ? 8 : (R <= 64 ? 64 : -1); }

template <typename T, typename P>
int launch(const void* x, const void* w, const void* a, const void* b, const int* row_slot,
           float* xa, float* partial, void* y, int M, int N, int K, int R, long long a_stride,
           long long b_stride, int n_slots, float scale, cudaStream_t st) {
  const int rows_per_block = kThreads / 32;
  const int xa_grid = (M + rows_per_block - 1) / rows_per_block;
  if (R <= 8)
    lora_xa<T, P, 8><<<xa_grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                                    static_cast<const P*>(a), row_slot, xa, M,
                                                    K, R, a_stride, n_slots);
  else
    lora_xa<T, P, 64><<<xa_grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                                     static_cast<const P*>(a), row_slot, xa, M,
                                                     K, R, a_stride, n_slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = k_splits(M, N, K);
  const int k_steps = (K + BK - 1) / BK;
  const int k_chunk = ((k_steps + splits - 1) / splits) * BK;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  lora_gemm<T, P><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const P*>(b), row_slot,
      xa, static_cast<T*>(y), splits > 1 ? partial : nullptr, M, N, K, R, rank_width(R),
      b_stride, n_slots, k_chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long outs = static_cast<long long>(M) * N;
  lora_finish<T, P><<<static_cast<unsigned>((outs + kThreads - 1) / kThreads), kThreads, 0,
                      st>>>(partial, static_cast<const P*>(b), row_slot, xa,
                            static_cast<T*>(y), M, N, R, rank_width(R), b_stride, n_slots,
                            splits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Width of the x @ A scratch for rank R (it holds M * width floats), and
// the number of K splits for an (M, N, K) product (the split-K scratch
// holds splits * M * N floats when splits > 1).
int repro_lora_rank_width(int R) { return rank_width(R); }
int repro_lora_splits(int M, int N, int K) { return k_splits(M, N, K); }

// y = x @ w + scale * round(x @ a[s]) @ b[s] per row; row_slot may be null
// (slot 0 for every row).  Strides are the pools' slot strides in elements.
// Returns the launch's cudaError_t.
int repro_lora_matmul(const void* x, const void* w, const void* a, const void* b,
                      const int* row_slot, float* xa, float* partial, void* y, int M, int N,
                      int K, int R, int n_slots, long long a_slot_stride,
                      long long b_slot_stride, float scale, int x_bf16, int pool_bf16,
                      void* stream) {
  if (R < 1 || R > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && pool_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, a, b, row_slot, xa, partial, y, M, N, K,
                                                R, a_slot_stride, b_slot_stride, n_slots,
                                                scale, st);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R,
                                        a_slot_stride, b_slot_stride, n_slots, scale, st);
  if (pool_bf16)
    return launch<float, __nv_bfloat16>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R,
                                        a_slot_stride, b_slot_stride, n_slots, scale, st);
  return launch<float, float>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R, a_slot_stride,
                              b_slot_stride, n_slots, scale, st);
}

}  // extern "C"
