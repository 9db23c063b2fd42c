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
// balance, so operations bind (0.035 ms at the bf16 tensor-core rate); at
// decode (M = 8) the 8 MB of W bind (0.0026 ms).  The rank-R correction
// adds 2*M*R*(K + N) operations, under 1% at R = 8.
//
// Design.  The TPU kernel padded R to 128 lanes and sorted rows into
// single-adapter 128-row tiles (segment_layout), so a decode batch of 8
// requests filled whole tiles.  Here no row is moved and R is not padded to
// a lane width.  Three kernels:
//   1. lora_xa: a block of 256 threads takes x[m] @ A[s_m] for 8 rows at
//      prefill and 1 at decode, each row reading its own slot.  A lane owns
//      a rank column and a run of 8 consecutive k, so A is read in whole
//      32-byte sectors; a step loads every row's x before using any (the
//      loads overlap instead of waiting one by one) and A once per slot.
//      Sums go lane by lane over k, through a fixed shuffle tree and then
//      over the 8 warps in order through shared memory (deterministic; at
//      decode the K loop is spread over a whole block).  The R values,
//      rounded to T, go to an (M, RP) fp32 scratch, RP = 8 or 64.
//   2. The base product, by one of two routes, which the wrapper chooses
//      from the dtype and the alignment alone (``lora_matmul.route``):
//      * tensor route (bf16 x and W, K and N multiples of 8 so that every
//        TMA row stride is a multiple of 16 bytes, 16-byte aligned bases):
//        lora_gemm_tc.  A 128 x 128 output tile per block (64 x 128 when
//        M <= 64, the decode tile, rows past M zero-filled by TMA).  One
//        producer warp keeps a ring of 3 shared-memory stages full by TMA
//        (cp.async.bulk.tensor, 128-byte swizzle, completion on an
//        mbarrier per stage): x as (BM, 64) K-major tiles, W as two (64,
//        64) tiles of its row-major (K, N) layout, read N-major through
//        the descriptor's transpose bit (W is never copied).  One or two
//        consumer warpgroups each issue wgmma.mma_async m64n128k16 bf16 ->
//        fp32 on their 64 rows, keep one group of products in flight and
//        hand a stage back through its "empty" mbarrier.  Two blocks share
//        an SM, so one block's epilogue runs under the other's products.
//        Bound by the tensor cores at prefill, by W's bytes at decode.
//      * scalar route (float32, or bf16 with K or N not a multiple of 8):
//        lora_gemm, a 128 x 128 tile per block of 256 threads, each thread
//        an 8 x 8 register tile, K in steps of 8 staged in shared memory as
//        fp32 (scalar FMA).  float32 stays here because TF32 tensor cores
//        would not hold the float32 serving check against the CPU.
//      Both epilogues read each output's row and column (on the tensor
//      route from the wgmma fragment layout), the row's slot and R scratch
//      values, add scale * xa @ B[s_m][:, col] to the fp32 accumulator in r
//      order and round once.  On the tensor route each warpgroup first
//      stages B[s][:, tile columns], rounded to bf16, in shared memory for
//      the slot s of its first row (rows come grouped by request); a row of
//      another slot, or a rank above 8, reads B from global memory, with
//      the same values.  At the serving prefill shapes the staging takes
//      15-18% off the GEMM against every row reading global memory (H100,
//      tools/kernel_call_costs.py).
//   3. When the output tiles cannot give the 132 SMs two blocks each (decode:
//      M = 8 is 16 tiles), K is split across blocks (k_splits, the same rule
//      for both routes; on the tensor route each split is a whole number of
//      64-wide K steps); each writes its fp32 partial sums, and lora_finish
//      (one for both routes) adds the splits in split order (no atomics)
//      before the same epilogue.  Every sum has one order, so a launch
//      repeats bit for bit.
// A pool is addressed through its slot stride, so a layer's slice of a
// (n_slots, n_layers, K, R) pool is used where it lies, never copied.
// Ragged M, N and K are masked in the kernels (by TMA's zero fill on the
// tensor route).  Slots outside [-1, n_slots) trap rather than read another
// adapter's memory.  The TMA tensor maps are encoded on the host for every
// call through cuTensorMapEncodeTiled, taken with cudaGetDriverEntryPoint,
// so the library links no libcuda; the GEMM's shared-memory opt-in is set
// once per device (smem_opt_in.cuh, as for every kernel here).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "smem_opt_in.cuh"
#include "wgmma_tma.cuh"

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

// The single rounding of an output: the fp32 base sum plus the correction.
template <typename T>
__device__ __forceinline__ T combine(float acc, float lora, float scale) {
  return from_f<T>(acc + scale * lora);
}

__device__ __forceinline__ int row_slot_of(const int* row_slot, int m, int n_slots) {
  const int s = row_slot ? row_slot[m] : 0;
  if (s < -1 || s >= n_slots) __trap();
  return s;
}

// Eight consecutive x values of one row, kept in x's own type until used
// (a bf16 run is one 16-byte register quad).
template <typename T> struct X8;
template <> struct __align__(16) X8<float> {
  float v[8];
  __device__ __forceinline__ float at(int t) const { return v[t]; }
};
template <> struct __align__(16) X8<__nv_bfloat16> {
  __nv_bfloat162 h[4];
  __device__ __forceinline__ float at(int t) const {
    return t % 2 ? __high2float(h[t / 2]) : __low2float(h[t / 2]);
  }
};

// x[k0 .. k0 + 8) of row xr: one vector load when `vec` (K a multiple of 8,
// x aligned), else element by element with the ragged end zeroed.
__device__ __forceinline__ X8<float> load_x8(const float* xr, int k0, int K, bool vec) {
  X8<float> x;
  if (vec) {
    x = *reinterpret_cast<const X8<float>*>(xr + k0);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) x.v[t] = k0 + t < K ? xr[k0 + t] : 0.f;
  }
  return x;
}
__device__ __forceinline__ X8<__nv_bfloat16> load_x8(const __nv_bfloat16* xr, int k0, int K,
                                                     bool vec) {
  X8<__nv_bfloat16> x;
  if (vec) {
    x = *reinterpret_cast<const X8<__nv_bfloat16>*>(xr + k0);
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      x.h[t] = __halves2bfloat162(k0 + 2 * t < K ? xr[k0 + 2 * t] : zero,
                                  k0 + 2 * t + 1 < K ? xr[k0 + 2 * t + 1] : zero);
  }
  return x;
}

constexpr int kXaRows = 8;  // most rows a lora_xa block takes

// x @ A[s] of `rows` rows from m0 = blockIdx.x * rows (1 at decode, 8 at
// prefill).  Lane l of a warp owns rank column r = l % RP (and r + 32 when
// RP = 64) and a run of 8 consecutive k, so A is read in whole sectors; the
// block's 8 warps take the runs in turn along K.  Each step loads the rows'
// x first (independent loads in flight together), then A once and again
// only where a row's slot differs from the row before it.  Sums: each lane
// over its k in order, a fixed shuffle tree over the lanes of a rank
// column, then the 8 warp partials in warp order through shared memory.
template <typename T, typename P, int RP>
__global__ void __launch_bounds__(kThreads, 3)
lora_xa(const T* __restrict__ x, const P* __restrict__ a, const int* __restrict__ row_slot,
        float* __restrict__ xa, int M, int K, int R, long long a_slot_stride, int n_slots,
        int rows, int vec) {
  constexpr int kLanes = RP < 32 ? RP : 32;  // lanes that share a run of k
  constexpr int kGroups = 32 / kLanes;       // runs of k in a warp
  constexpr int NR = RP / kLanes;            // rank columns a lane owns
  constexpr int kWarps = kThreads / 32;
  constexpr int kStep = kWarps * kGroups * 8;  // k a block covers per step
  __shared__ float part[kWarps][kXaRows][RP];
  const int m0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = lane % kLanes;
  int slot[kXaRows];
  float acc[kXaRows][NR];
#pragma unroll
  for (int i = 0; i < kXaRows; ++i) {
    slot[i] = (i < rows && m0 + i < M) ? row_slot_of(row_slot, m0 + i, n_slots) : -1;
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = (warp * kGroups + lane / kLanes) * 8; k0 < K; k0 += kStep) {
    X8<T> xv[kXaRows];
#pragma unroll
    for (int i = 0; i < kXaRows; ++i)
      if (slot[i] >= 0) xv[i] = load_x8(x + static_cast<size_t>(m0 + i) * K, k0, K, vec != 0);
    float av[8][NR];
#pragma unroll
    for (int i = 0; i < kXaRows; ++i) {
      if (slot[i] < 0) continue;
      if (i == 0 || slot[i] != slot[i - 1]) {
        const P* as = a + slot[i] * a_slot_stride;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int j = 0; j < NR; ++j) {
            const int r = r0 + 32 * j;
            av[t][j] = (k0 + t < K && r < R)
                           ? round_to<T>(as[static_cast<size_t>(k0 + t) * R + r])
                           : 0.f;
          }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(xv[i].at(t), av[t][j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kXaRows; ++i) {
    if (i >= rows) break;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      float v = acc[i][j];
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < kLanes) part[warp][i][r0 + 32 * j] = v;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * RP; e += kThreads) {
    const int i = e / RP, r = e % RP, m = m0 + i;
    if (m >= M || r >= R) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][i][r];
    xa[static_cast<size_t>(m) * RP + r] = to_f(from_f<T>(s));
  }
}

// One output: the fp32 base sum plus scale * xa @ B[slot][:, col], rounded
// once.  Shared by the scalar route's one-pass and split-K epilogues.
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
  return combine<T>(acc, lora, scale);
}

// Scalar route: the base product over K range [kz * k_chunk, +k_chunk) of
// one 128 x 128 tile.  With `partial` null (one split) the epilogue runs
// here; otherwise the fp32 sums go to partial[kz] and lora_finish adds the
// splits in order.
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

// --- Tensor route: TMA ring + wgmma -------------------------------------------
namespace tc {

using namespace repro;
using bf16 = __nv_bfloat16;
constexpr int BK = 64;       // K per stage: one 128-byte swizzle row of bf16
constexpr int kChunk = 64;   // W columns per TMA box (128 bytes, the swizzle width)

constexpr int BN = 128;      // output columns per block
constexpr int kStages = 3;   // two blocks share an SM

template <int CWG>  // consumer warpgroups: 64 output rows each
struct Cfg {
  static constexpr int BM = 64 * CWG;
  static constexpr int kThreads = 128 * CWG + 32;  // then one producer warp
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBBytes = BK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // The epilogue's B rows (rank <= 8) per consumer warpgroup, fp32.
  static constexpr int kEpiBytes = CWG * 8 * BN * 4;
  // Stages, a full and an empty barrier per stage, the epilogue's B rows,
  // and slack to align the stages to the 1024-byte swizzle atom.
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + kEpiBytes + 1024;
};

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The base product of one (BM, 128) output tile over K range
// [kz * k_chunk, +k_chunk), k_chunk a multiple of 64, then the epilogue (one
// split) or the fp32 partial sums (split K, finished by lora_finish).
template <typename P, int CWG>
__global__ void __launch_bounds__(Cfg<CWG>::kThreads, 2)
lora_gemm_tc(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
             const P* __restrict__ b, const int* __restrict__ row_slot,
             const float* __restrict__ xa, bf16* __restrict__ y, float* __restrict__ partial,
             int M, int N, int K, int R, int xa_stride, long long b_slot_stride, int n_slots,
             int k_chunk, float scale) {
  using C = Cfg<CWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = smem + kStages * C::kStageBytes;  // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int n_iter = max(0, (min(K, k_begin + k_chunk) - k_begin + BK - 1) / BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * CWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * CWG) {  // producer warp: one lane issues every load
    if (threadIdx.x == 128 * CWG) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
        const uint32_t a_s = smem + s * C::kStageBytes, b_s = a_s + C::kABytes;
        const uint32_t bar = full0 + 8 * s;
        const int k = k_begin + it * BK;
        mbar_expect_tx(bar, C::kStageBytes);
        tma_load_2d(a_s, &tm_x, k, m0, bar);
#pragma unroll
        for (int c = 0; c < BN / kChunk; ++c)
          tma_load_2d(b_s + c * BK * kChunk * 2, &tm_w, n0 + c * kChunk, k, bar);
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows [m0 + 64 wg, +64) of the tile.
  const int wg = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    __syncwarp();  // the warpgroup's .aligned instructions need converged warps
    // A: 64 rows of 128 bytes, 8-row swizzle atoms 1024 bytes apart; a 16-wide
    // K step is 32 bytes along the row.  B: (64 K rows, 64 columns) boxes of
    // 128-byte rows, the second 64 columns 8192 bytes on (leading offset),
    // 8 K rows 1024 bytes apart (stride offset); a K step is 16 rows.
    const uint32_t a_s = smem + s * C::kStageBytes + wg * 64 * BK * 2;
    const uint32_t b_s = smem + s * C::kStageBytes + C::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<1>(acc, smem_desc(a_s + kk * 32, 16, 1024),
                  smem_desc(b_s + kk * 16 * kChunk * 2, BK * kChunk * 2, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: hand it back
    if (it > 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Fragment layout of m64n128: acc[4j + 2h + e] is row 16 warp + 8 h + lane/4
  // and column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 block.
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int c0 = n0 + 2 * (lane & 3);
  // The warpgroup stages B[s0][:, n0:n0+128], rounded to bf16, where s0 is
  // the slot of its first row (rows are grouped by request, so nearly every
  // row shares it); rows of another slot, and ranks above 8, read B from
  // global memory.  The values are the same either way.
  float* bsm = reinterpret_cast<float*>(smem_raw + (empty0 + 8 * kStages - smem_u32(smem_raw))) +
               wg * 8 * BN;
  int s0 = -1;
  if (!partial && R <= 8) {
    if (m0 + wg * 64 < M) s0 = row_slot_of(row_slot, m0 + wg * 64, n_slots);
    if (s0 >= 0)
      for (int e = threadIdx.x & 127; e < R * BN; e += 128) {
        const int r = e / BN, col = n0 + e % BN;
        bsm[e] = col < N ? round_to<bf16>(b[s0 * b_slot_stride + static_cast<size_t>(r) * N + col])
                         : 0.f;
      }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + warp * 16 + h * 8 + (lane >> 2);
    if (row >= M) continue;
    if (partial) {
      float* prow =
          partial + static_cast<size_t>(blockIdx.z) * M * N + static_cast<size_t>(row) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (c0 + 8 * j < N)
          *reinterpret_cast<float2*>(prow + c0 + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      continue;
    }
    const int slot = row_slot_of(row_slot, row, n_slots);
    const float* xr = xa + static_cast<size_t>(row) * xa_stride;
    bf16* yrow = y + static_cast<size_t>(row) * N;
    const bool staged = slot >= 0 && slot == s0;
    float xv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) xv[r] = staged && r < R ? xr[r] : 0.f;
    // Four column pairs at a time, each summing its correction over r in
    // order (N is a multiple of 8: a pair is in or out whole).
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cq = c0 + 32 * q;  // column of pair j: cq + 8 j
      float l[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) l[j][0] = l[j][1] = 0.f;
      if (staged) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r >= R) break;
          const float* br = bsm + r * BN + (cq - n0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 bv = *reinterpret_cast<const float2*>(br + 8 * j);
            l[j][0] = fmaf(xv[r], bv.x, l[j][0]);
            l[j][1] = fmaf(xv[r], bv.y, l[j][1]);
          }
        }
      } else if (slot >= 0) {
        const P* bs = b + slot * b_slot_stride + cq;
        for (int r = 0; r < R; ++r) {
          const float xr_r = xr[r];
          const P* br = bs + static_cast<size_t>(r) * N;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (cq + 8 * j < N) {
              const float2 bv = load_pair(br + 8 * j);
              l[j][0] = fmaf(xr_r, round_to<bf16>(bv.x), l[j][0]);
              l[j][1] = fmaf(xr_r, round_to<bf16>(bv.y), l[j][1]);
            }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = 4 * q + j;
        if (cq + 8 * j < N)
          *reinterpret_cast<__nv_bfloat162*>(yrow + cq + 8 * j) =
              __halves2bfloat162(combine<bf16>(acc[4 * jj + 2 * h], l[j][0], scale),
                                 combine<bf16>(acc[4 * jj + 2 * h + 1], l[j][1], scale));
      }
    }
  }
}

// A row-major (outer, inner) bf16 matrix read in (box_outer, box_inner)
// boxes, 128-byte swizzle, zero fill out of bounds.
bool encode_2d(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
               uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled fn = tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(bf16)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename P, int CWG>
int launch_gemm(const void* x, const void* w, const P* b, const int* row_slot, const float* xa,
                bf16* y, float* partial, int M, int N, int K, int R, int xa_stride,
                long long b_stride, int n_slots, int splits, float scale, cudaStream_t st) {
  using C = Cfg<CWG>;
  CUtensorMap tm_x, tm_w;
  if (!encode_2d(&tm_x, x, K, M, BK, C::BM) || !encode_2d(&tm_w, w, N, K, kChunk, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static repro::SmemOptIn opt_in;
  cudaError_t err = opt_in.need(lora_gemm_tc<P, CWG>, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k_steps = (K + BK - 1) / BK;
  const int k_chunk = ((k_steps + splits - 1) / splits) * BK;
  dim3 grid((N + BN - 1) / BN, (M + C::BM - 1) / C::BM, splits);
  lora_gemm_tc<P, CWG><<<grid, C::kThreads, C::kSmem, st>>>(
      tm_x, tm_w, b, row_slot, xa, y, splits > 1 ? partial : nullptr, M, N, K, R, xa_stride,
      b_stride, n_slots, k_chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long outs = static_cast<long long>(M) * N;
  lora_finish<bf16, P><<<static_cast<unsigned>((outs + kThreads - 1) / kThreads), kThreads, 0,
                         st>>>(partial, b, row_slot, xa, y, M, N, R, xa_stride, b_stride, n_slots,
                               splits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// Splits of K: one unless the output tiles leave the card's 132 SMs short of
// two blocks each, and never fewer than 16 K steps of 8 per split.
int k_splits(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int target = 2 * 132;
  if (tiles >= target) return 1;
  const int by_steps = max(1, ((K + BK - 1) / BK) / 16);
  return max(1, min((target + tiles - 1) / tiles, by_steps));
}

// K splits of a call: the tensor route splits only at decode (M <= 64),
// where its 64-row tiles leave the card empty; at prefill a second pass over
// fp32 partial sums costs more than the blocks it adds.
int route_splits(int M, int N, int K, bool tensor) {
  return tensor && M > 64 ? 1 : k_splits(M, N, K);
}

int rank_width(int R) { return R <= 8 ? 8 : (R <= 64 ? 64 : -1); }

template <typename T, typename P>
int launch(const void* x, const void* w, const void* a, const void* b, const int* row_slot,
           float* xa, float* partial, void* y, int M, int N, int K, int R, long long a_stride,
           long long b_stride, int n_slots, float scale, bool tensor, cudaStream_t st) {
  // One row a block at decode (the K loop spread over 8 warps), 8 at
  // prefill; 8-wide x loads when K and x's base allow them.
  const int xa_rows = M <= 64 ? 1 : kXaRows;
  const int vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % (8 * sizeof(T)) == 0;
  const int xa_grid = (M + xa_rows - 1) / xa_rows;
  if (R <= 8)
    lora_xa<T, P, 8><<<xa_grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                                   static_cast<const P*>(a), row_slot, xa, M, K,
                                                   R, a_stride, n_slots, xa_rows, vec);
  else
    lora_xa<T, P, 64><<<xa_grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                                    static_cast<const P*>(a), row_slot, xa, M,
                                                    K, R, a_stride, n_slots, xa_rows, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = route_splits(M, N, K, tensor);
  if (tensor) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return (M <= 64 ? tc::launch_gemm<P, 1> : tc::launch_gemm<P, 2>)(
          x, w, static_cast<const P*>(b), row_slot, xa, static_cast<T*>(y), partial, M, N, K, R,
          rank_width(R), b_stride, n_slots, splits, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_steps = (K + BK - 1) / BK;
  const int k_chunk = ((k_steps + splits - 1) / splits) * BK;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  lora_gemm<T, P><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const P*>(b), row_slot, xa,
      static_cast<T*>(y), splits > 1 ? partial : nullptr, M, N, K, R, rank_width(R), b_stride,
      n_slots, k_chunk, scale);
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
// the number of K splits for an (M, N, K) product on a route (the split-K
// scratch holds splits * M * N floats when splits > 1).
int repro_lora_rank_width(int R) { return rank_width(R); }
int repro_lora_splits(int M, int N, int K, int tensor_route) {
  return route_splits(M, N, K, tensor_route != 0);
}

// y = x @ w + scale * round(x @ a[s]) @ b[s] per row; row_slot may be null
// (slot 0 for every row).  Strides are the pools' slot strides in elements.
// tensor_route selects the wgmma route, which takes bf16 x and W with K and
// N multiples of 8 and 16-byte aligned x and W (the wrapper's route rule);
// 0 the scalar route.  Returns the launch's cudaError_t.
int repro_lora_matmul(const void* x, const void* w, const void* a, const void* b,
                      const int* row_slot, float* xa, float* partial, void* y, int M, int N,
                      int K, int R, int n_slots, long long a_slot_stride,
                      long long b_slot_stride, float scale, int x_bf16, int pool_bf16,
                      int tensor_route, void* stream) {
  if (R < 1 || R > 64) return static_cast<int>(cudaErrorInvalidValue);
  const bool tensor = tensor_route != 0;
  if (tensor && !(x_bf16 && K % 8 == 0 && N % 8 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && pool_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, a, b, row_slot, xa, partial, y, M, N, K,
                                                R, a_slot_stride, b_slot_stride, n_slots,
                                                scale, tensor, st);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R,
                                        a_slot_stride, b_slot_stride, n_slots, scale, tensor,
                                        st);
  if (pool_bf16)
    return launch<float, __nv_bfloat16>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R,
                                        a_slot_stride, b_slot_stride, n_slots, scale, false,
                                        st);
  return launch<float, float>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R, a_slot_stride,
                              b_slot_stride, n_slots, scale, false, st);
}

}  // extern "C"
