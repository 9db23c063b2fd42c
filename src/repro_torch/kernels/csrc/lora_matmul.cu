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
// adds 2*M*R*(K + N) operations, under 1% at R = 8.  Alone, x @ A is bound
// by reading x (16.8 MB, 0.005 ms at prefill).
//
// Design.  The TPU kernel padded R to 128 lanes and sorted rows into
// single-adapter 128-row tiles (segment_layout), so a decode batch of 8
// requests filled whole tiles.  Here no row is moved and R is not padded to
// a lane width.  Two passes a call:
//   1. x @ A (lora_xa_tc for bf16 x, lora_xa_fma for float x) reads each
//      byte of x once, 16 bytes a thread straight into registers.  A block
//      takes 16 or 32 rows (one or two 16-row groups) and its 4 warps along
//      K each a run of kw columns of k; at prefill one block holds a row
//      group's whole K (32 rows a block, 128 blocks at M = 4096), at decode
//      (when the GEMM splits K) up to 16 blocks share K, each writing an
//      fp32 partial plane that lora_finish adds in plane order.
//      * bf16: the products are mma.sync m16n8k16 (rank 8 is one n8
//        fragment, ranks 9-64 eight).  The 16 bytes a thread loads are 8
//        consecutive k of one row; since a dot product may take its k in any
//        order, fragment column c of the k16 step stands for the k that this
//        load put there, and A's fragment is read in the same order from a
//        shared copy of A[s] (rounded to bf16, transposed to [r][k], one
//        16-byte read a thread per 32 k).  Each slot the block's rows name
//        is staged once per K batch and shared by all of them; a 16-row
//        group holding several slots issues one product per slot, each row
//        keeping its own slot's result (the product is per row, so a row's
//        bits do not depend on its neighbours).
//      * float32 stays on FMA: two lanes a row, 4 consecutive k a load, A
//        read as whole rows through L1.
//      Sums: each k run in order, the lanes of a row in a fixed pair, the 4
//      warps of a block in order through shared memory, then the planes in
//      order: no atomics.  The result, rounded to T once, goes to an (M, RP)
//      fp32 scratch, RP = 8 or 64 (the planes of a decode call unrounded).
//      The pass lets its dependent launch at its start
//      (griddepcontrol.launch_dependents).
//   2. The base product, by one of three routes, chosen from the dtype, the
//      alignment and M alone (``lora_matmul.route``, ``plan``):
//      * prefill tensor route (bf16 x and W, K and N multiples of 8, 16-byte
//        aligned bases, M > 64): lora_gemm_wide, launched as the x @ A
//        pass's programmatic dependent.  Persistent clusters of two CTAs
//        (384 threads, one CTA an SM; as many clusters as fit the card at
//        once, 66 on an H100) walk pairs of output tiles, pair p = cluster +
//        i * clusters, in a grouped raster (16 row tiles a group, so the
//        tiles running together share W panels in L2).  A tile is 128 x 256
//        (128 x 128 where 256-wide tiles would not fill the card's 132 SMs,
//        would take more rounds, or K < 2048, wide_bn); the two CTAs take
//        the two row tiles of a pair, so they read the same W boxes: each
//        loads half of them by TMA multicast into both CTAs, which cuts the
//        bytes an SM pulls from L2 a stage from 48 to 32 KB (24 of 32 KB at
//        128-wide tiles).  A producer warpgroup (setmaxnreg down to 40
//        registers; one thread issues every TMA load) keeps a 192 KB ring
//        (4 stages at 256-wide tiles, 6 at 128: x as a (128, 64) K-major box,
//        W as 64-column boxes of its row-major (K, N) layout read N-major
//        through the descriptor's transpose bit, 128-byte swizzle, rows past
//        M zero filled) running on from tile to tile, so tile t + 1 loads
//        while tile t's epilogue runs; a stage is refilled once the consumer
//        warps of both CTAs have released it.  Two consumer warpgroups
//        (setmaxnreg up to 232) each issue wgmma m64n256k16 (m64n128k16) on
//        their 64 rows into a 128 (64) register accumulator, one k step in
//        flight.  Each consumer thread runs griddepcontrol.wait before its
//        first read of xa.
//      * decode tensor route (the same types, M <= 64): lora_gemm_tc, a
//        64 x 128 tile a block of one consumer warpgroup and a producer warp
//        on a 3-stage ring, K split across blocks (k_splits) and lora_finish
//        adding the splits in order; plain stream order.
//      * scalar route (float32, or bf16 with K or N not a multiple of 8):
//        lora_gemm, a 128 x 128 tile per block of 256 threads, each thread
//        an 8 x 8 register tile, K in steps of 8 staged in shared memory as
//        fp32 (scalar FMA), split-K and lora_finish as at decode.  float32
//        stays here because TF32 tensor cores would not hold the float32
//        serving check against the CPU.
//      Every epilogue reads each output's row and column (on the tensor
//      routes from the wgmma fragment layout), the row's slot and its x @ A
//      values, adds scale * xa @ B[s_m][:, col] to the fp32 accumulator in r
//      order and rounds once.  On the tensor routes each warpgroup first
//      stages B[s][:, tile columns] in shared memory for the slot s of its
//      first row (rows come grouped by request; on the prefill route by
//      cp.async under the tile's first products); a row of another slot, or
//      a rank above 8, reads B from global memory; both round B to bf16 as
//      they use it, so the values are the same.
//   3. When the output tiles cannot give the 132 SMs two blocks each (decode:
//      M = 8 is 16 tiles), K is split across blocks (k_splits, the same rule
//      for both routes that split; on the tensor route each split is a
//      whole number of 64-wide K steps); each writes its fp32 partial sums,
//      and lora_finish adds the splits in split order (no atomics) before
//      the same epilogue.  Every sum has one order, so a launch repeats bit
//      for bit, and a row's bits do not depend on the other rows' slots.
// A pool is addressed through its slot stride, so a layer's slice of a
// (n_slots, n_layers, K, R) pool is used where it lies, never copied.
// Ragged M, N and K are masked in the kernels (by TMA's zero fill on the
// tensor routes).  Slots outside [-1, n_slots) trap rather than read another
// adapter's memory.  The TMA tensor maps are encoded on the host for every
// call through cuTensorMapEncodeTiled, taken with cudaGetDriverEntryPoint,
// so the library links no libcuda; each GEMM's shared-memory opt-in is set
// once per device (smem_opt_in.cuh, as for every kernel here).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "smem_opt_in.cuh"
#include "wgmma_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;  // shared rows of BM + 4 floats: no bank conflicts, 16-byte aligned
constexpr int kSms = 132;  // the H100's SMs, for the rules that pick a geometry

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
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

// Eight whole A values of one row (R = 8, 16-byte aligned), as fp32.
__device__ __forceinline__ void load_row8(const float* p, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}
__device__ __forceinline__ void load_row8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// --- x @ A ---------------------------------------------------------------------
constexpr int kXaWarpsK = 4;    // warps of a block along K
constexpr int kXaMaxRows = 32;  // rows a block takes at most (two 16-row groups)

// The pass's geometry (kernels/lora_matmul.py::plan mirrors it): 16-row
// groups a block, k a warp takes, and blocks along K (fp32 partial planes,
// added in order by lora_finish).  At prefill a block holds 32 rows and its
// 4 warps split K; the planes appear only where the GEMM splits K too
// (decode), which keeps every other reader of xa to one rounded plane.
struct XaGeom {
  int row_groups, kw, splits;
};
XaGeom xa_geom(int M, int K, bool gemm_split) {
  const int steps = (K + 31) / 32;  // 32-wide k steps
  if (!gemm_split) return {M > 64 ? 2 : 1, 32 * ((steps + kXaWarpsK - 1) / kXaWarpsK), 1};
  const int most = min(16, (K + 127) / 128);
  const int kw = 32 * ((steps + kXaWarpsK * most - 1) / (kXaWarpsK * most));
  return {1, kw, (K + kXaWarpsK * kw - 1) / (kXaWarpsK * kw)};
}

// Eight consecutive bf16 x values of one row, as the four bf16 pairs of the
// mma fragments: one 16-byte load when `vec` (K a multiple of 8, x
// aligned), else element by element below `limit`.
union X8 {
  uint4 v;
  uint32_t u[4];
};
__device__ __forceinline__ X8 load_x8(const bf16* xr, int k0, int limit, bool vec) {
  X8 x;
  if (vec) {
    x.v = *reinterpret_cast<const uint4*>(xr + k0);
  } else {
    auto bits = [&](int k) -> uint32_t {
      return k < limit ? __bfloat16_as_ushort(xr[k]) : 0u;
    };
#pragma unroll
    for (int t = 0; t < 4; ++t) x.u[t] = bits(k0 + 2 * t) | (bits(k0 + 2 * t + 1) << 16);
  }
  return x;
}

// d += A (16 x 16, bf16 fragments a0..a3) @ B (16 x 8, b0, b1), fp32.
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The shared memory of lora_xa_tc: a K batch of A for each slot staged in a
// pass, [slot][warp along K][r][k], rows of kstr bf16 (kstr = 32 mod 64
// where the batch allows: the 16-byte reads of a quarter warp then fall on
// distinct banks), later the warps' partial sums [warp][row][RP] fp32.
template <int RP>
struct XaTc {
  static constexpr int KB = RP == 8 ? 512 : 32;  // k a warp takes per batch
  static constexpr int kSteps = KB / 32;
  static constexpr int kStr = KB % 64 == 0 ? KB + 32 : KB;
  static constexpr int kABytes = kXaWarpsK * RP * kStr * 2;
  static constexpr int kPartBytes = kXaWarpsK * kXaMaxRows * RP * 4;
  static constexpr int kBufBytes = kABytes > kPartBytes ? kABytes : kPartBytes;
};
static_assert(XaTc<8>::kBufBytes == 34816 && XaTc<64>::kBufBytes == 32768,
              "kernels/lora_matmul.py XA_SMEM");

// One k row of A[s] into the staged copy: RP values at dst[r * kstr],
// rounded to bf16, zero past R or outside the batch (`ok` false).
template <typename P, int RP>
__device__ __forceinline__ void stage_row(bf16* dst, int kstr, const P* ar, bool ok, int R,
                                          bool a_vec) {
  if constexpr (RP == 8) {
    if (ok && a_vec) {
      float v[8];
      load_row8(ar, v);
#pragma unroll
      for (int r = 0; r < 8; ++r) dst[r * kstr] = __float2bfloat16_rn(v[r]);
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < RP; ++r)
    dst[r * kstr] = __float2bfloat16_rn(ok && r < R ? to_f(ar[r]) : 0.f);
}

// The block's partial sums: each warp's [row][RP] in `part`, added over the
// warps in order; one rounded plane, or fp32 partial planes (gridDim.y > 1).
template <typename T, int RP>
__device__ __forceinline__ void xa_store(const float* part, float* __restrict__ xa, int m0,
                                         int rows, int M, int R) {
  const size_t plane = static_cast<size_t>(M) * RP;
  for (int e = threadIdx.x; e < rows * RP; e += blockDim.x) {
    const int i = e / RP, r = e % RP, m = m0 + i;
    if (m >= M || r >= R) continue;
    float s = part[i * RP + r];
#pragma unroll
    for (int q = 1; q < kXaWarpsK; ++q) s += part[(q * kXaMaxRows + i) * RP + r];
    xa[blockIdx.y * plane + static_cast<size_t>(m) * RP + r] =
        gridDim.y == 1 ? to_f(from_f<T>(s)) : s;
  }
}

// x @ A[s] for bf16 x: rows [m0, m0 + 16 row_groups) of block x, warp w the
// row group w % row_groups and the run of k (blockIdx.y * 4 + w / row_groups)
// * kw + [0, kw); threads = 128 row_groups.
template <typename P, int RP>
__global__ void __launch_bounds__(kXaWarpsK * 64)
lora_xa_tc(const bf16* __restrict__ x, const P* __restrict__ a, const int* __restrict__ row_slot,
           float* __restrict__ xa, int M, int K, int R, long long a_slot_stride, int n_slots,
           int kw, int vec, int a_vec) {
  using C = XaTc<RP>;
  constexpr int NF = RP / 8;
  __shared__ __align__(16) uint8_t buf[C::kBufBytes];
  __shared__ int rs[kXaMaxRows], list[kXaMaxRows + 1];
  asm volatile("griddepcontrol.launch_dependents;");  // the GEMM may launch now
  const int rg = blockDim.x / (32 * kXaWarpsK), rows = 16 * rg;
  const int m0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp % rg, q = warp / rg, g = lane >> 2, t = lane & 3;
  if (threadIdx.x < rows)
    rs[threadIdx.x] = m0 + threadIdx.x < M ? row_slot_of(row_slot, m0 + threadIdx.x, n_slots) : -1;
  __syncthreads();
  if (warp == 0) {  // the slots the block's rows name, in order of first appearance
    const int s = lane < rows ? rs[lane] : -1;
    unsigned left = __ballot_sync(~0u, s >= 0);
    int n = 0;
    while (left) {
      const int v = __shfl_sync(~0u, s, __ffs(left) - 1);
      if (lane == 0) list[n] = v;
      left &= ~__ballot_sync(~0u, s == v);
      ++n;
    }
    if (lane == 0) list[kXaMaxRows] = n;
  }
  __syncthreads();
  const int n_list = list[kXaMaxRows];
  // This thread's rows of the m16n8k16 fragments: ra and rb = ra + 8.
  const int ra = 16 * grp + g, rb = ra + 8;
  const int sa = rs[ra], sb = rs[rb];
  const bf16* xra = x + static_cast<size_t>(m0 + ra) * K;  // read only when sa >= 0
  const bf16* xrb = x + static_cast<size_t>(m0 + rb) * K;
  const int k_base = blockIdx.y * kXaWarpsK * kw;
  const int k_lo = k_base + q * kw, k_hi = min(K, k_lo + kw);
  const int kb_len = min(C::KB, kw);
  const int kstr = kb_len % 64 == 0 ? kb_len + 32 : kb_len;
  const int slot_elems = kXaWarpsK * RP * kstr;
  const int per_pass = C::kBufBytes / (2 * slot_elems);
  bf16* at = reinterpret_cast<bf16*>(buf);
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.f;

  for (int kb = 0; kb < kw; kb += kb_len) {
    // The batch's x, every load in flight before the first is used.
    X8 xv[C::kSteps][2];
#pragma unroll
    for (int j = 0; j < C::kSteps; ++j) {
      const int k = k_lo + kb + 32 * j + 8 * t;
      const bool in = 32 * j < kb_len && k < k_hi;
      xv[j][0].v = xv[j][1].v = make_uint4(0, 0, 0, 0);
      if (in && sa >= 0) xv[j][0] = load_x8(xra, k, k_hi, vec != 0);
      if (in && sb >= 0) xv[j][1] = load_x8(xrb, k, k_hi, vec != 0);
    }
    for (int l0 = 0; l0 < n_list; l0 += per_pass) {
      const int n_here = min(per_pass, n_list - l0);
      __syncthreads();  // the staged copy's last readers are done
      for (int e = threadIdx.x; e < n_here * kXaWarpsK * kb_len; e += blockDim.x) {
        const int li = e / (kXaWarpsK * kb_len), rem = e - li * kXaWarpsK * kb_len;
        const int qq = rem / kb_len, kk = rem - qq * kb_len;
        const int k = k_base + qq * kw + kb + kk;
        stage_row<P, RP>(at + (li * kXaWarpsK + qq) * RP * kstr + kk, kstr,
                         a + list[l0 + li] * a_slot_stride + static_cast<size_t>(k) * R,
                         kb + kk < kw && k < K, R, a_vec != 0);
      }
      __syncthreads();
      for (int li = 0; li < n_here; ++li) {
        const int v = list[l0 + li];
        const bool ka = sa == v, kb2 = sb == v;
        if (!__any_sync(~0u, ka || kb2)) continue;  // no row of this group names v
        const bf16* as = at + (li * kXaWarpsK + q) * RP * kstr;
#pragma unroll
        for (int j = 0; j < C::kSteps; ++j) {
          if (32 * j >= kb_len) break;
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            // k 8t .. 8t + 7 of this step for rank 8f + g: the B fragments of
            // both k16 products (the first takes k 8t .. 8t + 3 of every
            // thread's load, the second k 8t + 4 .. 8t + 7).
            const uint4 bv = *reinterpret_cast<const uint4*>(as + (8 * f + g) * kstr + 32 * j + 8 * t);
            float d[4] = {acc[f][0], acc[f][1], acc[f][2], acc[f][3]};
            mma_16816(d, xv[j][0].u[0], xv[j][1].u[0], xv[j][0].u[1], xv[j][1].u[1], bv.x, bv.y);
            mma_16816(d, xv[j][0].u[2], xv[j][1].u[2], xv[j][0].u[3], xv[j][1].u[3], bv.z, bv.w);
            if (ka) acc[f][0] = d[0], acc[f][1] = d[1];
            if (kb2) acc[f][2] = d[2], acc[f][3] = d[3];
          }
        }
      }
    }
  }
  __syncthreads();  // the staged copy becomes the warps' partial sums
  float* part = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    float* pa = part + (q * kXaMaxRows + ra) * RP + 8 * f + 2 * t;
    float* pb = part + (q * kXaMaxRows + rb) * RP + 8 * f + 2 * t;
    pa[0] = acc[f][0], pa[1] = acc[f][1];
    pb[0] = acc[f][2], pb[1] = acc[f][3];
  }
  __syncthreads();
  xa_store<bf16, RP>(part, xa, m0, rows, M, R);
}

// x @ A[s] for float x, on the same geometry as lora_xa_tc: two lanes a row
// (16 rows a warp), each a float4 of k and 4 rows of A[s] a step, k in
// steps of 8 along the warp's run.
template <typename P, int RP>
__global__ void __launch_bounds__(kXaWarpsK * 64)
lora_xa_fma(const float* __restrict__ x, const P* __restrict__ a,
            const int* __restrict__ row_slot, float* __restrict__ xa, int M, int K, int R,
            long long a_slot_stride, int n_slots, int kw, int vec, int a_vec) {
  __shared__ float part[kXaWarpsK * kXaMaxRows * RP];
  asm volatile("griddepcontrol.launch_dependents;");
  const int rg = blockDim.x / (32 * kXaWarpsK), rows = 16 * rg;
  const int m0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp % rg, q = warp / rg, half = lane & 1;
  const int i = 16 * grp + (lane >> 1), m = m0 + i;
  const int slot = m < M ? row_slot_of(row_slot, m, n_slots) : -1;
  const int k_lo = blockIdx.y * kXaWarpsK * kw + q * kw, k_hi = min(K, k_lo + kw);
  float acc[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc[r] = 0.f;
  if (slot >= 0) {
    const float* xr = x + static_cast<size_t>(m) * K;
    const P* as = a + slot * a_slot_stride;
#pragma unroll 4
    for (int k0 = k_lo + 4 * half; k0 < k_hi; k0 += 8) {
      float xv[4];
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(xr + k0);
        xv[0] = v.x, xv[1] = v.y, xv[2] = v.z, xv[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = k0 + j < k_hi ? xr[k0 + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + j >= k_hi) break;
        const P* ar = as + static_cast<size_t>(k0 + j) * R;
        float av[RP];
        if constexpr (RP == 8) {
          if (a_vec) {
            load_row8(ar, av);
          } else {
#pragma unroll
            for (int r = 0; r < RP; ++r) av[r] = r < R ? to_f(ar[r]) : 0.f;
          }
        } else {
#pragma unroll
          for (int r = 0; r < RP; ++r) av[r] = r < R ? to_f(ar[r]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) acc[r] = fmaf(xv[j], av[r], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RP; ++r) acc[r] += __shfl_xor_sync(~0u, acc[r], 1);  // the row's pair
  if (half == 0)
#pragma unroll
    for (int r = 0; r < RP; ++r) part[(q * kXaMaxRows + i) * RP + r] = acc[r];
  __syncthreads();
  xa_store<float, RP>(part, xa, m0, rows, M, R);
}

// x @ A row m's value at rank r, rounded to T: the one plane as stored, or
// the sum of the planes in order, rounded here.
template <typename T>
__device__ __forceinline__ float xa_at(const float* __restrict__ xa, size_t plane, int splits,
                                       size_t i) {
  if (splits == 1) return xa[i];
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += xa[z * plane + i];
  return to_f(from_f<T>(s));
}

// One output: the fp32 base sum plus scale * xa @ B[slot][:, col], rounded
// once.  Shared by the scalar route's one-pass and split-K epilogues.
template <typename T, typename P>
__device__ __forceinline__ T finish(float acc, const float* __restrict__ xa, size_t plane,
                                    int xa_splits, size_t xa_row, const P* __restrict__ b,
                                    int slot, long long b_slot_stride, int R, int N, int col,
                                    float scale) {
  float lora = 0.f;
  if (slot >= 0) {
    const P* bs = b + slot * b_slot_stride + col;
#pragma unroll 8
    for (int r = 0; r < R; ++r)
      lora = fmaf(xa_at<T>(xa, plane, xa_splits, xa_row + r),
                  round_to<T>(bs[static_cast<size_t>(r) * N]), lora);
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
      else  // one split: the x @ A pass wrote one plane
        y[o] = finish<T, P>(acc[i][j], xa, 0, 1, static_cast<size_t>(row) * xa_stride, b, slot,
                            b_slot_stride, R, N, col, scale);
    }
  }
}

// Split-K epilogue: one thread per output adds the splits in order.  Where
// the x @ A pass left partial planes, the block first adds them (in plane
// order, rounded once) for the few rows its outputs lie in, in shared memory.
constexpr int kFinishXa = 1024;  // floats of x @ A a block holds
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
lora_finish(const float* __restrict__ partial, const P* __restrict__ b,
            const int* __restrict__ row_slot, const float* __restrict__ xa, T* __restrict__ y,
            int M, int N, int R, int xa_stride, int xa_splits, long long b_slot_stride,
            int n_slots, int splits, float scale) {
  __shared__ float xs[kFinishXa];
  const size_t o0 = static_cast<size_t>(blockIdx.x) * kThreads, o = o0 + threadIdx.x;
  const size_t outs = static_cast<size_t>(M) * N;
  const int row_lo = static_cast<int>(o0 / N);
  const size_t end = o0 + kThreads < outs ? o0 + kThreads : outs;
  const int rows = static_cast<int>((end - 1) / N) - row_lo + 1;
  const size_t plane = static_cast<size_t>(M) * xa_stride;
  const bool shared = xa_splits > 1 && rows * R <= kFinishXa;
  if (shared) {
    for (int e = threadIdx.x; e < rows * R; e += kThreads)
      xs[e] = xa_at<T>(xa, plane, xa_splits,
                       static_cast<size_t>(row_lo + e / R) * xa_stride + e % R);
    __syncthreads();
  }
  if (o >= outs) return;
  const int row = static_cast<int>(o / N), col = static_cast<int>(o % N);
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += partial[static_cast<size_t>(z) * M * N + o];
  const int slot = row_slot_of(row_slot, row, n_slots);
  y[o] = shared ? finish<T, P>(acc, xs, 0, 1, static_cast<size_t>(row - row_lo) * R, b, slot,
                               b_slot_stride, R, N, col, scale)
                : finish<T, P>(acc, xa, plane, xa_splits, static_cast<size_t>(row) * xa_stride,
                               b, slot, b_slot_stride, R, N, col, scale);
}

// --- Tensor routes: TMA ring + wgmma -------------------------------------------
namespace tc {

using namespace repro;
constexpr int BK = 64;       // K per stage: one 128-byte swizzle row of bf16
constexpr int kChunk = 64;   // W columns per TMA box (128 bytes, the swizzle width)

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// A pair of P values (8 or 4 bytes) copied into shared memory without
// passing through registers; zeros where `valid` is false.
template <typename P>
__device__ __forceinline__ void cp_async_pair(uint32_t dst, const P* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(src),
               "n"(2 * sizeof(P)), "r"(valid ? static_cast<int>(2 * sizeof(P)) : 0)
               : "memory");
}

// The epilogue of one warpgroup's 64 rows from m_base and BW columns from
// n0 (the wgmma fragment layout: acc[4 j + 2 h + e] is row 16 warp + 8 h +
// lane / 4 and column 8 j + 2 (lane % 4) + e): the x @ A values of each row
// (one rounded plane), its slot, B's columns rounded to bf16, from `bsm`
// (B[s0][:, n0:n0 + BW], r major, already rounded) where the row's slot is
// s0, else from global memory (the same values), summed in r order and
// added to the base sum, rounded once.
template <typename P, int BW>
__device__ __forceinline__ void epilogue(const float (&acc)[BW / 2], const P* bsm, int s0,
                                         int m_base, int n0, const P* __restrict__ b,
                                         const int* __restrict__ row_slot,
                                         const float* __restrict__ xa, bf16* __restrict__ y,
                                         int M, int N, int R, int xa_stride,
                                         long long b_slot_stride, int n_slots, float scale) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m_base + warp * 16 + h * 8 + (lane >> 2);
    if (row >= M) continue;
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
    for (int q = 0; q < BW / 32; ++q) {
      const int cq = c0 + 32 * q;  // column of pair j: cq + 8 j
      float l[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) l[j][0] = l[j][1] = 0.f;
      if (staged) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r >= R) break;
          const P* br = bsm + r * BW + (cq - n0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 bv = load_pair(br + 8 * j);  // rounded to bf16 where staged
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
      // Keep the next group's loads after these stores, so that the unrolled
      // loop holds one group's B values at a time beside the accumulator.
      asm volatile("" ::: "memory");
    }
  }
}

// ---- Decode (M <= 64): a 64 x 128 tile a block, K split ------------------------
constexpr int kDecBN = 128;
constexpr int kDecStages = 3;
constexpr int kDecBM = 64;
constexpr int kDecThreads = 128 + 32;  // a consumer warpgroup, then one producer warp
constexpr int kDecABytes = kDecBM * BK * 2;
constexpr int kDecStageBytes = kDecABytes + BK * kDecBN * 2;
// Stages, a full and an empty barrier per stage, the epilogue's B rows (rank
// <= 8, fp32), and slack to align the stages to the 1024-byte swizzle atom.
constexpr int kDecSmem = kDecStages * kDecStageBytes + 2 * kDecStages * 8 + 8 * kDecBN * 4 + 1024;

// The base product of one (64, 128) output tile over K range
// [kz * k_chunk, +k_chunk), k_chunk a multiple of 64, then the epilogue (one
// split) or the fp32 partial sums (split K, finished by lora_finish).
template <typename P>
__global__ void __launch_bounds__(kDecThreads, 2)
lora_gemm_tc(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
             const P* __restrict__ b, const int* __restrict__ row_slot,
             const float* __restrict__ xa, bf16* __restrict__ y, float* __restrict__ partial,
             int M, int N, int K, int R, int xa_stride, long long b_slot_stride, int n_slots,
             int k_chunk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = smem + kDecStages * kDecStageBytes;  // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kDecStages;
  const int m0 = blockIdx.y * kDecBM, n0 = blockIdx.x * kDecBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int n_iter = max(0, (min(K, k_begin + k_chunk) - k_begin + BK - 1) / BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDecStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: one lane issues every load
    if (threadIdx.x == 128) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kDecStages;
        if (it >= kDecStages) mbar_wait(empty0 + 8 * s, ((it / kDecStages) - 1) & 1);
        const uint32_t a_s = smem + s * kDecStageBytes, b_s = a_s + kDecABytes;
        const uint32_t bar = full0 + 8 * s;
        const int k = k_begin + it * BK;
        mbar_expect_tx(bar, kDecStageBytes);
        tma_load_2d(a_s, &tm_x, k, m0, bar);
#pragma unroll
        for (int c = 0; c < kDecBN / kChunk; ++c)
          tma_load_2d(b_s + c * BK * kChunk * 2, &tm_w, n0 + c * kChunk, k, bar);
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kDecStages;
    mbar_wait(full0 + 8 * s, (it / kDecStages) & 1);
    __syncwarp();  // the warpgroup's .aligned instructions need converged warps
    // A: 64 rows of 128 bytes, 8-row swizzle atoms 1024 bytes apart; a 16-wide
    // K step is 32 bytes along the row.  B: (64 K rows, 64 columns) boxes of
    // 128-byte rows, the second 64 columns 8192 bytes on (leading offset),
    // 8 K rows 1024 bytes apart (stride offset); a K step is 16 rows.
    const uint32_t a_s = smem + s * kDecStageBytes;
    const uint32_t b_s = a_s + kDecABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<1>(acc, smem_desc(a_s + kk * 32, 16, 1024),
                  smem_desc(b_s + kk * 16 * kChunk * 2, BK * kChunk * 2, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: hand it back
    if (it > 0) mbar_arrive(empty0 + 8 * ((it - 1) % kDecStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  if (partial) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + h * 8 + (lane >> 2);
      if (row >= M) continue;
      float* prow =
          partial + static_cast<size_t>(blockIdx.z) * M * N + static_cast<size_t>(row) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (c0 + 8 * j < N)
          *reinterpret_cast<float2*>(prow + c0 + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    return;
  }
  // One split: the warpgroup stages B[s0][:, n0:n0+128] for the slot s0 of
  // its first row, then the shared epilogue.
  P* bsm = reinterpret_cast<P*>(smem_raw + (empty0 + 8 * kDecStages - smem_u32(smem_raw)));
  int s0 = -1;
  if (R <= 8) {
    if (m0 < M) s0 = row_slot_of(row_slot, m0, n_slots);
    if (s0 >= 0)
      for (int e = threadIdx.x; e < R * kDecBN; e += 128) {
        const int r = e / kDecBN, col = n0 + e % kDecBN;
        bsm[e] = from_f<P>(
            col < N ? round_to<bf16>(b[s0 * b_slot_stride + static_cast<size_t>(r) * N + col])
                    : 0.f);
      }
    named_sync(1);
  }
  epilogue<P, kDecBN>(acc, bsm, s0, m0, n0, b, row_slot, xa, y, M, N, R, xa_stride,
                      b_slot_stride, n_slots, scale);
}

// ---- Prefill (M > 64): the persistent 128 x BN GEMM ----------------------------
constexpr int kWideBM = 128;
constexpr int kGroupM = 16;  // row tiles of a raster group
constexpr int kWideThreads = 384;  // two consumer warpgroups, then the producer's
// Registers a thread after setmaxnreg: the 168 of a 384-thread launch, moved
// from the producer to the consumers (4 x 40 + 8 x 232 = 12 x 168).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWideABytes = kWideBM * BK * 2;  // x: a (128, 64) box, 16 KB
// The ring: 192 KB, as 4 stages of 48 KB at 256-wide tiles or 6 of 32 KB at
// 128-wide ones (W: BW / 64 boxes of (64, 64)).
constexpr int kWideRing = 4 * (kWideABytes + BK * 256 * 2);
template <int BW>
struct Wide {
  static constexpr int kStageBytes = kWideABytes + BK * BW * 2;
  static constexpr int kStages = kWideRing / kStageBytes;
};
constexpr int kWideMaxStages = Wide<128>::kStages;
constexpr int kWideEpiBytes = 2 * 8 * 256 * 4;  // B rows of each warpgroup (fp32 at most)
// Slack to align the stages to the 1024-byte swizzle atom, the ring, the
// epilogue's B rows, a full and an empty barrier per stage.
constexpr int kWideSmem = 1024 + kWideRing + kWideEpiBytes + 2 * kWideMaxStages * 8;
static_assert(Wide<256>::kStages == 4 && Wide<128>::kStages == 6 && kWideSmem == 214112,
              "kernels/lora_matmul.py GEMM_STAGES, GEMM_SMEM");
static_assert(kWideSmem <= 232448, "a block's shared memory on the H100");

// Output tile pair `t` of the grouped raster: a pair is two row tiles (a
// cluster's two CTAs) of one column tile; kGroupM row tiles (kGroupM / 2
// pair rows) a group, the group's pairs column by column.
__device__ __forceinline__ void pair_at(int t, int pair_rows, int tiles_n, int& pm, int& tn) {
  constexpr int kGroup = kGroupM / 2;
  const int per_group = kGroup * tiles_n;
  const int grp = t / per_group, first = grp * kGroup;
  const int rows = min(pair_rows - first, kGroup);
  const int r = t - grp * per_group;
  pm = first + r % rows;
  tn = r / rows;
}

// Clusters of two CTAs on neighbouring SMs take row tiles 2 pm and 2 pm + 1
// of one column tile: each loads its own x box and half of the W boxes,
// multicast to both, so a stage costs each SM 16 KB of x and half of W from
// L2 (32 of 48 KB at 256-wide tiles).  A stage is refilled only once the
// consumer warps of both CTAs have released it (16 arrivals on each CTA's
// "empty" barrier, half of them remote).
template <typename P, int BW>
__global__ void __launch_bounds__(kWideThreads, 1)
lora_gemm_wide(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const P* __restrict__ b, const int* __restrict__ row_slot,
               const float* __restrict__ xa, bf16* __restrict__ y, int M, int N, int K, int R,
               int xa_stride, long long b_slot_stride, int n_slots, float scale) {
  constexpr int kStages = Wide<BW>::kStages, kStageBytes = Wide<BW>::kStageBytes;
  constexpr int kHalfBoxes = BW / kChunk / 2;  // W boxes a CTA loads for the pair
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t epi = smem + kWideRing;
  const uint32_t full0 = epi + kWideEpiBytes, empty0 = full0 + 8 * kStages;
  const int rank = static_cast<int>(cluster_ctarank());
  const int cluster = blockIdx.x >> 1, n_clusters = gridDim.x >> 1;
  const int tiles_m = (M + kWideBM - 1) / kWideBM, tiles_n = (N + BW - 1) / BW;
  const int pair_rows = (tiles_m + 1) / 2, n_pairs = pair_rows * tiles_n;
  const int k_iters = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 16);  // one arrival a consumer warp of either CTA
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers exist before any multicast or remote arrival

  if (threadIdx.x >= 256) {
    // The producer warpgroup gives its registers to the consumers; one
    // thread issues every load, the ring running on from tile to tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;
      for (int pair = cluster; pair < n_pairs; pair += n_clusters) {
        int pm, tn;
        pair_at(pair, pair_rows, tiles_n, pm, tn);
        const int tm = 2 * pm + rank;  // past M on the last pair of an odd count: zeros
        for (int kk = 0; kk < k_iters; ++kk, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
          const uint32_t a_s = smem + s * kStageBytes, b_s = a_s + kWideABytes;
          const uint32_t bar = full0 + 8 * s;
          mbar_expect_tx(bar, kStageBytes);  // the peer's half of W lands here too
          tma_load_2d(a_s, &tm_x, kk * BK, tm * kWideBM, bar);
#pragma unroll
          for (int c = rank * kHalfBoxes; c < (rank + 1) * kHalfBoxes; ++c)
            tma_load_2d_multicast(b_s + c * BK * kChunk * 2, &tm_w, tn * BW + c * kChunk, kk * BK,
                                  bar, 0x3);
        }
      }
    }
    __syncwarp();
  } else {
    // Consumer warpgroup wg: rows [m0 + 64 wg, +64) of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, lane = threadIdx.x & 31;
    auto release = [&](int stage) {  // one arrival a warp on both CTAs, its products done
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_cluster(empty0 + 8 * stage, 0);
        mbar_arrive_cluster(empty0 + 8 * stage, 1);
      }
    };
    const uint32_t bsm_s = epi + wg * 8 * 256 * 4;  // this warpgroup's B rows
    const P* bsm = reinterpret_cast<const P*>(smem_raw + (bsm_s - smem_u32(smem_raw)));
    float acc[BW / 2];
    int it = 0;  // stages consumed so far
    bool waited = false;
    for (int pair = cluster; pair < n_pairs; pair += n_clusters) {
      int pm, tn;
      pair_at(pair, pair_rows, tiles_n, pm, tn);
      const int m0 = (2 * pm + rank) * kWideBM, n0 = tn * BW;
      const int s0 =
          R <= 8 && m0 + 64 * wg < M ? row_slot_of(row_slot, m0 + 64 * wg, n_slots) : -1;
      for (int kk = 0; kk < k_iters; ++kk, ++it) {
        const int s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        __syncwarp();  // the warpgroup's .aligned instructions need converged warps
        const uint32_t a_s = smem + s * kStageBytes + wg * 64 * BK * 2;
        const uint32_t b_s = smem + s * kStageBytes + kWideABytes;
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < BK / 16; ++k16)  // the tile's first product starts the sum
          wgmma_ss<1>(acc, smem_desc(a_s + k16 * 32, 16, 1024),
                      smem_desc(b_s + k16 * 16 * kChunk * 2, BK * kChunk * 2, 1024),
                      kk > 0 || k16 > 0);
        wgmma_commit();
        if (kk == 0) {
          // B[s0][:, n0:n0+BW] for the epilogue, copied under the first
          // products (cp.async, no registers) once every warp of the
          // warpgroup is past the last tile's epilogue.
          named_sync(1 + wg);
          if (s0 >= 0) {
            const P* bs = b + s0 * b_slot_stride + n0;
            for (int e = tid; e < R * BW / 2; e += 128) {
              const int r = e / (BW / 2), c = 2 * (e % (BW / 2));
              const bool ok = n0 + c < N;
              cp_async_pair(bsm_s + (r * BW + c) * static_cast<int>(sizeof(P)),
                            bs + (ok ? static_cast<size_t>(r) * N + c : 0), ok);
            }
          }
          asm volatile("cp.async.commit_group;" ::: "memory");
        }
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        if (kk > 0) release((it - 1) % kStages);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release((it - 1) % kStages);
      if (!waited) {
        // xa is the x @ A pass's output: this kernel is that pass's
        // programmatic dependent, so every thread that reads xa waits for it.
        asm volatile("griddepcontrol.wait;" ::: "memory");
        waited = true;
      }
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      if constexpr (std::is_same<P, float>::value) {
        // An fp32 pool's rows, rounded to bf16 in place (each thread its own
        // copies; a bf16 pool's are bf16 already).
        if (s0 >= 0) {
          float* own = reinterpret_cast<float*>(smem_raw + (bsm_s - smem_u32(smem_raw)));
          for (int e = tid; e < R * BW / 2; e += 128) {
            const int r = e / (BW / 2), c = 2 * (e % (BW / 2));
            float2* v = reinterpret_cast<float2*>(own + r * BW + c);
            *v = make_float2(round_to<bf16>(v->x), round_to<bf16>(v->y));
          }
        }
      }
      named_sync(1 + wg);  // the staged B rows are in place
      epilogue<P, BW>(acc, bsm, s0, m0 + 64 * wg, n0, b, row_slot, xa, y, M, N, R, xa_stride,
                      b_slot_stride, n_slots, scale);
    }
  }
  cluster_sync();  // no CTA leaves while its peer may still arrive on its barriers
}

// The prefill tile width: 256 where 256-wide tiles fill a round of the
// card's 132 SMs, take no more rounds than 128-wide ones (counted in rounds
// of 128 columns) and K is at least 2048; else 128.  Below K = 2048 a
// 256-wide tile's mainloop is too short to carry its epilogue, twice a
// 128-wide one's (Whisper's 12000 x 1024 x 1024: 0.120 ms at 128 against
// 0.139 at 256, tools/kernel_call_costs.py on an H100).
int wide_bn(int M, int N, int K) {
  const long long tm = (M + kWideBM - 1) / kWideBM;
  const long long t256 = tm * ((N + 255) / 256), t128 = tm * ((N + 127) / 128);
  if (t256 < kSms || K < 2048) return 128;
  return (t128 + kSms - 1) / kSms < 2 * ((t256 + kSms - 1) / kSms) ? 128 : 256;
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

template <typename P>
int launch_decode(const void* x, const void* w, const P* b, const int* row_slot, const float* xa,
                  bf16* y, float* partial, int M, int N, int K, int R, int xa_stride,
                  int xa_splits, long long b_stride, int n_slots, int splits, float scale,
                  cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  if (!encode_2d(&tm_x, x, K, M, BK, kDecBM) || !encode_2d(&tm_w, w, N, K, kChunk, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static repro::SmemOptIn opt_in;
  cudaError_t err = opt_in.need(lora_gemm_tc<P>, kDecSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k_steps = (K + BK - 1) / BK;
  const int k_chunk = ((k_steps + splits - 1) / splits) * BK;
  dim3 grid((N + kDecBN - 1) / kDecBN, (M + kDecBM - 1) / kDecBM, splits);
  lora_gemm_tc<P><<<grid, kDecThreads, kDecSmem, st>>>(
      tm_x, tm_w, b, row_slot, xa, y, splits > 1 ? partial : nullptr, M, N, K, R, xa_stride,
      b_stride, n_slots, k_chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long outs = static_cast<long long>(M) * N;
  lora_finish<bf16, P><<<static_cast<unsigned>((outs + kThreads - 1) / kThreads), kThreads, 0,
                         st>>>(partial, b, row_slot, xa, y, M, N, R, xa_stride, xa_splits,
                               b_stride, n_slots, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of two that fit the card at once (cudaOccupancyMaxActiveClusters:
// an SM left alone in its GPC takes none), looked up once per device.
template <typename P, int BW>
cudaError_t max_clusters(int* out) {
  static std::atomic<int> cached[repro::SmemOptIn::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= repro::SmemOptIn::kMaxDevices) return cudaErrorInvalidDevice;
  int v = cached[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(kWideThreads);
    cfg.dynamicSmemBytes = kWideSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&v, lora_gemm_wide<P, BW>, &cfg);
    if (err != cudaSuccess) return err;
    if (v < 1) return cudaErrorInvalidConfiguration;
    cached[dev].store(v, std::memory_order_relaxed);
  }
  *out = v;
  return cudaSuccess;
}

// Clusters of the prefill GEMM for an (M, N) call: one a pair of tiles,
// at most as many as fit the card at once.
template <typename P, int BW>
cudaError_t wide_clusters(int M, int N, int* out) {
  static repro::SmemOptIn opt_in;
  cudaError_t err = opt_in.need(lora_gemm_wide<P, BW>, kWideSmem);
  if (err != cudaSuccess) return err;
  int most = 0;
  err = max_clusters<P, BW>(&most);
  if (err != cudaSuccess) return err;
  const long long pairs =
      static_cast<long long>((M + 2 * kWideBM - 1) / (2 * kWideBM)) * ((N + BW - 1) / BW);
  if (pairs >= (1ll << 30)) return cudaErrorInvalidValue;
  *out = static_cast<int>(pairs < most ? pairs : most);
  return cudaSuccess;
}

template <typename P, int BW>
int launch_wide(const void* x, const void* w, const P* b, const int* row_slot, const float* xa,
                bf16* y, int M, int N, int K, int R, int xa_stride, long long b_stride,
                int n_slots, float scale, cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  if (!encode_2d(&tm_x, x, K, M, BK, kWideBM) || !encode_2d(&tm_w, w, N, K, kChunk, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  cudaError_t err = wide_clusters<P, BW>(M, N, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Clusters of two, launched as the x @ A pass's programmatic dependent:
  // the blocks start on the SMs the pass leaves, their products run while it
  // finishes, and only the reads of xa wait for it (griddepcontrol.wait).
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(2 * clusters));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = kWideSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, lora_gemm_wide<P, BW>, tm_x, tm_w, b, row_slot, xa, y, M, N, K,
                           R, xa_stride, b_stride, n_slots, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// Splits of K: one unless the output tiles leave the card's 132 SMs short of
// two blocks each, and never fewer than 16 K steps of 8 per split.
int k_splits(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int target = 2 * kSms;
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
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const int splits = route_splits(M, N, K, tensor);
  const XaGeom xg = xa_geom(M, K, splits > 1);
  const int RP = rank_width(R);
  // 16-byte loads of x where K and x's base allow them; whole 16-byte rows
  // of A at rank 8.
  const int vec = K % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int a_vec = R == 8 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    (a_stride * static_cast<long long>(sizeof(P))) % 16 == 0;
  const dim3 xa_grid((M + 16 * xg.row_groups - 1) / (16 * xg.row_groups), xg.splits);
  const int xa_threads = 32 * kXaWarpsK * xg.row_groups;
  const P* ap = static_cast<const P*>(a);
  if constexpr (kBf16) {
    const bf16* xp = static_cast<const bf16*>(x);
    if (RP == 8)
      lora_xa_tc<P, 8><<<xa_grid, xa_threads, 0, st>>>(xp, ap, row_slot, xa, M, K, R, a_stride,
                                                       n_slots, xg.kw, vec, a_vec);
    else
      lora_xa_tc<P, 64><<<xa_grid, xa_threads, 0, st>>>(xp, ap, row_slot, xa, M, K, R, a_stride,
                                                        n_slots, xg.kw, vec, a_vec);
  } else {
    const float* xp = static_cast<const float*>(x);
    if (RP == 8)
      lora_xa_fma<P, 8><<<xa_grid, xa_threads, 0, st>>>(xp, ap, row_slot, xa, M, K, R, a_stride,
                                                        n_slots, xg.kw, vec, a_vec);
    else
      lora_xa_fma<P, 64><<<xa_grid, xa_threads, 0, st>>>(xp, ap, row_slot, xa, M, K, R,
                                                         a_stride, n_slots, xg.kw, vec, a_vec);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const P* bp = static_cast<const P*>(b);
  if (tensor) {
    if constexpr (kBf16) {
      bf16* yp = static_cast<bf16*>(y);
      if (M <= 64)
        return tc::launch_decode<P>(x, w, bp, row_slot, xa, yp, partial, M, N, K, R, RP,
                                    xg.splits, b_stride, n_slots, splits, scale, st);
      return (tc::wide_bn(M, N, K) == 256 ? tc::launch_wide<P, 256> : tc::launch_wide<P, 128>)(
          x, w, bp, row_slot, xa, yp, M, N, K, R, RP, b_stride, n_slots, scale, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_steps = (K + BK - 1) / BK;
  const int k_chunk = ((k_steps + splits - 1) / splits) * BK;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  lora_gemm<T, P><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bp, row_slot, xa, static_cast<T*>(y),
      splits > 1 ? partial : nullptr, M, N, K, R, RP, b_stride, n_slots, k_chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long outs = static_cast<long long>(M) * N;
  lora_finish<T, P><<<static_cast<unsigned>((outs + kThreads - 1) / kThreads), kThreads, 0,
                      st>>>(partial, bp, row_slot, xa, static_cast<T*>(y), M, N, R, RP,
                            xg.splits, b_stride, n_slots, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch floats of an (M, N, K) call at rank R on a route: out[0] the x @ A
// planes (splits * M * width), out[1] the split-K partial sums (splits * M *
// N, 0 with one split).  Returns a cudaError_t.
int repro_lora_scratch(int M, int N, int K, int R, int tensor_route, long long* out) {
  if (R < 1 || R > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = route_splits(M, N, K, tensor_route != 0);
  const XaGeom xg = xa_geom(M, K, splits > 1);
  out[0] = static_cast<long long>(xg.splits) * M * rank_width(R);
  out[1] = splits > 1 ? static_cast<long long>(splits) * M * N : 0;
  return 0;
}

int repro_lora_splits(int M, int N, int K, int tensor_route) {
  return route_splits(M, N, K, tensor_route != 0);
}

// What a launch of an (M, N, K) call on a route would run, for the
// wrapper's plan check: K splits, the GEMM's tile (rows, columns) and grid
// (x, y, z), the x @ A pass's rows a block, threads a block, k a warp,
// planes and blocks along M, and on the prefill route the clusters of two
// that fit the card at once (0 elsewhere).  Returns a cudaError_t.
int repro_lora_plan(int M, int N, int K, int tensor_route, int* out) {
  const bool tensor = tensor_route != 0;
  const int splits = route_splits(M, N, K, tensor);
  const XaGeom xg = xa_geom(M, K, splits > 1);
  int tile_m = BM, tile_n = BN, gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM, gz = splits;
  int most = 0;
  if (tensor && M <= 64) {
    tile_m = tc::kDecBM, tile_n = tc::kDecBN;
    gx = (N + tile_n - 1) / tile_n, gy = (M + tile_m - 1) / tile_m;
  } else if (tensor) {
    tile_m = tc::kWideBM, tile_n = tc::wide_bn(M, N, K);
    int clusters = 0;  // the fp32 pool's instance: both pool types launch the same grid
    cudaError_t err = tile_n == 256 ? tc::wide_clusters<float, 256>(M, N, &clusters)
                                    : tc::wide_clusters<float, 128>(M, N, &clusters);
    if (err == cudaSuccess)
      err = tile_n == 256 ? tc::max_clusters<float, 256>(&most)
                          : tc::max_clusters<float, 128>(&most);
    if (err != cudaSuccess) return static_cast<int>(err);
    gx = 2 * clusters, gy = gz = 1;
  }
  const int values[12] = {splits, tile_m, tile_n, gx, gy, gz, 16 * xg.row_groups,
                          32 * kXaWarpsK * xg.row_groups, xg.kw, xg.splits,
                          (M + 16 * xg.row_groups - 1) / (16 * xg.row_groups), most};
  for (int i = 0; i < 12; ++i) out[i] = values[i];
  return 0;
}

// The prefill GEMM's and the x @ A pass's built geometry (the fp32 pool's
// instances, the serving pool's type): threads, shared bytes, registers a
// thread at launch for the 256- and 128-wide tiles (from the compiled
// kernels) and after setmaxnreg (consumers, producer), blocks an SM (the
// occupancy calculator's), ring stages; the pass's threads at prefill,
// static shared bytes, registers and blocks an SM (rank 8, bf16 x); the
// local (spilled) bytes a thread of the GEMM and of the pass; the GEMM's
// clusters of two that fit the card at once.
int repro_lora_geometry(int* out) {
  cudaFuncAttributes g256, g128, xa;
  cudaError_t err = cudaFuncGetAttributes(&g256, tc::lora_gemm_wide<float, 256>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&g128, tc::lora_gemm_wide<float, 128>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&xa, lora_xa_tc<float, 8>);
  int clusters = 0, per_sm = 0, xa_per_sm = 0;
  const int xa_threads = 32 * kXaWarpsK * 2;
  if (err == cudaSuccess) err = tc::wide_clusters<float, 256>(1 << 20, 1 << 16, &clusters);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tc::lora_gemm_wide<float, 256>,
                                                        tc::kWideThreads, tc::kWideSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&xa_per_sm, lora_xa_tc<float, 8>,
                                                        xa_threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[15] = {tc::kWideThreads,
                          tc::kWideSmem,
                          g256.numRegs,
                          g128.numRegs,
                          tc::kConsumerRegs,
                          tc::kProducerRegs,
                          per_sm,
                          tc::Wide<256>::kStages,
                          xa_threads,
                          static_cast<int>(xa.sharedSizeBytes),
                          xa.numRegs,
                          xa_per_sm,
                          static_cast<int>(g256.localSizeBytes + g128.localSizeBytes),
                          static_cast<int>(xa.localSizeBytes),
                          clusters};
  for (int i = 0; i < 15; ++i) out[i] = values[i];
  return 0;
}

// y = x @ w + scale * round(x @ a[s]) @ b[s] per row; row_slot may be null
// (slot 0 for every row).  Strides are the pools' slot strides in elements.
// xa and partial hold what repro_lora_scratch says.  tensor_route selects
// the wgmma routes, which take bf16 x and W with K and N multiples of 8 and
// 16-byte aligned x and W (the wrapper's route rule); 0 the scalar route.
// Returns the launch's cudaError_t.
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
    return launch<bf16, bf16>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R, a_slot_stride,
                              b_slot_stride, n_slots, scale, tensor, st);
  if (x_bf16)
    return launch<bf16, float>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R, a_slot_stride,
                               b_slot_stride, n_slots, scale, tensor, st);
  if (pool_bf16)
    return launch<float, bf16>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R, a_slot_stride,
                               b_slot_stride, n_slots, scale, false, st);
  return launch<float, float>(x, w, a, b, row_slot, xa, partial, y, M, N, K, R, a_slot_stride,
                              b_slot_stride, n_slots, scale, false, st);
}

}  // extern "C"
