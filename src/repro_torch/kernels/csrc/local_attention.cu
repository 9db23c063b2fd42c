// Causal sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/local_attention.py::
// local_attention.  Per (batch*head) b and query row i of a (BH, S, D)
// problem:
//
//   out[b, i] = softmax_j( q_i . k_j / sqrt(D) , masked ) @ v
//   mask: j < S, and j <= i when causal, and j > i - window when window > 0
//
// with the reference's online softmax: a running max m, normalizer l and
// accumulator acc per query row in fp32, masked scores set to -1e30 (not
// -inf), out = acc / max(l, 1e-30).  D is 32, 64, 128 or 256 (RecurrentGemma
// and Gemma take 256, Qwen2-VL 128).  Both routes visit only the key tiles a
// query tile needs (the causal and window skip of the TPU kernel), mask keys
// past S in a ragged last tile, and use no atomics: the same inputs give the
// same bits on every launch.
//
// Two routes, chosen by the wrapper from the dtype alone
// (``local_attention.route``):
//
// * Tensor route (bf16): attention_tc.  A block of 4 warps takes 64 query
//   rows, 16 a warp; the blocks of the longest causal rows launch first.  Q
//   is staged once in shared memory; key tiles of K and V are
//   double-buffered there by cp.async (the next tile's copy runs under this
//   tile's products), each read once per query tile (128-row blocks of 8
//   warps measured slower).  The geometry depends on D (TcGeom): up to
//   D = 64, 64-key tiles, Q's fragments held in registers, four blocks an SM
//   (46 KB of tiles at D = 64).  At D = 128, 64-key tiles, Q in registers,
//   two blocks an SM (85 KB).  At D = 256 a warp's 16 x 256 fp32 output
//   accumulator alone is 128 registers a thread, and Q's fragments would be
//   64 more, so Q's fragments are read again from shared memory (ldmatrix)
//   for every key tile, the key tiles are 32 keys (16 score registers), and
//   two blocks fit an SM: 99 KB of tiles (Q 33 KB, two buffers of K and V
//   66 KB) a block, 198 KB of the SM's 227 KB, under
//   __launch_bounds__(128, 2), 255 registers a thread.  ``nvcc -Xptxas -v``
//   with the flags of ``kernels/backend.py`` (CUDA 12.9, sm_90a): 116, 128,
//   203 and 238 registers a thread at D = 32, 64, 128 and 256, no spills.
//   Above 48 KB the launcher opts in to the shared memory once per device
//   (smem_opt_in.cuh).  S = Q K^T and
//   O += P V run on the tensor cores as mma.sync m16n8k16 bf16 -> fp32 with
//   ldmatrix fragments (V through ldmatrix.trans).  mma.sync and not wgmma:
//   at the prefill shape (BH, S, D) = (256, 512, 64) causal the kernel is
//   bound by its 67 MB of bytes even at the tensor-core rate (0.020 ms
//   against 0.009 ms for the operations), so what counts is reading K and
//   V once per query tile and overlapping the copies, not the last factor
//   of the MMA rate; m16n8k16 keeps each warp's 16 rows and their softmax
//   in registers without a warpgroup's 64-row granularity, and lets a warp
//   skip a tile that is masked for all its rows (exact: such a tile's p
//   are 0, or garbage that the first kept key wipes).  The softmax is fp32
//   and online, in log2 units (scores scaled by log2(e) / sqrt(D), the
//   SFU's ex2.approx): each row's scores of a tile sit in the 4 threads of
//   a quad, whose
//   running max is combined by a fixed shuffle tree (xor 1, then 2); each
//   thread keeps a partial normalizer, added over the quad the same way at
//   the end.  The scores' C fragments are the A fragments of P V once
//   rounded to bf16.  That rounding is one the plain version does not make:
//   each p_j moves by at most 2^-8 p_j (bf16's unit roundoff), so an output
//   sum_j p_j v_j / l moves by at most 2^-8 sum_j p_j |v_j| / l.  The checks
//   hold each output entry to that, plus 2^-12 of it for the fp32 sums and
//   2^-8 of each result for its rounding to bf16 (chip_smoke.py,
//   ATTN_BF16_U).
// * Scalar route (float32): attention_scalar.  One block per 64-query tile
//   (32 at D = 256).  Up to D = 64 a thread takes one query row, q and acc
//   (D floats each) in its registers.  Wider heads would spill them, so at
//   D = 128 and 256 ScalarGeom splits a row over D / 32 threads of one
//   warp: each holds 32 of the row's D entries of q and acc, as float4
//   pieces dealt round robin (the row's threads read 16 consecutive bytes
//   each, no bank conflict), and a dot product's partial sums are added by
//   a fixed xor-shuffle tree, which gives every thread of the row the same
//   bits.  Key tiles of K and V
//   (32 keys, 16 at D = 256: 32 KB, under the static limit) are staged in
//   shared memory and read by all rows at the same address (a broadcast);
//   products and sums are fp32 FMA on the CUDA cores, where the operations
//   bind.  ``-Xptxas -v`` as above: 152, 236, 159 and 137 registers at D =
//   32, 64, 128 and 256, no spills (64-row blocks of 512 threads at D = 256
//   spilled 52 bytes under their 128-register bound).  float32 stays here
//   because TF32 tensor cores would not hold the float32 serving check
//   against the CPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_opt_in.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// --- Scalar route (float32) ----------------------------------------------------
// Query rows per block, threads per query row and keys per shared-memory
// tile, by head width.  At D = 256, 32 rows a block: 256 threads, so the
// launch bound leaves 255 registers a thread (512 threads spilled).
template <int D>
struct ScalarGeom {
  static constexpr int kRows = D <= 128 ? 64 : 32;
  static constexpr int kLanes = D <= 64 ? 1 : D / 32;
  static constexpr int kKeys = D <= 128 ? 32 : 16;
  static constexpr int kThreads = kRows * kLanes;
  static constexpr int kPieces = D / 4 / kLanes;  // float4 pieces of q a thread holds
  static_assert(32 % kLanes == 0 && D % (4 * kLanes) == 0, "a row's threads share a warp");
};

template <int D>
__global__ void __launch_bounds__(ScalarGeom<D>::kThreads)
attention_scalar(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int window,
                 int causal, float scale) {
  using G = ScalarGeom<D>;
  constexpr int BKV = G::kKeys;
  __shared__ __align__(16) float ks[BKV][D];
  __shared__ __align__(16) float vs[BKV][D];
  const int q_lo = blockIdx.x * G::kRows;
  const int lane = threadIdx.x % G::kLanes;  // this thread's pieces: lane + kLanes * i
  const int qi = q_lo + threadIdx.x / G::kLanes;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;

  float qr[4 * G::kPieces], acc[4 * G::kPieces];
#pragma unroll
  for (int i = 0; i < G::kPieces; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (lane + G::kLanes * i) + e;
      qr[4 * i + e] = qi < S ? q[base + static_cast<size_t>(qi) * D + d] : 0.f;
      acc[4 * i + e] = 0.f;
    }
  float m = kNegInf, l = 0.f;

  const int q_last = min(q_lo + G::kRows, S) - 1;
  const int key_last = causal ? q_last : S - 1;
  const int key_first = window ? max(0, q_lo - window + 1) : 0;
  for (int t0 = (key_first / BKV) * BKV; t0 <= key_last; t0 += BKV) {
    for (int e = threadIdx.x; e < BKV * D; e += G::kThreads) {
      const int j = e / D, d = e % D;
      const int kpos = t0 + j;
      const size_t off = base + static_cast<size_t>(kpos) * D + d;
      ks[j][d] = kpos < S ? k[off] : 0.f;
      vs[j][d] = kpos < S ? v[off] : 0.f;
    }
    __syncthreads();

    float s[BKV];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < G::kPieces; ++i) {
        const float4 kv = kr[lane + G::kLanes * i];
        dot = fmaf(qr[4 * i], kv.x, dot);
        dot = fmaf(qr[4 * i + 1], kv.y, dot);
        dot = fmaf(qr[4 * i + 2], kv.z, dot);
        dot = fmaf(qr[4 * i + 3], kv.w, dot);
      }
      // The row's partial sums, added pairwise: both threads of a pair add
      // the same two numbers, so every thread ends with the same bits.
#pragma unroll
      for (int off = 1; off < G::kLanes; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kpos = t0 + j;
      bool keep = kpos < S;
      if (causal) keep = keep && qi >= kpos;
      if (window) keep = keep && kpos > qi - window;
      s[j] = keep ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < 4 * G::kPieces; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int i = 0; i < G::kPieces; ++i) {
        const float4 vv = vr[lane + G::kLanes * i];
        acc[4 * i] = fmaf(s[j], vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* out = o + base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int i = 0; i < G::kPieces; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * (lane + G::kLanes * i) + e] = acc[4 * i + e] * inv;
  }
}

// --- Tensor route (bf16) -------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;      // query rows per block: 4 warps of 16
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Keys per K / V tile, blocks an SM, and whether Q's fragments stay in
// registers, by head width (see the note at the top).
template <int D>
struct TcGeom {
  static constexpr int kKeys = D <= 128 ? 64 : 32;
  static constexpr int kBlocksPerSm = D <= 64 ? 4 : 2;
  static constexpr bool kQInRegs = D <= 128;
};

// Shared rows padded by 16 bytes: the 8 rows an ldmatrix phase reads fall
// in 8 distinct 16-byte bank groups (row strides of an odd number of
// 16-byte pieces: 80, 144, 272 and 528 bytes).
template <int D>
struct Tiles {
  bf16 q[BQ][D + 8];
  bf16 k[2][TcGeom<D>::kKeys][D + 8];
  bf16 v[2][TcGeom<D>::kKeys][D + 8];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (rows past S).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of one (S, D) head into a padded shared tile.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16 (*dst)[D + 8], const bf16* src, int row0, int S) {
  constexpr int kPerRow = D / 8;  // 16-byte pieces of a row
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow, p = c % kPerRow;
    const int row = row0 + r;
    const bool valid = row < S;
    cp_async16(&dst[r][p * 8], src + static_cast<size_t>(valid ? row : 0) * D + p * 8, valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx, ~2 ulp): exactly 0 for the masked -1e30
// differences, exactly 1 at 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layout (m16n8): thread lane holds rows g = lane / 4 and g + 8,
// columns 2 (lane % 4) and + 1 of each 8-column block; index 2 h + e is
// row g + 8 h, column 2 (lane % 4) + e.
template <int D>
__global__ void __launch_bounds__(kThreads, TcGeom<D>::kBlocksPerSm)
attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int S, int window, int causal,
             float scale_log2) {
  constexpr int BKV = TcGeom<D>::kKeys;
  constexpr bool kQInRegs = TcGeom<D>::kQInRegs;
  extern __shared__ __align__(16) unsigned char tiles_raw[];
  Tiles<D>& sm = *reinterpret_cast<Tiles<D>*>(tiles_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The longest causal rows first: the last query tile is block 0.
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const bf16* qh = q + base;
  const bf16* kh = k + base;
  const bf16* vh = v + base;

  const int q_last = min(q_lo + BQ, S) - 1;
  const int key_last = causal ? q_last : S - 1;
  const int key_first = window ? max(0, q_lo - window + 1) : 0;
  const int t_first = key_first / BKV;
  const int n_tiles = key_last / BKV - t_first + 1;

  load_tile<D, BQ>(sm.q, qh, q_lo, S);
  load_tile<D, BKV>(sm.k[0], kh, t_first * BKV, S);
  load_tile<D, BKV>(sm.v[0], vh, t_first * BKV, S);
  cp_async_commit();

  const int w_lo = q_lo + warp * 16;  // this warp's rows [w_lo, w_lo + 16)
  uint32_t qf[kQInRegs ? D / 16 : 1][4];  // Q's A fragments, when they stay in registers
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_part[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      load_tile<D, BKV>(sm.k[buf ^ 1], kh, (t_first + i + 1) * BKV, S);
      load_tile<D, BKV>(sm.v[buf ^ 1], vh, (t_first + i + 1) * BKV, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], &sm.q[warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
      }
    }
    const int t0 = (t_first + i) * BKV;
    // A tile masked for every row of this warp changes nothing it keeps
    // (its p are 0, or garbage wiped by the first kept key): skip it.
    const bool empty = w_lo >= S || (causal && t0 > w_lo + 15) ||
                       (window && t0 + BKV - 1 <= w_lo - window);
    if (!empty) {
      // S = Q K^T: 8 blocks of 8 keys, D / 16 steps of 16.
      float s[BKV / 8][4];
#pragma unroll
      for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          ldmatrix_x4(qa, &sm.q[warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
        }
#pragma unroll
        for (int nb2 = 0; nb2 < BKV / 16; ++nb2) {
          uint32_t b[4];
          ldmatrix_x4(b, &sm.k[buf][nb2 * 16 + (lane & 7) + (lane >> 4) * 8]
                                 [kk * 16 + ((lane >> 3) & 1) * 8]);
          mma_bf16(s[2 * nb2], qa, b[0], b[1]);
          mma_bf16(s[2 * nb2 + 1], qa, b[2], b[3]);
        }
      }

      // Scale (to log2 units) and mask; a tile wholly inside every row's
      // window skips the mask.
      const bool masked = (causal && t0 + BKV - 1 > w_lo) || t0 + BKV > S ||
                          (window && t0 <= w_lo + 15 - window);
#pragma unroll
      for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sc = s[nb][e] * scale_log2;
          if (masked) {
            const int row = w_lo + g + 8 * (e >> 1), key = t0 + nb * 8 + 2 * t4 + (e & 1);
            bool keep = key < S;
            if (causal) keep = keep && row >= key;
            if (window) keep = keep && key > row - window;
            if (!keep) sc = kNegInf;
          }
          s[nb][e] = sc;
        }

      // Online softmax per row (h = 0: row g, h = 1: row g + 8).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int nb = 0; nb < BKV / 8; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * h], s[nb][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx);
        const float alpha = exp2_approx(m_run[h] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2_approx(s[nb][2 * h + e] - m_new);
            s[nb][2 * h + e] = p;
            psum += p;
          }
        l_part[h] = l_part[h] * alpha + psum;
        m_run[h] = m_new;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
          acc[nb][2 * h] *= alpha;
          acc[nb][2 * h + 1] *= alpha;
        }
      }

      // O += P V: P's C fragments, rounded to bf16, are the A fragments.
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nb2 = 0; nb2 < D / 16; ++nb2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, &sm.v[buf][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                        [nb2 * 16 + (lane >> 4) * 8]);
          mma_bf16(acc[2 * nb2], pa, b[0], b[1]);
          mma_bf16(acc[2 * nb2 + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_part[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = w_lo + g + 8 * h;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* out = o + base + static_cast<size_t>(row) * D + 2 * t4;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(out + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * h] * inv, acc[nb][2 * h + 1] * inv);
  }
}

}  // namespace tc

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int window,
           int causal, bool tensor, cudaStream_t st) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  if (tensor) {
    constexpr int kSmem = sizeof(tc::Tiles<D>);
    if constexpr (kSmem > 48 * 1024) {
      static repro::SmemOptIn opt_in;
      const cudaError_t err = opt_in.need(tc::attention_tc<D>, kSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dim3 grid((S + tc::BQ - 1) / tc::BQ, BH);
    tc::attention_tc<D><<<grid, tc::kThreads, kSmem, st>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), S, window, causal,
        scale * tc::kLog2e);
  } else {
    dim3 grid((S + ScalarGeom<D>::kRows - 1) / ScalarGeom<D>::kRows, BH);
    attention_scalar<D><<<grid, ScalarGeom<D>::kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), S, window, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the launch's cudaError_t.
// tensor_route (the wrapper's route rule) takes bf16 tensors, the scalar
// route float32 ones.
int repro_local_attention(const void* q, const void* k, const void* v, void* o, int BH, int S,
                          int D, int window, int causal, int bf16, int tensor_route,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH > 65535 || S < 1 || (tensor_route != 0) != (bf16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tensor = tensor_route != 0;
  if (D == 64) return launch<64>(q, k, v, o, BH, S, window, causal, tensor, st);
  if (D == 32) return launch<32>(q, k, v, o, BH, S, window, causal, tensor, st);
  if (D == 128) return launch<128>(q, k, v, o, BH, S, window, causal, tensor, st);
  if (D == 256) return launch<256>(q, k, v, o, BH, S, window, causal, tensor, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
