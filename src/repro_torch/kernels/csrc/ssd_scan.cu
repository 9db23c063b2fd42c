// Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan.
// Per (batch*head) row of x (BH, S, P), log-decays da (BH, S) and the
// single-group B, C (G, S, N) (row bh reads group bh / (BH / G)):
//
//   h_t = exp(da_t) h_{t-1} + B_t^T x_t        (h is N x P, h_0 = 0 or h0)
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
// final h (BH, N, P) is written when asked (prefill hands it to decode), and
// the state before position 0 is read from h0 (BH, N, P) when one is given
// (the model's h_init), else zero: the state warps load their columns of it
// into the accumulator fragments and into the shared copy of h that the
// first tile's inter product reads.
//
// Bound: at prefill, (BH, S, P, N) = (192, 512, 64, 128), the tile-64
// algorithm does 2 * (T(T+1)/2 * (N + P) + 2 T N P) operations per tile of
// every row, the upper triangle skipped: 4.45 GFLOP, 0.066 ms at the fp32
// CUDA-core rate of 67 TFLOP/s, against 61 MB of operands (x and y 25 MB
// each, the final state 6 MB; B and C read once per batch row), 0.018 ms at
// 3.35 TB/s.  On the tensor cores in 3xTF32 (three TF32 passes, 495 / 3 =
// 165 TFLOP/s) the same operations take 0.027 ms, still above the bytes.
//
// Design: two kernels a call.
//
//   ssd_prep: one block per (tile, group) computes the raw score tile
//   C B^T (64 x 64, K = N) once for the group, not once for each of its
//   heads and column blocks (48 at prefill), and the inclusive sums of da
//   (in log2 units, for ex2) for every head of the group.  Scratch: (G, tiles, 64, 64) scores, 1 MB at prefill, and
//   (BH, tiles * 64) sums.
//
//   ssd_scan: the recurrence for column p of h and y reads column p of x
//   only, so a block takes one row bh and PT = 32 columns of P: a grid of
//   (P / PT, BH) blocks, 384 at prefill.  A block takes 226 KB of shared
//   memory, one an SM: 2.9 waves, the last 91% full (a persistent grid of
//   one block an SM, prefetching across its items, measured no faster).  16 warps: eight
//   "output" warps own 16 rows of y each and half of inter's K, eight
//   "state" warps own 16 rows of h each.  Per tile:
//     - tile it + 1's B, C, x, scores and sums are copied into the other
//       stage of a two-stage ring by cp.async while tile it computes;
//     - phase 1: the output warps form inter C h from the state entering
//       the tile, each over half of K; the state warps split x into its
//       TF32 halves (once, for every product that reads it) and run the
//       carry (B o w)^T x into h, which lives in their accumulator
//       fragments from tile to tile;
//     - phase 2: each output warp adds its partner's half-sums (passed
//       through shared memory, first half of K first), scales by exp(cum_i)
//       and runs intra (L o C B^T) x for two n8 tiles, decaying the scores
//       as it reads them; the state warps mirror h into shared memory for
//       the next tile's inter product;
//     - every product is mma.m16n8k8 in 3xTF32 (tf32x3.cuh), each warp's A
//       fragment split once a k-step and feeding four (or two) independent
//       MMA chains, two k-steps a fragment before the fp32 add;
//     - two __syncthreads a tile, and one barrier among the state warps.
//   Shared rows are padded so that every fragment load of a warp hits 32
//   distinct banks (A operands read at a row stride = 4 mod 8 floats, B
//   operands and the transposed read of B at a stride = 8 mod 16).
//
// The decay of the upper triangle (i < j) is exp of a positive number and
// would overflow: those entries are selected to 0, never multiplied by a
// mask.  Positions past S take da = 0 and B = C = x = 0, as the TPU kernel
// pads them, and are not stored.  Each output is written by one thread, the
// tensor cores sum in a fixed order and there are no atomics: two launches
// give the same bits.
#include <cuda_runtime.h>

#include "smem_opt_in.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int T = 64;          // positions per tile
constexpr int NMAX = 128;      // largest state width N
constexpr int PT = 32;         // columns of P per block
constexpr int kThreads = 512;      // 16 warps of the scan
constexpr int kPrepThreads = 256;  // 8 warps of the first pass
constexpr int SA = NMAX + 4;   // row stride of C (and of B in ssd_prep): A rows
constexpr int SB = NMAX + 8;   // row stride of B in ssd_scan: read transposed
constexpr int SL = T + 4;      // row stride of the score tile: A rows
constexpr int SX = PT + 8;     // row stride of x and h: B rows

struct Stage {
  float b[T][SB];  // B[t0 + j][n]
  float c[T][SA];  // C[t0 + i][n]
  float l[T][SL];  // C_i . B_j (decayed and masked as the intra product reads it)
  float x[T][SX];  // this block's columns of x
  float cum[T];    // inclusive sum of da log2 e within the tile
};

struct Smem {
  Stage st[2];              // x of a stage becomes its TF32 hi half in phase 1
  float xlo[T][SX];         // and this its lo half
  float h[NMAX][SX];        // state entering the tile
  float red[4][2][2][4][32];  // inter half-sums passed between half-K warps, lane-major
};

struct PrepSmem {
  float b[T][SA];
  float c[T][SA];
};

using repro::cp_async16;
using repro::cp_async4;

// Rows [t0, t0 + T) of a (S, N) group into a shared tile of stride LD,
// columns [0, np), zero past S and past N.  The loops run over NMAX-wide
// rows (shifts, not divisions) and skip the columns past np.
template <int LD, int NTHREADS>
__device__ __forceinline__ void load_rows(float (*dst)[LD], const float* src, int t0, int len,
                                          int N, int np, bool vec4) {
  if (vec4) {
    for (int e = threadIdx.x; e < T * (NMAX / 4); e += NTHREADS) {
      const int j = e / (NMAX / 4), q = 4 * (e % (NMAX / 4));
      if (q >= np) continue;
      const bool ok = j < len && q < N;
      cp_async16(&dst[j][q], src + (ok ? static_cast<size_t>(t0 + j) * N + q : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < T * NMAX; e += NTHREADS) {
      const int j = e / NMAX, q = e % NMAX;
      if (q >= np) continue;
      const bool ok = j < len && q < N;
      cp_async4(&dst[j][q], src + (ok ? static_cast<size_t>(t0 + j) * N + q : 0), ok);
    }
  }
}

// 2^x by the SFU (ex2.approx, about 2^-22 relative): every decay is
// exp(a) = 2^(a log2 e), with the sums of da kept in log2 units.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// Scores and sums of one (tile, group).
__global__ void __launch_bounds__(kPrepThreads)
ssd_prep_kernel(const float* __restrict__ da, const float* __restrict__ b,
                const float* __restrict__ c, float* __restrict__ cb, float* __restrict__ cum,
                int S, int N, int np, int heads_per_group, int vec4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PrepSmem& sm = *reinterpret_cast<PrepSmem*>(smem_raw);
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int grp = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int t0 = tile * T;
  const int len = min(T, S - t0);
  const size_t goff = static_cast<size_t>(grp) * S * N;
  load_rows<SA, kPrepThreads>(sm.b, b + goff, t0, len, N, np, vec4);
  load_rows<SA, kPrepThreads>(sm.c, c + goff, t0, len, N, np, vec4);
  repro::cp_async_commit();

  // Inclusive sums of da log2 e, one head a warp at a time, two positions a
  // lane.
  const int s_pad = n_tiles * T;
  for (int hh = warp; hh < heads_per_group; hh += kPrepThreads / 32) {
    const size_t bh = static_cast<size_t>(grp) * heads_per_group + hh;
    const float* dar = da + bh * S + t0;
    const int j0 = 2 * lane;
    const float d0 = j0 < len ? dar[j0] * kLog2e : 0.f;
    const float d1 = j0 + 1 < len ? dar[j0 + 1] * kLog2e : 0.f;
    float s = d0 + d1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += v;
    }
    float prev = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) prev = 0.f;
    float* out = cum + bh * s_pad + t0;
    out[j0] = prev + d0;
    out[j0 + 1] = prev + d0 + d1;
  }

  repro::cp_async_wait<0>();
  __syncthreads();
  // C B^T: warp w owns rows 16 (w % 4) .. + 16, columns 32 (w / 4) .. + 32.
  const int i0 = 16 * (warp & 3);
  const int jb = 32 * (warp >> 2);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < np; k0 += 8) {
    const float av[4] = {sm.c[i0 + gq][k0 + tq], sm.c[i0 + gq + 8][k0 + tq],
                         sm.c[i0 + gq][k0 + tq + 4], sm.c[i0 + gq + 8][k0 + tq + 4]};
    uint32_t ah[4], al[4];
    repro::split_a(av, ah, al);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = jb + 8 * q + gq;
      uint32_t bh[2], bl[2];
      repro::split_b(sm.b[j][k0 + tq], sm.b[j][k0 + tq + 4], bh, bl);
      repro::mma_3xtf32(acc[q], ah, al, bh, bl);
    }
  }
  float* out = cb + (static_cast<size_t>(grp) * n_tiles + tile) * T * T;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = jb + 8 * q + 2 * tq;
    *reinterpret_cast<float2*>(out + (i0 + gq) * T + j) = make_float2(acc[q][0], acc[q][1]);
    *reinterpret_cast<float2*>(out + (i0 + gq + 8) * T + j) = make_float2(acc[q][2], acc[q][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ cb,
                const float* __restrict__ cum, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int S, int P, int N, int np,
                int heads_per_group, int n_tiles, int vec4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int p_base = blockIdx.x * PT;
  const int grp = bh / heads_per_group;
  const float* xr = x + static_cast<size_t>(bh) * S * P;
  const float* br = b + static_cast<size_t>(grp) * S * N;
  const float* cr = c + static_cast<size_t>(grp) * S * N;
  const float* cbr = cb + static_cast<size_t>(grp) * n_tiles * T * T;
  const float* cumr = cum + static_cast<size_t>(bh) * n_tiles * T;
  float* yr = y + static_cast<size_t>(bh) * S * P;

  auto load = [&](int it) {
    Stage& st = sm.st[it & 1];
    const int t0 = it * T;
    const int len = min(T, S - t0);
    load_rows<SB, kThreads>(st.b, br, t0, len, N, np, vec4);
    load_rows<SA, kThreads>(st.c, cr, t0, len, N, np, vec4);
    if (vec4) {
      for (int e = tid; e < T * (PT / 4); e += kThreads) {
        const int j = e / (PT / 4), q = 4 * (e % (PT / 4));
        const bool ok = j < len && p_base + q < P;
        cp_async16(&st.x[j][q], xr + (ok ? static_cast<size_t>(t0 + j) * P + p_base + q : 0),
                   ok);
      }
    } else {
      for (int e = tid; e < T * PT; e += kThreads) {
        const int j = e / PT, q = e % PT;
        const bool ok = j < len && p_base + q < P;
        cp_async4(&st.x[j][q], xr + (ok ? static_cast<size_t>(t0 + j) * P + p_base + q : 0),
                  ok);
      }
    }
    const float* cbt = cbr + static_cast<size_t>(it) * T * T;
    for (int e = tid; e < T * (T / 4); e += kThreads) {
      const int i = e / (T / 4), q = 4 * (e % (T / 4));
      cp_async16(&st.l[i][q], cbt + i * T + q);
    }
    if (tid < T / 4) cp_async16(&st.cum[4 * tid], cumr + t0 + 4 * tid);
    repro::cp_async_commit();
  };

  // Warps 0-7 ("output"): m16 rows i0 = 16 (w % 4) of y and all four n8
  // tiles of the block's columns; inter over half of K (kh = w / 4), the
  // halves added in phase 2 by the kh = 0 warp, which then runs intra and
  // stores y.  Warps 8-15 ("state"): state rows n0 = 16 (w - 8) (live below
  // np) and all four n8 tiles; they split x and run the carry.  Each warp's
  // A fragment is split once a k-step and feeds four independent MMA chains.
  const bool out_warp = warp < 8;
  const int mt = warp & 3, kh = (warp >> 2) & 1;
  const int i0 = 16 * mt;
  const int n0 = 16 * (warp - 8);
  const bool owns_state = !out_warp && n0 < np;
  // The state entering tile 0: h0's rows [0, N) and this block's columns,
  // zero elsewhere (rows past N pad K of the inter product).
  const float* h0r = h0 == nullptr ? nullptr : h0 + static_cast<size_t>(bh) * N * P;
  float hacc[4][4] = {};
  if (h0r != nullptr && owns_state) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p_base + 8 * q + 2 * tq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + gq + 8 * hf;
        if (n < N) {
          if (p < P) hacc[q][2 * hf] = h0r[static_cast<size_t>(n) * P + p];
          if (p + 1 < P) hacc[q][2 * hf + 1] = h0r[static_cast<size_t>(n) * P + p + 1];
        }
      }
    }
  }
  for (int e = tid; e < NMAX * SX; e += kThreads) {
    const int n = e / SX, q = e % SX;
    const bool ok = h0r != nullptr && n < N && q < PT && p_base + q < P;
    (&sm.h[0][0])[e] = ok ? h0r[static_cast<size_t>(n) * P + p_base + q] : 0.f;
  }
  load(0);

  for (int it = 0; it < n_tiles; ++it) {
    repro::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; h of the previous tile is in sm.h
    if (it + 1 < n_tiles) load(it + 1);  // its stage was last read by tile it - 1
    Stage& st = sm.st[it & 1];
    const int t0 = it * T;
    const int len = min(T, S - t0);
    const float cum_last = st.cum[T - 1];  // positions past S add 0

    // Phase 1: the output warps form inter C h from the state entering the
    // tile (sm.h), the state warps the carry into their registers (sm.h
    // receives it only after the barrier below).  Two k-steps share a
    // fragment before it is added in fp32 (tf32x3.cuh).
    float yacc[4][4] = {};
    if (out_warp) {
      const int kb = kh * (np / 2);
      for (int k0 = kb; k0 < kb + np / 2; k0 += 16) {
        float t2[4][4] = {};
#pragma unroll
        for (int kk = k0; kk < k0 + 16; kk += 8) {
          const float av[4] = {st.c[i0 + gq][kk + tq], st.c[i0 + gq + 8][kk + tq],
                               st.c[i0 + gq][kk + tq + 4], st.c[i0 + gq + 8][kk + tq + 4]};
          uint32_t ah[4], al[4];
          repro::split_a(av, ah, al);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t bh_[2], bl_[2];
            repro::split_b(sm.h[kk + tq][8 * q + gq], sm.h[kk + tq + 4][8 * q + gq], bh_, bl_);
            repro::mma_3xtf32_into(t2[q], ah, al, bh_, bl_);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[q][e] += t2[q][e];
      }
      // Hand the other half-K warp the n8 tiles it finishes: kh = 0 keeps
      // tiles 0, 1 and passes 2, 3; kh = 1 the other way round.
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // constant indices keep yacc in registers
          sm.red[mt][kh][q][e][lane] = kh == 0 ? yacc[2 + q][e] : yacc[q][e];
    } else {
      for (int e = tid - kThreads / 2; e < T * PT; e += kThreads / 2) {
        const int j = e / PT, q = e % PT;
        uint32_t hi, lo;
        repro::split_tf32(st.x[j][q], hi, lo);
        st.x[j][q] = __uint_as_float(hi);
        sm.xlo[j][q] = __uint_as_float(lo);
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kThreads / 2) : "memory");  // the state warps' x split
      if (owns_state) {
        const float chunk_decay = exp2_approx(cum_last);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[q][e] *= chunk_decay;
        for (int k0 = 0; k0 < T; k0 += 16) {
          float t2[4][4] = {};
#pragma unroll
          for (int kk = k0; kk < k0 + 16; kk += 8) {
            const float w0 = exp2_approx(cum_last - st.cum[kk + tq]);
            const float w4 = exp2_approx(cum_last - st.cum[kk + tq + 4]);
            const float av[4] = {st.b[kk + tq][n0 + gq] * w0, st.b[kk + tq][n0 + gq + 8] * w0,
                                 st.b[kk + tq + 4][n0 + gq] * w4,
                                 st.b[kk + tq + 4][n0 + gq + 8] * w4};
            uint32_t ah[4], al[4];
            repro::split_a(av, ah, al);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int col = 8 * q + gq;
              const uint32_t bh_[2] = {__float_as_uint(st.x[kk + tq][col]),
                                       __float_as_uint(st.x[kk + tq + 4][col])};
              const uint32_t bl_[2] = {__float_as_uint(sm.xlo[kk + tq][col]),
                                       __float_as_uint(sm.xlo[kk + tq + 4][col])};
              repro::mma_3xtf32_into(t2[q], ah, al, bh_, bl_);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) hacc[q][e] += t2[q][e];
        }
      }
    }
    __syncthreads();  // x split, inter halves in sm.red, every read of sm.h done

    // Phase 2: y = exp(cum_i) C h + (L o C B^T) x by the output warps, n8
    // tiles 2 kh and 2 kh + 1 each, the scores decayed as their fragments are
    // read (j > i selected to 0); the new state into sm.h by the state warps.
    if (out_warp) {
      const float c0 = st.cum[i0 + gq], c8 = st.cum[i0 + gq + 8];
      const float d0 = exp2_approx(c0), d8 = exp2_approx(c8);
      float ya[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* other = &sm.red[mt][1 - kh][q][0][lane];
        ya[q][0] = (kh == 0 ? yacc[q][0] + other[0] : other[0] + yacc[2 + q][0]) * d0;
        ya[q][1] = (kh == 0 ? yacc[q][1] + other[32] : other[32] + yacc[2 + q][1]) * d0;
        ya[q][2] = (kh == 0 ? yacc[q][2] + other[64] : other[64] + yacc[2 + q][2]) * d8;
        ya[q][3] = (kh == 0 ? yacc[q][3] + other[96] : other[96] + yacc[2 + q][3]) * d8;
      }
      const int r0 = i0 + gq, r8 = r0 + 8;
      for (int k0 = 0; k0 < i0 + 16; k0 += 16) {  // column blocks past the diagonal are 0
        float t2[2][4] = {};
#pragma unroll
        for (int kk = k0; kk < k0 + 16; kk += 8) {
          const int j0 = kk + tq, j4 = j0 + 4;
          const float e0 = st.cum[j0], e4 = st.cum[j4];
          const float av[4] = {j0 <= r0 ? exp2_approx(c0 - e0) * st.l[r0][j0] : 0.f,
                               j0 <= r8 ? exp2_approx(c8 - e0) * st.l[r8][j0] : 0.f,
                               j4 <= r0 ? exp2_approx(c0 - e4) * st.l[r0][j4] : 0.f,
                               j4 <= r8 ? exp2_approx(c8 - e4) * st.l[r8][j4] : 0.f};
          uint32_t ah[4], al[4];
          repro::split_a(av, ah, al);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = 8 * (2 * kh + q) + gq;
            const uint32_t bh_[2] = {__float_as_uint(st.x[kk + tq][col]),
                                     __float_as_uint(st.x[kk + tq + 4][col])};
            const uint32_t bl_[2] = {__float_as_uint(sm.xlo[kk + tq][col]),
                                     __float_as_uint(sm.xlo[kk + tq + 4][col])};
            repro::mma_3xtf32_into(t2[q], ah, al, bh_, bl_);
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) ya[q][e] += t2[q][e];
      }
      // Each store instruction writes whole 32-byte sectors: 8 rows x 4 lanes
      // x 8 bytes (float2 where P is even, which vec4 promises).
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = p_base + 8 * (2 * kh + q) + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = i0 + gq + 8 * hf;
          if (i < len) {
            float* out = yr + static_cast<size_t>(t0 + i) * P + p;
            if (vec4 && p < P) {
              *reinterpret_cast<float2*>(out) = make_float2(ya[q][2 * hf], ya[q][2 * hf + 1]);
            } else {
              if (p < P) out[0] = ya[q][2 * hf];
              if (p + 1 < P) out[1] = ya[q][2 * hf + 1];
            }
          }
        }
      }
    } else if (owns_state) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 8 * q + 2 * tq;
        *reinterpret_cast<float2*>(&sm.h[n0 + gq][col]) = make_float2(hacc[q][0], hacc[q][1]);
        *reinterpret_cast<float2*>(&sm.h[n0 + gq + 8][col]) = make_float2(hacc[q][2], hacc[q][3]);
      }
    }
  }

  if (h_out != nullptr && owns_state) {
    float* hr = h_out + static_cast<size_t>(bh) * N * P;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p_base + 8 * q + 2 * tq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + gq + 8 * hf;
        if (n < N) {
          if (p < P) hr[static_cast<size_t>(n) * P + p] = hacc[q][2 * hf];
          if (p + 1 < P) hr[static_cast<size_t>(n) * P + p + 1] = hacc[q][2 * hf + 1];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Scratch floats the launch needs: scores (G, tiles, 64, 64) then sums
// (BH, tiles * 64).
long long repro_ssd_scan_scratch(int BH, int S, int G) {
  const long long tiles = (S + T - 1) / T;
  return tiles * T * (static_cast<long long>(G) * T + BH);
}

// Launches both kernels on `stream`; returns the launch's cudaError_t.  x, y
// (BH, S, P), da (BH, S), b, c (BH / heads_per_group, S, N), h0 (the state
// before position 0) and h_out (BH, N, P) or null, scratch as
// repro_ssd_scan_scratch says; all contiguous float32; S >= 1.  vec4 != 0
// promises N and P multiples of 4 and 16-byte aligned x, b, c.
int repro_ssd_scan(const void* x, const void* da, const void* b, const void* c, const void* h0,
                   void* y, void* h_out, void* scratch, int BH, int S, int P, int N,
                   int heads_per_group, int vec4, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || P < 1 || N < 1 || N > NMAX || heads_per_group < 1 ||
      BH % heads_per_group)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (S + T - 1) / T;
  const int G = BH / heads_per_group;
  const int np = (N + 31) / 32 * 32;  // two halves of whole k-step pairs
  float* cb = static_cast<float*>(scratch);
  float* cum = cb + static_cast<size_t>(G) * n_tiles * T * T;
  const int psmem = static_cast<int>(sizeof(PrepSmem));
  static repro::SmemOptIn prep_opt_in, scan_opt_in;
  cudaError_t err = prep_opt_in.need(ssd_prep_kernel, psmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_prep_kernel<<<dim3(n_tiles, G), kPrepThreads, psmem, st>>>(
      static_cast<const float*>(da), static_cast<const float*>(b), static_cast<const float*>(c),
      cb, cum, S, N, np, heads_per_group, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(sizeof(Smem));
  err = scan_opt_in.need(ssd_scan_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<dim3((P + PT - 1) / PT, BH), kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(b), static_cast<const float*>(c),
      cb, cum, static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), S, P, N, np,
      heads_per_group, n_tiles, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
