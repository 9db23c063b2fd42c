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
// in (d2 <= 128) stays below the card's operations-per-byte balance.
//
// Two routes, chosen from d2 alone (svt_subspace.py::route):
//
// Tensor route, 1 <= d2 <= 128 (every cohort the main paths run).  d2 is
// padded with zeros to DN in {8, 16, 32, 48, 64, 96, 128}, one template
// instance each.  A block owns one group of rows of one module and walks
// it in tiles of R = 64 rows (32 when DN > 64):
//   - M, S and Y of the next tile are copied into a two-stage shared ring
//     by cp.async while the current tile computes, so each byte is read
//     from device memory once and the loads stay in flight;
//   - X is formed in shared memory (row stride DN + 4: the A fragments of
//     mma.m16n8k8 read 32 distinct banks);
//   - L = X P and the Gram X'^T X' run on the tensor cores in 3xTF32
//     (tf32x3.cuh): about 2^-20 of |x p| per product, each k-step's three
//     passes summed in a fresh fragment and added in fp32, where one TF32
//     pass would keep 11 bits.  P, zero-padded
//     (row stride DM + 8), stays in shared memory for the block's lifetime,
//     split into its TF32 halves once when DN <= 64;
//   - the tail reads M and Y from the ring and L from shared memory, four
//     elements a thread where d2 allows float4s, and writes L, S', Y' with
//     coalesced stores and X' into the buffer L came from (each element
//     read, then overwritten, by the same thread);
//   - G' = X'^T X' is symmetric, so only its m16 x n8 tiles on or above
//     the diagonal are formed, and the finish mirrors them.  Up to
//     DN = 64 each warp takes one 8-row k-step of every such tile, so each
//     X' fragment is split once; the warps' sums stay in the accumulator
//     fragments across all of the block's tiles and are added in warp
//     order once at the end.  Wider, each warp owns a share of the tiles.
// Four __syncthreads a tile.  At (48, 4096, 40) the padded width is 48 and
// a block takes 108 KB of shared memory, two blocks an SM, and the launch
// sizes its row groups so that every block is resident in one wave.
//
// Scalar route, d2 > 128 (wider than the tensor route's templates).  A
// block stages 32-row tiles of X in shared memory, forms L against P
// staged in column tiles of at most 128, and adds the tile's X'^T X' into
// its Gram partial in global memory; both products are fp32 FMA loops.
//
// The TPU kernel carried the residual sum and the Gram across its
// sequential inner grid axis.  Blocks here run in no order, so each block
// keeps a private Gram partial (B, n_groups, d2, d2) and residual partial
// (B, n_groups) in scratch; a second kernel adds the groups of each module
// in group order.  No float atomics, and the tensor cores sum in a fixed
// order: the same inputs give the same bits on every launch.
#include <cuda_runtime.h>

#include "smem_opt_in.cuh"
#include "tail_common.cuh"
#include "tf32x3.cuh"

namespace {

using repro::kThreads;

// --- Tensor route -------------------------------------------------------------

// Upper tiles of G': the m16 x n8 tiles (mi, nj) with nj >= 2 mi, which
// cover every entry i <= j; the finish mirrors them into the lower half.
__host__ __device__ constexpr int upper_tiles(int gmt, int nt) {
  int c = 0;
  for (int mi = 0; mi < gmt; ++mi) c += nt - 2 * mi > 0 ? nt - 2 * mi : 0;
  return c;
}
// (mi, nj) of upper tile `idx`, row by row.
__host__ __device__ constexpr int upper_tile_mn(int idx, int nt) {
  int mi = 0;
  while (idx >= nt - 2 * mi) {
    idx -= nt - 2 * mi;
    ++mi;
  }
  return mi * 256 + 2 * mi + idx;  // mi * 256 + nj
}

template <int DN>
struct TcGeo {
  static constexpr int R = DN <= 64 ? 64 : 32;    // rows per tile
  static constexpr int DM = (DN + 15) / 16 * 16;  // G' rows, padded to the m16 tile
  static constexpr int SX = DN + 4;               // X row stride (= 4 mod 8)
  static constexpr int SW = DM + 8;               // P, L and X' row stride (= 8 mod 16)
  static constexpr int MT = R / 16;               // m16 tiles of L
  static constexpr int NG = 8 / MT;               // warps sharing one of them
  static constexpr int NT = DN / 8;               // n8 tiles of L and of G'
  static constexpr int NPW = (NT + NG - 1) / NG;  // n8 tiles of L a warp owns, at most
  static constexpr int GMT = DM / 16;             // m16 tiles of G'
  static constexpr int GTU = upper_tiles(GMT, NT);
  // Up to DN = 64 each warp takes one 8-row k-step of the tile for every
  // upper tile of G' (its A and B fragments split once a tile, the warps'
  // sums added in warp order at the end); wider, each warp takes every
  // k-step of its share of the tiles.
  static constexpr bool kSplitK = DN <= 64;
  static constexpr int KG = kSplitK ? 8 : 1;      // k-step groups (R / 8 = 8 when split)
  static constexpr int TG = 8 / KG;               // tile groups
  static constexpr int GPW = (GTU + TG - 1) / TG; // upper tiles a warp owns, at most
  // P split into TF32 hi / lo once a block (two arrays) up to DN = 64; wider
  // P is split as its fragments are read.
  static constexpr int PW = kSplitK ? 2 : 1;
  static constexpr int kBlocksPerSm = DN <= 48 ? 2 : 1;
};

// Shared floats of one block: the two-stage ring of M, S, Y tiles, P (or
// its hi and lo halves), X, the L / X' buffer, and the mask.
template <int DN>
constexpr long long tc_smem_floats(int d2) {
  using G = TcGeo<DN>;
  return 6LL * G::R * d2 + static_cast<long long>(G::PW) * DN * G::SW + G::R * G::SX +
         G::R * G::SW + DN;
}

// i / d for 0 <= i <= 8192, 1 <= d <= 128, by one float product: the
// quotient's fraction is at least 0.5 / d away from an integer, far more
// than the product's rounding.
__device__ __forceinline__ int div_small(int i, float inv_d) {
  return static_cast<int>((static_cast<float>(i) + 0.5f) * inv_d);
}

template <int DN>
__global__ void __launch_bounds__(kThreads, TcGeo<DN>::kBlocksPerSm)
subspace_apply_tc_kernel(const float* __restrict__ m, const float* __restrict__ s,
                         const float* __restrict__ y, const float* __restrict__ p,
                         const float* __restrict__ rho, const float* __restrict__ mu,
                         const float* __restrict__ thresh, const float* __restrict__ mask,
                         float* __restrict__ l_out, float* __restrict__ s_out,
                         float* __restrict__ y_out, float* __restrict__ r_part,
                         float* __restrict__ g_part, int vec, int d2, int group_rows,
                         int n_groups, int vec4) {
  using G = TcGeo<DN>;
  constexpr int R = G::R;
  constexpr int SX = G::SX, SW = G::SW;
  extern __shared__ __align__(16) float smem[];
  const int tile_elems = R * d2;
  float* ring = smem;                     // [2][3][R * d2]: M, S, Y of a tile
  float* ps = ring + 6 * tile_elems;      // [PW][DN][SW]  P (hi, lo), zero-padded
  float* xs = ps + G::PW * DN * SW;       // [R][SX]   X, columns past d2 zero
  float* ws = xs + R * SX;                // [R][SW]   L, then X' (columns past d2 zero)
  float* msk = ws + R * SW;               // [DN]

  const int grp = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gq = (tid & 31) >> 2;
  const int tq = tid & 3;
  const float r = rho[b];
  const float u = mu[b];
  const float t = thresh[b];
  const size_t mod = static_cast<size_t>(b) * vec * d2;
  const int row0 = grp * group_rows;
  const int row_end = min(row0 + group_rows, vec);
  const int n_tiles = (row_end - row0 + R - 1) / R;
  const bool v4 = vec4 && (d2 & 3) == 0;  // whole float4s of one row
  const float inv_d2 = 1.f / static_cast<float>(d2);

  // Tile `it` of this group into ring stage it % 2: 16-byte copies where
  // the bucket allows them (every tile then starts 16-byte aligned), 4-byte
  // copies for the rest.
  auto load_tile = [&](int it) {
    const int rt = row0 + it * R;
    const int cnt = min(R, row_end - rt) * d2;
    const size_t off = mod + static_cast<size_t>(rt) * d2;
    float* dst = ring + (it & 1) * 3 * tile_elems;
    const float* srcs[3] = {m + off, s + off, y + off};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float* d = dst + a * tile_elems;
      const float* src = srcs[a];
      int done = 0;
      if (vec4) {
        const int nv = cnt >> 2;
        for (int i = tid; i < nv; i += kThreads) repro::cp_async16(d + 4 * i, src + 4 * i);
        done = nv << 2;
      }
      for (int i = done + tid; i < cnt; i += kThreads) repro::cp_async4(d + i, src + i);
    }
    repro::cp_async_commit();
  };

  load_tile(0);
  const float* pb = p + static_cast<size_t>(b) * d2 * d2;
  for (int i = tid; i < DN * SW; i += kThreads) {
    const int k = i / SW, j = i - k * SW;
    const float v = (k < d2 && j < d2) ? pb[k * d2 + j] : 0.f;
    if constexpr (G::PW == 2) {
      uint32_t hi, lo;
      repro::split_tf32(v, hi, lo);
      ps[i] = __uint_as_float(hi);
      ps[DN * SW + i] = __uint_as_float(lo);
    } else {
      ps[i] = v;
    }
  }
  for (int i = tid; i < R * SX; i += kThreads) xs[i] = 0.f;
  for (int i = tid; i < R * SW; i += kThreads) ws[i] = 0.f;
  for (int j = tid; j < DN; j += kThreads) msk[j] = j < d2 ? mask[j] : 0.f;

  const int kg = warp % G::KG;  // this warp's k-steps of the Gram: kg, kg + KG, ...
  const int tg = warp / G::KG;  // and its upper tiles: tg, tg + TG, ...
  float gacc[G::GPW][4];
#pragma unroll
  for (int q = 0; q < G::GPW; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[q][e] = 0.f;
  float acc_r = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int rt = row0 + it * R;
    const int nrows = min(R, row_end - rt);
    if (it + 1 < n_tiles) {
      load_tile(it + 1);  // its stage was last read by tile it - 1's tail
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed; the init stores are visible
    const float* tm = ring + (it & 1) * 3 * tile_elems;
    const float* ts = tm + tile_elems;
    const float* ty = ts + tile_elems;

    if (v4) {
      for (int i = 4 * tid; i < nrows * d2; i += 4 * kThreads) {
        const int rr = div_small(i, inv_d2), c = i - rr * d2;
        const float4 a = *reinterpret_cast<const float4*>(tm + i);
        const float4 e = *reinterpret_cast<const float4*>(ts + i);
        const float4 f = *reinterpret_cast<const float4*>(ty + i);
        *reinterpret_cast<float4*>(xs + rr * SX + c) =
            make_float4(a.x - e.x + r * f.x, a.y - e.y + r * f.y, a.z - e.z + r * f.z,
                        a.w - e.w + r * f.w);
      }
    } else {
      for (int i = tid; i < nrows * d2; i += kThreads) {
        const int rr = div_small(i, inv_d2), c = i - rr * d2;
        xs[rr * SX + c] = tm[i] - ts[i] + r * ty[i];
      }
    }
    __syncthreads();  // X is complete

    // L = X P: warp w owns rows 16 (w % MT) .. + 16 and n8 tiles w / MT,
    // w / MT + NG, ...
    {
      const int r0 = 16 * (warp % G::MT);
      const int ng = warp / G::MT;
      float acc[G::NPW][4];
#pragma unroll
      for (int q = 0; q < G::NPW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < DN; k0 += 8) {
        const float* x0 = xs + (r0 + gq) * SX + k0 + tq;
        const float* x8 = x0 + 8 * SX;
        const float av[4] = {x0[0], x8[0], x0[4], x8[4]};
        uint32_t ah[4], al[4];
        repro::split_a(av, ah, al);
        const float* p0 = ps + (k0 + tq) * SW + gq;
#pragma unroll
        for (int q = 0; q < G::NPW; ++q) {
          const int nt = ng + q * G::NG;
          if (nt < G::NT) {
            uint32_t bh[2], bl[2];
            if constexpr (G::PW == 2) {
              bh[0] = __float_as_uint(p0[8 * nt]);
              bh[1] = __float_as_uint(p0[4 * SW + 8 * nt]);
              bl[0] = __float_as_uint(p0[DN * SW + 8 * nt]);
              bl[1] = __float_as_uint(p0[DN * SW + 4 * SW + 8 * nt]);
            } else {
              repro::split_b(p0[8 * nt], p0[4 * SW + 8 * nt], bh, bl);
            }
            repro::mma_3xtf32(acc[q], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < G::NPW; ++q) {
        const int nt = ng + q * G::NG;
        if (nt < G::NT) {
          float* w0 = ws + (r0 + gq) * SW + 8 * nt + 2 * tq;
          *reinterpret_cast<float2*>(w0) = make_float2(acc[q][0], acc[q][1]);
          *reinterpret_cast<float2*>(w0 + 8 * SW) = make_float2(acc[q][2], acc[q][3]);
        }
      }
    }
    __syncthreads();  // L is complete

    // The tail in row-major order; X' replaces L in place (each element read,
    // then written, by one thread).  Rows past the tile's end get X' = 0 and
    // add nothing to G'.
    const size_t tile0 = mod + static_cast<size_t>(rt) * d2;
    if (v4) {
      for (int i = 4 * tid; i < R * d2; i += 4 * kThreads) {
        const int rr = div_small(i, inv_d2), c = i - rr * d2;
        float4* wp = reinterpret_cast<float4*>(ws + rr * SW + c);
        float4 xn = make_float4(0.f, 0.f, 0.f, 0.f);
        if (rr < nrows) {
          const float4 mv = *reinterpret_cast<const float4*>(tm + i);
          const float4 yv = *reinterpret_cast<const float4*>(ty + i);
          const float4 lv = *wp;
          const float4 mk = *reinterpret_cast<const float4*>(msk + c);
          float4 sv, yn;
#define REPRO_TAIL(q)                                                  \
  {                                                                    \
    sv.q = repro::shrink(mv.q - lv.q + r * yv.q, t) * mk.q;            \
    const float res = (mv.q - lv.q - sv.q) * mk.q;                     \
    yn.q = (yv.q + u * res) * mk.q;                                    \
    acc_r += res * res;                                                \
    xn.q = mv.q - sv.q + r * yn.q;                                     \
  }
          REPRO_TAIL(x) REPRO_TAIL(y) REPRO_TAIL(z) REPRO_TAIL(w)
#undef REPRO_TAIL
          *reinterpret_cast<float4*>(l_out + tile0 + i) = lv;
          *reinterpret_cast<float4*>(s_out + tile0 + i) = sv;
          *reinterpret_cast<float4*>(y_out + tile0 + i) = yn;
        }
        *wp = xn;
      }
    } else {
      for (int i = tid; i < R * d2; i += kThreads) {
        const int rr = div_small(i, inv_d2), c = i - rr * d2;
        float* wp = ws + rr * SW + c;
        float xn = 0.f;
        if (rr < nrows) {
          const float mv = tm[i];
          const float yv = ty[i];
          const float lv = *wp;
          const float mk = msk[c];
          const float sv = repro::shrink(mv - lv + r * yv, t) * mk;
          const float res = (mv - lv - sv) * mk;
          const float yn = (yv + u * res) * mk;
          l_out[tile0 + i] = lv;
          s_out[tile0 + i] = sv;
          y_out[tile0 + i] = yn;
          acc_r += res * res;
          xn = mv - sv + r * yn;
        }
        *wp = xn;
      }
    }
    __syncthreads();  // X' is complete

    // G' += X'^T X' over the upper tiles.
    for (int ks = kg; ks < R / 8; ks += G::KG) {
      const float* w0 = ws + (8 * ks + tq) * SW + gq;
      const float* w4 = w0 + 4 * SW;
      if constexpr (G::kSplitK) {
        // Every upper tile, row of tiles by row: each A fragment split once.
        int q = 0;  // a constant once the loops unroll: gacc stays in registers
#pragma unroll
        for (int mi = 0; mi < G::GMT; ++mi) {
          if (2 * mi < G::NT) {
            const int i0 = 16 * mi;
            const float av[4] = {w0[i0], w0[i0 + 8], w4[i0], w4[i0 + 8]};
            uint32_t ah[4], al[4];
            repro::split_a(av, ah, al);
#pragma unroll
            for (int nj = 2 * mi; nj < G::NT; ++nj) {
              uint32_t bh[2], bl[2];
              repro::split_b(w0[8 * nj], w4[8 * nj], bh, bl);
              repro::mma_3xtf32(gacc[q++], ah, al, bh, bl);
            }
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < G::GPW; ++q) {
          const int tile = tg + G::TG * q;
          if (tile < G::GTU) {
            const int mn = upper_tile_mn(tile, G::NT);
            const int i0 = 16 * (mn >> 8), j0 = 8 * (mn & 255);
            const float av[4] = {w0[i0], w0[i0 + 8], w4[i0], w4[i0 + 8]};
            uint32_t ah[4], al[4], bh[2], bl[2];
            repro::split_a(av, ah, al);
            repro::split_b(w0[j0], w4[j0], bh, bl);
            repro::mma_3xtf32(gacc[q], ah, al, bh, bl);
          }
        }
      }
    }
  }

  // The block's Gram partial, upper entries i <= j < d2 (the finish mirrors
  // them).  Split-k warps first add their sums into ws in warp order.
  float* gp = g_part + (static_cast<size_t>(b) * n_groups + grp) * d2 * d2;
  if constexpr (G::kSplitK) {
#pragma unroll 1
    for (int w = 0; w < 8; ++w) {
      __syncthreads();  // the previous warp's adds (and the last Gram reads) are done
      if (warp == w) {
        int q = 0;
#pragma unroll
        for (int mi = 0; mi < G::GMT; ++mi) {
#pragma unroll
          for (int nj = 2 * mi; nj < G::NT; ++nj, ++q) {
            const int i = 16 * mi + gq, j = 8 * nj + 2 * tq;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* dst = ws + (i + 8 * (e >> 1)) * SW + j + (e & 1);
              *dst = w == 0 ? gacc[q][e] : *dst + gacc[q][e];
            }
          }
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < d2 * d2; idx += kThreads) {
      const int i = div_small(idx, inv_d2), j = idx - i * d2;
      if (i <= j) gp[idx] = ws[i * SW + j];
    }
  } else {
#pragma unroll
    for (int q = 0; q < G::GPW; ++q) {
      const int tile = tg + G::TG * q;
      if (tile < G::GTU) {
        const int mn = upper_tile_mn(tile, G::NT);
        const int i = 16 * (mn >> 8) + gq, j = 8 * (mn & 255) + 2 * tq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ie = i + 8 * (e >> 1), je = j + (e & 1);
          if (ie <= je && je < d2) gp[ie * d2 + je] = gacc[q][e];
        }
      }
    }
  }
  const float total = repro::block_sum(acc_r);
  if (tid == 0) r_part[static_cast<size_t>(b) * n_groups + grp] = total;
}

// --- Scalar route ---------------------------------------------------------------

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
// in group order.  Only the partials' entries i <= j are read; G' is
// their mirror, exactly symmetric.
__global__ void subspace_apply_finish(const float* __restrict__ r_part,
                                      const float* __restrict__ g_part,
                                      float* __restrict__ rsq,
                                      float* __restrict__ g_out, int d2,
                                      int n_groups) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t dd = static_cast<size_t>(d2) * d2;
  if (idx < static_cast<int>(dd)) {
    const int i = idx / d2, j = idx - (idx / d2) * d2;
    const int up = i <= j ? idx : j * d2 + i;
    const float* src = g_part + static_cast<size_t>(b) * n_groups * dd + up;
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

// G' and rsq from the partials, on the same stream.
int launch_finish(const float* r_part, const float* g_part, float* rsq, float* g_out,
                  int n_modules, int d2, int n_groups, cudaStream_t st) {
  const int dd = d2 * d2;
  dim3 grid((dd + kThreads - 1) / kThreads, n_modules);
  subspace_apply_finish<<<grid, kThreads, 0, st>>>(r_part, g_part, rsq, g_out, d2, n_groups);
  return static_cast<int>(cudaGetLastError());
}

template <int DN>
int launch_tc(const float* m, const float* s, const float* y, const float* p,
              const float* rho, const float* mu, const float* thresh, const float* mask,
              float* l_out, float* s_out, float* y_out, float* r_part, float* g_part,
              int n_modules, int vec, int d2, int group_rows, int n_groups, int vec4,
              cudaStream_t st) {
  const int smem = static_cast<int>(4 * tc_smem_floats<DN>(d2));
  static repro::SmemOptIn opt_in;
  cudaError_t err = opt_in.need(subspace_apply_tc_kernel<DN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  subspace_apply_tc_kernel<DN><<<dim3(n_groups, n_modules), kThreads, smem, st>>>(
      m, s, y, p, rho, mu, thresh, mask, l_out, s_out, y_out, r_part, g_part, vec, d2,
      group_rows, n_groups, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block for this tiling.
long long repro_subspace_apply_smem(int d2, int tile_rows, int pcols) {
  return 4LL * (2LL * tile_rows * d2 + static_cast<long long>(d2) * pcols + d2);
}

// Launches the scalar route and the finish on `stream`; returns the
// launch's cudaError_t.  Scratch: r_part (n_modules, n_groups), g_part
// (n_modules, n_groups, d2, d2).
int repro_subspace_apply(const float* m, const float* s, const float* y,
                         const float* p, const float* rho, const float* mu,
                         const float* thresh, const float* mask, float* l_out,
                         float* s_out, float* y_out, float* r_part,
                         float* g_part, float* rsq, float* g_out, int n_modules,
                         int vec, int d2, int tile_rows, int pcols,
                         int group_rows, int n_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(repro_subspace_apply_smem(d2, tile_rows, pcols));
  static repro::SmemOptIn opt_in;
  cudaError_t err = opt_in.need(subspace_apply_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_groups, n_modules);
  subspace_apply_kernel<<<grid, kThreads, smem, st>>>(
      m, s, y, p, rho, mu, thresh, mask, l_out, s_out, y_out, r_part, g_part,
      vec, d2, tile_rows, pcols, group_rows, n_groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_finish(r_part, g_part, rsq, g_out, n_modules, d2, n_groups, st);
}

// Launches the tensor route (padded width dn, d2 <= dn) and the finish on
// `stream`; returns the launch's cudaError_t.  vec4 != 0 promises 16-byte
// aligned M, S, Y and vec * d2 a multiple of 4.  Scratch as above.
int repro_subspace_apply_tc(const float* m, const float* s, const float* y, const float* p,
                            const float* rho, const float* mu, const float* thresh,
                            const float* mask, float* l_out, float* s_out, float* y_out,
                            float* r_part, float* g_part, float* rsq, float* g_out,
                            int n_modules, int vec, int d2, int dn, int group_rows,
                            int n_groups, int vec4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d2 < 1 || d2 > dn || n_groups < 1 || n_modules < 1 || n_modules > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
#define REPRO_TC_CASE(W)                                                                \
  case W:                                                                               \
    err = launch_tc<W>(m, s, y, p, rho, mu, thresh, mask, l_out, s_out, y_out, r_part, \
                       g_part, n_modules, vec, d2, group_rows, n_groups, vec4, st);    \
    break;
  switch (dn) {
    REPRO_TC_CASE(8)
    REPRO_TC_CASE(16)
    REPRO_TC_CASE(32)
    REPRO_TC_CASE(48)
    REPRO_TC_CASE(64)
    REPRO_TC_CASE(96)
    REPRO_TC_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_TC_CASE
  if (err != 0) return err;
  return launch_finish(r_part, g_part, rsq, g_out, n_modules, d2, n_groups, st);
}

}  // extern "C"
