// Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan.
// Per (batch*head) row of x (BH, S, P), log-decays da (BH, S) and the
// grouped B, C (G, S, N) (row bh reads group bh / (BH / G)):
//
//   h_t = exp(da_t) h_{t-1} + B_t^T x_t        (h is N x P, h_0 = 0 or h0)
//   y_t = C_t h_t
//
// evaluated in tiles of T = 64 positions, with cum the inclusive sum of da
// inside the tile, split into a half that does not read h and one that does:
//
//   h-free:  y_intra = (L o C B^T) x,  L_ij = exp(cum_i - cum_j) for j <= i
//            s       = (B o w)^T x,    w_j  = exp(cum_last - cum_j)
//   h-bound: y       = exp(cum_i) C h + y_intra
//            h      <- exp(cum_last) h + s
//
// In exact arithmetic the result does not depend on the tile length, so the
// tile is smaller than the model's chunk of 256: only the rounding differs.
// The final h (BH, N, P) is written when asked (prefill hands it to decode),
// and the state before position 0 is read from h0 (BH, N, P) when one is
// given (the model's h_init), else zero.
//
// Bound: at prefill, (BH, S, P, N) = (192, 512, 64, 128), the tile-64
// algorithm needs 3.66 GFLOP (chip_smoke.py::ssd_work: the scores once per
// group, intra with the upper triangle skipped, inter and carry), which in
// 3xTF32 (three TF32 passes at 495 / 3 = 165 TFLOP/s) take 0.022 ms, against
// 61 MB of operands (x and y 25 MB each, the final state 6 MB) at 3.35 TB/s,
// 0.018 ms: the operations bind.  The serial part is only the carry, an
// elementwise scale-and-add of h a tile; everything else is independent from
// tile to tile.
//
// Design: two kernels a call.
//
//   ssd_prep: two blocks (one warpgroup each) per (tile, group), each
//   forming half the columns of the raw score tile C B^T (64 x 32, K = N)
//   once for the group, not once for each of its heads and column blocks
//   (48 at prefill), as wgmma m64n32k8 in 3xTF32 (C from registers, B split
//   into its TF32 halves in shared memory), and the inclusive sums of da
//   (in log2 units, for ex2) of half the group's heads (every other one, 32
//   a pass over the block's four warps, as many passes as the group needs).
//   All its copies are in flight at once (cp.async).  Scratch: (G, tiles,
//   64, 64) scores, 1 MB at prefill, and (BH, tiles * 64) sums.
//
//   ssd_scan, launched as ssd_prep's programmatic dependent (its blocks set
//   up while ssd_prep finishes; griddepcontrol.wait holds its loads): the
//   work items are (row bh, 32 columns of P) pairs, since the recurrence
//   for column p of h and y reads column p of x only, 384 at prefill.  A
//   block's 230,992 bytes of shared memory leave room for one block an SM,
//   so the grid is one persistent block an SM, each walking the items
//   blockIdx.x + k gridDim.x (neighbouring blocks take heads of one group,
//   whose B, C and scores L2 then serves): 384 items on 132 SMs are 2.91
//   rounds, the last 91% full (the I2 training shape, 768 items, 5.82
//   rounds, the last 82% full).  The rings run on from item to item, so an
//   item's first tiles load and start under the last one's end.  Three
//   warpgroups:
//     - the producer (setmaxnreg down to 56 registers) keeps two rings of
//       two stages filled: the "free" ring of B, x, the score tile and the
//       sums of a tile, and the "bound" ring of C; one thread issues TMA
//       loads (cp.async.bulk.tensor, 128-byte swizzled boxes of 32 floats a
//       row, rows past S and columns past N or P read as zero) on
//       mbarriers.  Where a row stride is not a multiple of 16 bytes (N or P
//       not a multiple of 4) TMA cannot take the tensor, and one warp copies
//       the same boxes into the same swizzled layout with 4-byte cp.async
//       (zero-filled past the edges) instead: one kernel, one consumer code.
//     - the h-free warpgroup runs tile k + 1's h-free half while the
//       h-bound one runs tile k: it transposes x into x^T (the K-major B
//       operand that TF32 wgmma needs, since only f16 / bf16 have the
//       transpose bit) split into TF32 hi and lo, then issues intra
//       (m64n32k8, A = L o C B^T decayed in registers) and s (two m64n32k8
//       halves of N, A = (B o w)^T in registers), and hands y_intra and s to
//       the other warpgroup through the stage it has used up (B's and the
//       scores' space), in the accumulators' own layout.
//     - the h-bound warpgroup keeps h in registers (the accumulator layout
//       of two m64n32 tiles), mirrored as h^T hi and lo in shared memory for
//       inter (m64n32k8, A = C from registers, B = h^T, K = N).  Per tile it
//       reads the hand-off, frees the stage, adds s into h, issues inter on
//       the h^T of the previous tile, scales by exp(cum_i), adds y_intra and
//       stores y, then writes the new h^T.
//   Every product is wgmma.mma_async ... .tf32 in three passes (lo hi, hi lo,
//   hi hi: the small terms first), with A split in registers and B's halves
//   in shared memory, built four k-steps at a time into one of two register
//   sets (the next chunk's loads and splits run under this one's products).
//   The split rounds to TF32 by integer arithmetic (split_rn: the bits of
//   cvt.rna, at the full ALU rate).  A product's passes accumulate into a
//   fresh accumulator of its own each tile (scale-d 0 on its first pass),
//   summed with the others in fp32 by ordinary adds (y_intra + exp(cum)
//   inter, h + s): at most 48 truncating passes (inter, K = 128) share an
//   accumulator, about 6e-6 of its magnitude, against the 1e-4 the checks
//   allow (y within 1e-5 of its largest entry at row 8 on the card).
//
// What holds it (tools/ssd_scan_breakdown.py --clock, H100 80GB HBM3,
// 700 W): a tile-step takes about 3 us (the slope of time against S at one
// round), and each consumer warpgroup about 5,000 clock64 cycles of it, of
// which its issue phase (48 or 72 products with their operand builds) is
// about 3,200.  The 120 products of a tile need about 1 us of an SM's TF32
// rate: the warpgroups' operand builds, x's transpose and h^T's writes do
// not overlap their own products' issue.  The first pass is about 8% of a
// call.
//
// The decay of the upper triangle (i < j) is exp of a positive number and
// would overflow: those entries are selected to 0, never multiplied by a
// mask.  Positions past S take da = 0 and B = C = x = 0, as the TPU kernel
// pads them, and are not stored.  Each output is written by one thread, the
// tensor cores sum in a fixed order and there are no atomics: two launches
// give the same bits.
#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "smem_opt_in.cuh"
#include "tf32x3.cuh"
#include "wgmma_tma.cuh"

namespace {

using namespace repro;

constexpr int T = 64;     // positions per tile
constexpr int NMAX = 128; // largest state width N
constexpr int PT = 32;    // columns of P a work item takes
constexpr int kThreads = 384;     // h-bound, h-free and producer warpgroups
constexpr int kPrepThreads = 128; // one warpgroup
constexpr int kProducerRegs = 56, kConsumerRegs = 224;  // 4 x 56 + 8 x 224 = 12 x 168
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, bytes from a 1024-aligned base.  A "box" is rows of 32
// floats (128 bytes, the 128-byte swizzle): 64 rows (kBox64) or 32 (kBox32).
constexpr int kBox64 = T * 128;
constexpr int kBox32 = PT * 128;
// A stage of the free ring: B (4 boxes [64 j][32 n]), x ([64 j][32 p], then
// x^T hi as 2 boxes [32 p][32 j]), the scores (2 boxes [64 i][32 j]); the
// stage's x^T lo (2 boxes [32 p][32 j]) and sums (64 floats) lie apart.  The
// hand-off reuses B's space (s) and the scores' (y_intra).
constexpr int kFB = 0;
constexpr int kFX = 4 * kBox64;
constexpr int kFL = kFX + kBox64;
constexpr int kFStage = kFL + 2 * kBox64;
// A stage of the bound ring: C (4 boxes [64 i][32 n]).
constexpr int kHStage = 4 * kBox64;
constexpr int kOffH = 2 * kFStage;
constexpr int kOffXlo = kOffH + 2 * kHStage;  // x^T lo of each free stage
constexpr int kOffHT = kOffXlo + 2 * 2 * kBox32;  // h^T hi: 4 boxes [32 p][32 n]; lo after it
constexpr int kOffCum = kOffHT + 8 * kBox32;      // the sums of each free stage
constexpr int kOffBar = kOffCum + 2 * T * 4;
constexpr int kBars = 10;  // full / empty of each ring's two stages, hand-off of the free ring's
constexpr int kSmem = 1024 + kOffBar + 8 * kBars;
static_assert(kSmem == 230992, "kernels/ssd_scan.py SCAN_SMEM");
static_assert(kSmem <= 232448, "a block's shared memory on the H100");
// ssd_prep: C [64][132] floats, half a tile of B as loaded [32][128], then
// its hi and lo, 4 boxes [32 j][32 n] each.
constexpr int SC = NMAX + 4;
constexpr int kPrepRaw = 34 * 1024;
constexpr int kPrepBhi = kPrepRaw + 32 * NMAX * 4;
constexpr int kPrepBlo = kPrepBhi + 4 * kBox32;
constexpr int kPrepSmem = 1024 + kPrepBlo + 4 * kBox32;
static_assert(T * SC * 4 <= kPrepRaw, "ssd_prep layout");

// Barrier slots: free ring full 0-1, empty 2-3, hand-off 4-5; bound ring
// full 6-7, empty 8-9.
constexpr int kFullF = 0, kEmptyF = 2, kHandoff = 4, kFullH = 6, kEmptyH = 8;

// Byte offset of element (r, c), c < 32, of a box with the 128-byte swizzle
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B and the wgmma descriptor's): the 16-byte
// chunk index XORed with the row mod 8.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ float lds(const uint8_t* p, uint32_t off) {
  return *reinterpret_cast<const float*>(p + off);
}
__device__ __forceinline__ void sts(uint8_t* p, uint32_t off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p + off) = v;
}

// 2^x by the SFU (ex2.approx, about 2^-22 relative): every decay is
// exp(a) = 2^(a log2 e), with the sums of da kept in log2 units.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// The A operand of four k-steps, split: hi[u] and lo[u] are k-step u's
// m16n8k8-layout fragments (rows g, g + 8; columns t, t + 4).
struct Frag {
  uint32_t hi[4][4], lo[4][4];
};

// x = hi + lo exactly, hi = x rounded to TF32 (nearest, ties away from
// zero: the bits of cvt.rna.tf32.f32 for every finite x) by integer
// arithmetic, which runs at the full ALU rate where the conversion does
// not; lo goes to the tensor cores as its fp32 bits (tf32x3.cuh).
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_rn(v[e], hi[e], lo[e]);
}

// Keeps a chunk's A registers live (and unmoved) until the wait that covers
// the products reading them.
__device__ __forceinline__ void fence_frag(Frag& a) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a.hi[u][e]), "+r"(a.lo[u][e])::"memory");
}

// Issues four k-steps (kk0 .. kk0 + 3) of acc += A B in 3xTF32: B's halves
// K-major in shared memory at b_hi / b_lo, boxes of 32 rows (the N dim) x 32
// K-values; a k-step is 32 bytes along a box row, four of them a box.
__device__ __forceinline__ void issue4(float (&acc)[16], const Frag& a, uint32_t b_hi,
                                       uint32_t b_lo, int kk0, bool fresh) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int kk = kk0 + u;
    const uint32_t off = (kk >> 2) * kBox32 + (kk & 3) * 32;
    const uint64_t dh = smem_desc(b_hi + off, 16, 1024), dl = smem_desc(b_lo + off, 16, 1024);
    wgmma_tf32_rs(acc, a.lo[u], dh, fresh && u == 0 ? 0 : 1);
    wgmma_tf32_rs(acc, a.hi[u], dl, 1);
    wgmma_tf32_rs(acc, a.hi[u], dh, 1);
  }
}

// Scores and sums of one (tile, group, half of the tile's key rows j): a
// block forms columns [32 jb, 32 jb + 32) of the tile's C B^T and the sums of
// the group's heads hh = jb (mod 2).
__global__ void __launch_bounds__(kPrepThreads)
ssd_prep_kernel(const float* __restrict__ da, const float* __restrict__ b,
                const float* __restrict__ c, float* __restrict__ cb, float* __restrict__ cum,
                int S, int N, int nbox, int heads_per_group, int vec4) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  float (*cs)[SC] = reinterpret_cast<float (*)[SC]>(base);
  float (*braw)[NMAX] = reinterpret_cast<float (*)[NMAX]>(base + kPrepRaw);
  const int tile = blockIdx.x, n_tiles = gridDim.x, grp = blockIdx.y, jb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int t0 = tile * T, len = min(T, S - t0);
  const int np = 32 * nbox;
  const float* cr = c + static_cast<size_t>(grp) * S * N;
  const float* br = b + (static_cast<size_t>(grp) * S + 32 * jb) * N;
  const int blen = min(32, len - 32 * jb);  // B rows of this half inside S
  asm volatile("griddepcontrol.launch_dependents;");  // the scan may launch now
  // The sums of the group's heads hh = h_base + jb + 2 (warp + 4 k), 64 heads
  // a pass (h_base = 0, 64, ...), two positions a lane.  The first pass's da
  // loads are in flight while the copies are issued; further passes (more
  // than 64 heads a group) run after the products.
  constexpr int kHeads = 8, kHeadsPerPass = 2 * 4 * kHeads;
  const int s_pad = n_tiles * T;
  const int j0 = 2 * lane;
  auto head = [&](int h_base, int k) { return h_base + jb + 2 * (warp + 4 * k); };
  float d[kHeads][2];
  auto load_da = [&](int h_base) {
#pragma unroll
    for (int k = 0; k < kHeads; ++k) {
      const int hh = head(h_base, k);
      const float* dar = da + (static_cast<size_t>(grp) * heads_per_group + hh) * S + t0;
      d[k][0] = hh < heads_per_group && j0 < len ? dar[j0] * kLog2e : 0.f;
      d[k][1] = hh < heads_per_group && j0 + 1 < len ? dar[j0 + 1] * kLog2e : 0.f;
    }
  };
  // Inclusive sums of the loaded da across the warp's 64 positions.
  auto scan_da = [&]() {
#pragma unroll
    for (int k = 0; k < kHeads; ++k) {
      float s = d[k][0] + d[k][1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += v;
      }
      float prev = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) prev = 0.f;
      d[k][1] = prev + d[k][0] + d[k][1];
      d[k][0] = prev + d[k][0];
    }
  };
  auto store_sums = [&](int h_base) {
#pragma unroll
    for (int k = 0; k < kHeads; ++k) {
      const int hh = head(h_base, k);
      if (hh >= heads_per_group) break;
      float* out = cum + (static_cast<size_t>(grp) * heads_per_group + hh) * s_pad + t0;
      *reinterpret_cast<float2*>(out + j0) = make_float2(d[k][0], d[k][1]);
    }
  };
  load_da(0);
  // C (all 64 rows) and this half's 32 rows of B, np floats a row, zero past
  // S and past N: 16-byte cp.async where vec4 promises N a multiple of 4 and
  // aligned rows, else 4-byte.  Every copy is in flight at once.
  if (vec4) {
    const int n = 4 * lane;
    if (n < np) {
      const bool n_ok = n < N;
#pragma unroll 4
      for (int j = warp; j < T; j += 4) {
        const bool ok = n_ok && j < len;
        cp_async16(&cs[j][n], cr + (ok ? static_cast<size_t>(t0 + j) * N + n : 0), ok);
      }
#pragma unroll 4
      for (int j = warp; j < 32; j += 4) {
        const bool ok = n_ok && j < blen;
        cp_async16(&braw[j][n], br + (ok ? static_cast<size_t>(t0 + j) * N + n : 0), ok);
      }
    }
  } else {
    for (int e = tid; e < T * NMAX; e += kPrepThreads) {
      const int j = e >> 7, n = e & 127;
      if (n >= np) continue;
      const bool ok = j < len && n < N;
      cp_async4(&cs[j][n], cr + (ok ? static_cast<size_t>(t0 + j) * N + n : 0), ok);
      const bool bok = j < 32 && j < blen && n < N;
      if (j < 32) cp_async4(&braw[j][n], br + (bok ? static_cast<size_t>(t0 + j) * N + n : 0), bok);
    }
  }
  cp_async_commit();
  // The first pass's sums stay in registers until the proxy fence below has
  // passed (it would wait for stores issued before it).
  scan_da();
  cp_async_wait<0>();
  __syncthreads();
  // This half's B split into the K-major boxes [32 j][32 n] of the B operand.
  const int nb = tid & 127;
  if (nb < np) {
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      uint32_t hi, lo;
      split_rn(braw[j][nb], hi, lo);
      const uint32_t off = (nb >> 5) * kBox32 + swz(j, nb & 31);
      sts(base, kPrepBhi + off, hi);
      sts(base, kPrepBlo + off, lo);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  store_sums(0);

  // C B^T: M = i, N = j (this half's 32), K = n; A = C from registers, four
  // k-steps a chunk.
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  auto build = [&](Frag& a, int cbx) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n0 = 32 * cbx + 8 * u + t4, n1 = n0 + 4;
      const float v[4] = {cs[r0][n0], cs[r1][n0], cs[r0][n1], cs[r1][n1]};
      split4(v, a.hi[u], a.lo[u]);
    }
  };
  float acc[16];
  Frag fa, fb;
  auto step = [&](Frag& fr, int cbx) {
    if (cbx >= 2) {
      wgmma_wait<1>();  // the chunk before last, which read fr, is done
      fence_frag(fr);
    }
    build(fr, cbx);
    wgmma_fence();
    issue4(acc, fr, sbase + kPrepBhi, sbase + kPrepBlo, 4 * cbx, cbx == 0);
    wgmma_commit();
  };
  for (int cbx = 0; cbx < nbox; ++cbx) {
    if (cbx & 1)
      step(fb, cbx);
    else
      step(fa, cbx);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_frag(fa);
  fence_frag(fb);
  float* out = cb + (static_cast<size_t>(grp) * n_tiles + tile) * T * T + 32 * jb;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = 8 * jj + 2 * t4;
    *reinterpret_cast<float2*>(out + r0 * T + j) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
    *reinterpret_cast<float2*>(out + r1 * T + j) = make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
  // The sums of heads past the first 64 of the group.
  for (int h_base = kHeadsPerPass; h_base < heads_per_group; h_base += kHeadsPerPass) {
    load_da(h_base);
    scan_da();
    store_sums(h_base);
  }
}

struct ScanArgs {
  const float* x;
  const float* b;
  const float* c;
  const float* cb;
  const float* cum;
  const float* h0;
  float* y;
  float* h_out;
  int S, P, N, heads_per_group, n_tiles, nbox, use_tma;
  int n_pblk, n_items;  // column blocks a row, work items (bh, column block)
};

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c, const __grid_constant__ CUtensorMap tm_cb,
                const ScanArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const uint32_t bars = sbase + kOffBar;
  auto bar = [&](int i) { return bars + 8 * i; };
  const int nt = a.n_tiles, nbox = a.nbox;
  // The block's work items, idx = blockIdx.x + k gridDim.x, each a row bh
  // and a column block (idx = bh * n_pblk + column block: neighbouring
  // blocks take heads of one group, whose B, C and scores L2 then serves).
  // Every role walks them in the same order; the rings and their barrier
  // phases run on across items (q counts a role's tiles).
  struct Item {
    int bh, p_base, grp;
  };
  auto item = [&](int idx) {
    const int bh = idx / a.n_pblk;
    return Item{bh, (idx - bh * a.n_pblk) * PT, bh / a.heads_per_group};
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar(kFullF + s), 1);
      mbar_init(bar(kEmptyF + s), 4);
      mbar_init(bar(kHandoff + s), 4);
      mbar_init(bar(kFullH + s), 1);
      mbar_init(bar(kEmptyH + s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- Producer ---------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    // The scan is launched as ssd_prep's programmatic dependent: its blocks
    // may start while the first pass finishes, and only the loads wait for it.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int pwarp = (threadIdx.x >> 5) - 8, plane = threadIdx.x & 31;  // warps 1-3 idle
    if (pwarp == 0 && a.use_tma) {
      if (plane == 0) {
        const uint32_t f_bytes = (nbox + 3) * kBox64;
        int q = 0;
        for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x) {
          const Item it = item(idx);
          const int bh = it.bh, p_base = it.p_base, grp = it.grp;
          const float* cumr = a.cum + static_cast<size_t>(bh) * nt * T;
          for (int t = 0; t < nt; ++t, ++q) {
            const int s = q & 1;
            const uint32_t f = sbase + s * kFStage, h = sbase + kOffH + s * kHStage;
            if (q >= 2) mbar_wait(bar(kEmptyF + s), ((q >> 1) - 1) & 1);
            mbar_expect_tx(bar(kFullF + s), f_bytes + T * 4);
            for (int bx = 0; bx < nbox; ++bx)
              tma_load_3d(f + kFB + bx * kBox64, &tm_b, 32 * bx, t * T, grp, bar(kFullF + s));
            tma_load_3d(f + kFX, &tm_x, p_base, t * T, bh, bar(kFullF + s));
            for (int bx = 0; bx < 2; ++bx)
              tma_load_3d(f + kFL + bx * kBox64, &tm_cb, 32 * bx, t * T, grp, bar(kFullF + s));
            bulk_load(sbase + kOffCum + s * T * 4, cumr + t * T, T * 4, bar(kFullF + s));
            if (q >= 2) mbar_wait(bar(kEmptyH + s), ((q >> 1) - 1) & 1);
            mbar_expect_tx(bar(kFullH + s), nbox * kBox64);
            for (int bx = 0; bx < nbox; ++bx)
              tma_load_3d(h + bx * kBox64, &tm_c, 32 * bx, t * T, grp, bar(kFullH + s));
          }
        }
      }
    } else if (pwarp == 0) {
      // The same boxes by one warp's 4-byte cp.async (16-byte for the
      // scratch), every column of a box, zero past S, N and P.
      int q = 0;
      for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x) {
        const Item it = item(idx);
        const int bh = it.bh, p_base = it.p_base, grp = it.grp;
        const float* cumr = a.cum + static_cast<size_t>(bh) * nt * T;
        const float* xr = a.x + static_cast<size_t>(bh) * a.S * a.P;
        const float* br = a.b + static_cast<size_t>(grp) * a.S * a.N;
        const float* cr = a.c + static_cast<size_t>(grp) * a.S * a.N;
        for (int t = 0; t < nt; ++t, ++q) {
          const int s = q & 1, t0 = t * T, len = min(T, a.S - t0);
          uint8_t* f = base + s * kFStage;
          uint8_t* h = base + kOffH + s * kHStage;
          if (q >= 2) mbar_wait(bar(kEmptyF + s), ((q >> 1) - 1) & 1);
          for (int e = plane; e < T * NMAX; e += 32) {
            const int j = e >> 7, n = e & 127;
            const bool ok = j < len && n < a.N;
            cp_async4(f + kFB + (n >> 5) * kBox64 + swz(j, n & 31),
                      br + (ok ? static_cast<size_t>(t0 + j) * a.N + n : 0), ok);
          }
          for (int e = plane; e < T * PT; e += 32) {
            const int j = e >> 5, q = e & 31;
            const bool ok = j < len && p_base + q < a.P;
            cp_async4(f + kFX + swz(j, q),
                      xr + (ok ? static_cast<size_t>(t0 + j) * a.P + p_base + q : 0), ok);
          }
          const float* cbt = a.cb + (static_cast<size_t>(grp) * nt + t) * T * T;
          for (int e = plane; e < T * (T / 4); e += 32) {
            const int i = e >> 4, q = 4 * (e & 15);
            cp_async16(f + kFL + (q >> 5) * kBox64 + swz(i, q & 31), cbt + i * T + q);
          }
          if (plane < T / 4)
            cp_async16(base + kOffCum + s * T * 4 + 16 * plane, cumr + t0 + 4 * plane);
          cp_async_commit();
          cp_async_wait<0>();
          __syncwarp();
          if (plane == 0) mbar_arrive(bar(kFullF + s));
          if (q >= 2) mbar_wait(bar(kEmptyH + s), ((q >> 1) - 1) & 1);
          for (int e = plane; e < T * NMAX; e += 32) {
            const int i = e >> 7, n = e & 127;
            const bool ok = i < len && n < a.N;
            cp_async4(h + (n >> 5) * kBox64 + swz(i, n & 31),
                      cr + (ok ? static_cast<size_t>(t0 + i) * a.N + n : 0), ok);
          }
          cp_async_commit();
          cp_async_wait<0>();
          __syncwarp();
          if (plane == 0) mbar_arrive(bar(kFullH + s));
        }
      }
    }
  } else if (wg == 1) {
    // ---- h-free warpgroup: tile k's intra and s --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tf = threadIdx.x - 128, warp = tf >> 5, lane = tf & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = 16 * warp + g, r1 = r0 + 8;  // rows i of intra, n - 64 half of s
    const int n_q = nt * ((a.n_items - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1);
    for (int q = 0; q < n_q; ++q) {  // the block's tiles, item after item
      const int s = q & 1;
      uint8_t* f = base + s * kFStage;
      const uint32_t fs = sbase + s * kFStage;
      mbar_wait(bar(kFullF + s), (q >> 1) & 1);
      __syncwarp();
      // x -> x^T, split into TF32 hi (over x itself, once every thread has
      // read its part) and lo: element (j, p) to row p, column j of the B
      // operand.  Warp w takes the (p / 8, j / 4) blocks 16 w .. 16 w + 15; a
      // block's 32 lanes cover 8 p and 4 j.
      float xv[16];
#pragma unroll
      for (int rep = 0; rep < 16; ++rep) {
        const int blk = 16 * warp + rep;
        const int p = 8 * (blk & 3) + g, j = 4 * (blk >> 2) + t4;
        xv[rep] = lds(f, kFX + swz(j, p));
      }
      named_bar(1);
#pragma unroll
      for (int rep = 0; rep < 16; ++rep) {
        const int blk = 16 * warp + rep;
        const int p = 8 * (blk & 3) + g, j = 4 * (blk >> 2) + t4;
        uint32_t hi, lo;
        split_rn(xv[rep], hi, lo);
        const uint32_t off = (j >> 5) * kBox32 + swz(p, j & 31);
        sts(f, kFX + off, hi);
        sts(base, kOffXlo + s * 2 * kBox32 + off, lo);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_bar(1);
      const float* cum = reinterpret_cast<const float*>(base + kOffCum + s * T * 4);
      const float ci0 = cum[r0], ci1 = cum[r1], clast = cum[T - 1];
      // cum at this thread's columns j = 8 kk + t4 and j + 4 of every k-step,
      // read by both intra's decays and s's.
      float cumj[8][2];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        cumj[kk][0] = cum[8 * kk + t4];
        cumj[kk][1] = cum[8 * kk + t4 + 4];
      }
      // intra's A: (L o C B^T)[i][j] at rows r0, r1 and columns j0, j1 = j0 + 4
      // of k-step kk0 + u, the upper triangle selected to 0.
      auto build_intra = [&](Frag& fr, int kk0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kk = kk0 + u, j0 = 8 * kk + t4, j1 = j0 + 4;
          const uint32_t o0 = kFL + (j0 >> 5) * kBox64, o1 = kFL + (j1 >> 5) * kBox64;
          const float w[4] = {
              j0 <= r0 ? exp2_approx(ci0 - cumj[kk][0]) * lds(f, o0 + swz(r0, j0 & 31)) : 0.f,
              j0 <= r1 ? exp2_approx(ci1 - cumj[kk][0]) * lds(f, o0 + swz(r1, j0 & 31)) : 0.f,
              j1 <= r0 ? exp2_approx(ci0 - cumj[kk][1]) * lds(f, o1 + swz(r0, j1 & 31)) : 0.f,
              j1 <= r1 ? exp2_approx(ci1 - cumj[kk][1]) * lds(f, o1 + swz(r1, j1 & 31)) : 0.f};
          split4(w, fr.hi[u], fr.lo[u]);
        }
      };
      // The decays to the tile's end, w_j = 2^(cum_last - cum_j), shared by
      // both halves of s.
      float wd[8][2];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wd[kk][0] = exp2_approx(clast - cumj[kk][0]);
        wd[kk][1] = exp2_approx(clast - cumj[kk][1]);
      }
      // s's A: (B o w)^T[n][j] at rows n0, n1 = n0 + 8 of half h2.
      auto build_state = [&](Frag& fr, int h2, int kk0) {
        const int n0 = 64 * h2 + r0, n1 = n0 + 8;
        const uint32_t o0 = kFB + (n0 >> 5) * kBox64, o1 = kFB + (n1 >> 5) * kBox64;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kk = kk0 + u, j0 = 8 * kk + t4, j1 = j0 + 4;
          const float w[4] = {lds(f, o0 + swz(j0, n0 & 31)) * wd[kk][0],
                              lds(f, o1 + swz(j0, n1 & 31)) * wd[kk][0],
                              lds(f, o0 + swz(j1, n0 & 31)) * wd[kk][1],
                              lds(f, o1 + swz(j1, n1 & 31)) * wd[kk][1]};
          split4(w, fr.hi[u], fr.lo[u]);
        }
      };
      const uint32_t xhi = fs + kFX, xlo = sbase + kOffXlo + s * 2 * kBox32;
      float acc_i[16], acc_s0[16], acc_s1[16];
      Frag fa, fb;
      build_intra(fa, 0);
      wgmma_fence();
      issue4(acc_i, fa, xhi, xlo, 0, true);
      wgmma_commit();
      build_intra(fb, 4);
      wgmma_fence();
      issue4(acc_i, fb, xhi, xlo, 4, false);
      wgmma_commit();
      wgmma_wait<1>();  // chunk 0 is done with fa
      fence_frag(fa);
      build_state(fa, 0, 0);
      wgmma_fence();
      issue4(acc_s0, fa, xhi, xlo, 0, true);
      wgmma_commit();
      wgmma_wait<1>();
      fence_frag(fb);
      build_state(fb, 0, 4);
      wgmma_fence();
      issue4(acc_s0, fb, xhi, xlo, 4, false);
      wgmma_commit();
      wgmma_wait<1>();
      fence_frag(fa);
      build_state(fa, 1, 0);
      wgmma_fence();
      issue4(acc_s1, fa, xhi, xlo, 0, true);
      wgmma_commit();
      wgmma_wait<1>();
      fence_frag(fb);
      build_state(fb, 1, 4);
      wgmma_fence();
      issue4(acc_s1, fb, xhi, xlo, 4, false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc_i);
      fence_acc(acc_s0);
      fence_acc(acc_s1);
      fence_frag(fa);
      fence_frag(fb);
      // Hand-off in the accumulators' layout, thread-major: s over B's
      // space, y_intra over the scores'.
      named_bar(1);
      float4* hs = reinterpret_cast<float4*>(f + kFB);
      float4* hy = reinterpret_cast<float4*>(f + kFL);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hs[k * 128 + tf] = make_float4(acc_s0[4 * k], acc_s0[4 * k + 1], acc_s0[4 * k + 2],
                                       acc_s0[4 * k + 3]);
        hs[(4 + k) * 128 + tf] = make_float4(acc_s1[4 * k], acc_s1[4 * k + 1],
                                             acc_s1[4 * k + 2], acc_s1[4 * k + 3]);
        hy[k * 128 + tf] = make_float4(acc_i[4 * k], acc_i[4 * k + 1], acc_i[4 * k + 2],
                                       acc_i[4 * k + 3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(kHandoff + s));
    }
  } else {
    // ---- h-bound warpgroup: tile k's inter, y and the carry --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    const uint32_t ht_hi = sbase + kOffHT, ht_lo = ht_hi + 4 * kBox32;
    // h in two m64n32 accumulator layouts: h[h2][4 jj + 2 hh + e] is row
    // n = 64 h2 + r0 + 8 hh, column p = 8 jj + 2 t4 + e.
    float h[2][16];
    auto write_ht = [&]() {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int n = 64 * h2 + r0 + 8 * ((r >> 1) & 1), p = 8 * (r >> 2) + 2 * t4 + (r & 1);
          uint32_t hi, lo;
          split_rn(h[h2][r], hi, lo);
          const uint32_t off = (n >> 5) * kBox32 + swz(p, n & 31);
          sts(base, kOffHT + off, hi);
          sts(base, kOffHT + 4 * kBox32 + off, lo);
        }
    };
    Frag fa, fb;
    int q = 0;
    for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x) {
      const Item it = item(idx);
      const int bh = it.bh, p_base = it.p_base;
      // The state entering tile 0: h0's rows [0, N) and this block's columns,
      // zero elsewhere; the previous item's last inter is done with h^T.
      const float* h0r = a.h0 == nullptr ? nullptr : a.h0 + static_cast<size_t>(bh) * a.N * a.P;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int n = 64 * h2 + r0 + 8 * ((r >> 1) & 1);
          const int p = p_base + 8 * (r >> 2) + 2 * t4 + (r & 1);
          h[h2][r] = h0r != nullptr && n < a.N && p < a.P ? h0r[static_cast<size_t>(n) * a.P + p]
                                                           : 0.f;
        }
      write_ht();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      float* yr = a.y + static_cast<size_t>(bh) * a.S * a.P;
      for (int t = 0; t < nt; ++t, ++q) {
        const int s = q & 1;
        const uint8_t* f = base + s * kFStage;
        const uint8_t* hc = base + kOffH + s * kHStage;
        mbar_wait(bar(kHandoff + s), (q >> 1) & 1);
        __syncwarp();
        const float4* hs = reinterpret_cast<const float4*>(f + kFB);
        const float4* hy = reinterpret_cast<const float4*>(f + kFL);
        const float* cum = reinterpret_cast<const float*>(base + kOffCum + s * T * 4);
        const float ci0 = cum[r0], ci1 = cum[r1], clast = cum[T - 1];
        // The carry into the registers as the hand-off is read; h^T in shared
        // memory still holds the state entering the tile, which inter reads.
        const float decay = exp2_approx(clast);
        float yi[16];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 v0 = hs[k * 128 + threadIdx.x], v1 = hs[(4 + k) * 128 + threadIdx.x];
          const float4 v2 = hy[k * 128 + threadIdx.x];
          const float s0[4] = {v0.x, v0.y, v0.z, v0.w}, s1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            h[0][4 * k + e] = h[0][4 * k + e] * decay + s0[e];
            h[1][4 * k + e] = h[1][4 * k + e] * decay + s1[e];
          }
          yi[4 * k] = v2.x, yi[4 * k + 1] = v2.y, yi[4 * k + 2] = v2.z, yi[4 * k + 3] = v2.w;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(kEmptyF + s));
        mbar_wait(bar(kFullH + s), (q >> 1) & 1);
        __syncwarp();
        named_bar(2);  // every warp's h^T of the state entering the tile is written
        // inter: C h over K = N, four k-steps (one box of C) a chunk.
        auto build_c = [&](Frag& fr, int cbx) {
          const uint32_t o = cbx * kBox64;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int n0 = 8 * u + t4, n1 = n0 + 4;
            const float v[4] = {lds(hc, o + swz(r0, n0)), lds(hc, o + swz(r1, n0)),
                                lds(hc, o + swz(r0, n1)), lds(hc, o + swz(r1, n1))};
            split4(v, fr.hi[u], fr.lo[u]);
          }
          if (cbx == nbox - 1) {  // the last read of C
            __syncwarp();
            if (lane == 0) mbar_arrive(bar(kEmptyH + s));
          }
        };
        float acc_y[16];
        auto step = [&](Frag& fr, int cbx) {
          if (cbx >= 2) {
            wgmma_wait<1>();  // the chunk before last, which read fr, is done
            fence_frag(fr);
          }
          build_c(fr, cbx);
          wgmma_fence();
          issue4(acc_y, fr, ht_hi, ht_lo, 4 * cbx, cbx == 0);
          wgmma_commit();
        };
        for (int cbx = 0; cbx < nbox; ++cbx) {
          if (cbx & 1)
            step(fb, cbx);
          else
            step(fa, cbx);
        }
        wgmma_wait<0>();
        fence_acc(acc_y);
        fence_frag(fa);
        fence_frag(fb);
        write_ht();  // inter's reads of the old h^T are done
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        // y = exp(cum_i) C h + y_intra, rows past S not stored.  Each store
        // writes whole 32-byte sectors (float2 where vec4 promises an even P).
        const float d0 = exp2_approx(ci0), d1 = exp2_approx(ci1);
        const int t0 = t * T, len = min(T, a.S - t0);
        float* y0 = yr + static_cast<size_t>(t0 + r0) * a.P + p_base + 2 * t4;
        float* y1 = y0 + static_cast<size_t>(8) * a.P;
        if (a.use_tma && len == T && p_base + PT <= a.P) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int r = 4 * jj;
            *reinterpret_cast<float2*>(y0 + 8 * jj) =
                make_float2(acc_y[r] * d0 + yi[r], acc_y[r + 1] * d0 + yi[r + 1]);
            *reinterpret_cast<float2*>(y1 + 8 * jj) =
                make_float2(acc_y[r + 2] * d1 + yi[r + 2], acc_y[r + 3] * d1 + yi[r + 3]);
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int p = p_base + 8 * jj + 2 * t4;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 4 * jj + 2 * hh;
              if (r0 + 8 * hh >= len) continue;
              const float dd = hh ? d1 : d0;
              float* out = (hh ? y1 : y0) + 8 * jj;
              if (p < a.P) out[0] = acc_y[r] * dd + yi[r];
              if (p + 1 < a.P) out[1] = acc_y[r + 1] * dd + yi[r + 1];
            }
          }
        }
      }
      if (a.h_out != nullptr) {
        float* hr = a.h_out + static_cast<size_t>(bh) * a.N * a.P;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const int n = 64 * h2 + r0 + 8 * ((r >> 1) & 1),
                      p = p_base + 8 * (r >> 2) + 2 * t4 + (r & 1);
            if (n < a.N && p < a.P) hr[static_cast<size_t>(n) * a.P + p] = h[h2][r];
          }
      }
    }
  }
}

// A float32 (d2, d1, d0) tensor as a three-dimensional map (d0 innermost),
// read in boxes of 32 x 64 x 1 with the 128-byte swizzle; reads past an
// edge come back zero.
bool encode(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2) {
  const EncodeTiled fn = tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 4, d0 * d1 * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(T), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The device's SMs, looked up once per device: the scan runs one
// persistent block on each (or one per item, when there are fewer).
cudaError_t multiprocessors(int* sms) {
  static std::atomic<int> cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int v = cached[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev].store(v, std::memory_order_relaxed);
  }
  *sms = v;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Scratch floats the launch needs: scores (G, tiles, 64, 64) then sums
// (BH, tiles * 64).
long long repro_ssd_scan_scratch(int BH, int S, int G) {
  const long long tiles = (S + T - 1) / T;
  return tiles * T * (static_cast<long long>(G) * T + BH);
}

// The scan's geometry, for the wrapper's geometry(): positions a tile,
// columns a block, threads a block, shared bytes a block, registers a thread
// at launch (from the compiled kernel) and after setmaxnreg (consumers,
// producer), blocks an SM (from the occupancy calculator), the first pass's
// shared bytes.
int repro_ssd_scan_geometry(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ssd_scan_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  static repro::SmemOptIn opt_in;
  err = opt_in.need(ssd_scan_kernel, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssd_scan_kernel, kThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[9] = {T,    PT,     kThreads,      kSmem, attr.numRegs, kConsumerRegs,
                         kProducerRegs, per_sm, kPrepSmem};
  for (int i = 0; i < 9; ++i) out[i] = values[i];
  return 0;
}

// Launches both kernels on `stream`; returns the launch's cudaError_t.  x, y
// (BH, S, P), da (BH, S), b, c (BH / heads_per_group, S, N), h0 (the state
// before position 0) and h_out (BH, N, P) or null, scratch as
// repro_ssd_scan_scratch says; all contiguous float32; S >= 1.  vec4 != 0
// promises N and P multiples of 4 and 16-byte aligned x, b, c: the scan's
// loads are then TMA, else cp.async.
int repro_ssd_scan(const void* x, const void* da, const void* b, const void* c, const void* h0,
                   void* y, void* h_out, void* scratch, int BH, int S, int P, int N,
                   int heads_per_group, int vec4, void* stream) {
  // The first pass's grid takes the groups on its y dimension (at most
  // 65535); the scan's is one-dimensional over the items.
  if (BH < 1 || S < 1 || P < 1 || N < 1 || N > NMAX || heads_per_group < 1 ||
      BH % heads_per_group || BH / heads_per_group > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (S + T - 1) / T;
  const int G = BH / heads_per_group;
  const int nbox = (N + 31) / 32;
  float* cb = static_cast<float*>(scratch);
  float* cum = cb + static_cast<size_t>(G) * n_tiles * T * T;
  static repro::SmemOptIn prep_opt_in, scan_opt_in;
  cudaError_t err = prep_opt_in.need(ssd_prep_kernel, kPrepSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_prep_kernel<<<dim3(n_tiles, G, 2), kPrepThreads, kPrepSmem, st>>>(
      static_cast<const float*>(da), static_cast<const float*>(b), static_cast<const float*>(c),
      cb, cum, S, N, nbox, heads_per_group, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_x = {}, tm_b = {}, tm_c = {}, tm_cb = {};
  if (vec4 && (!encode(&tm_x, x, P, S, BH) || !encode(&tm_b, b, N, S, G) ||
               !encode(&tm_c, c, N, S, G) || !encode(&tm_cb, cb, T, n_tiles * T, G)))
    return static_cast<int>(cudaErrorInvalidValue);
  err = scan_opt_in.need(ssd_scan_kernel, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = multiprocessors(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pblk = (P + PT - 1) / PT;
  const long long n_items = static_cast<long long>(n_pblk) * BH;
  if (n_items > (1ll << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs args = {static_cast<const float*>(x), static_cast<const float*>(b),
                         static_cast<const float*>(c), cb, cum, static_cast<const float*>(h0),
                         static_cast<float*>(y), static_cast<float*>(h_out), S, P, N,
                         heads_per_group, n_tiles, nbox, vec4 ? 1 : 0, n_pblk,
                         static_cast<int>(n_items)};
  // A programmatic dependent launch: the scan's blocks set up (barriers,
  // h0, h^T) while ssd_prep finishes, and its producer waits for ssd_prep
  // (griddepcontrol.wait) before it loads anything.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_items < sms ? n_items : sms));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_scan_kernel, tm_x, tm_b, tm_c, tm_cb, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
