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
// * Tensor route (bf16): attention_tc, a TMA ring feeding wgmma warpgroups.
//   Bound: at short S the bytes bind (row 7, (256, 512, 64) causal: 67 MB,
//   0.020 ms at 3.35 TB/s against 0.009 ms of operations), at long S the
//   operations (RecurrentGemma's (80, 2560, 256) window 2048: 258 GFLOP,
//   0.26 ms at 989 TFLOP/s; Whisper's encoder); only wgmma reaches the
//   tensor cores' full rate, and only TMA keeps tiles coming without the
//   consumers' registers.  At D <= 64 the softmax's ex2 (16 a clock on an
//   SM) takes as long as the products of a tile.
//   Blocks of 384 threads: two consumer warpgroups of 64 query rows each
//   and a producer warpgroup, of which one thread issues every load; the
//   producer gives its registers to the consumers by setmaxnreg (168 a
//   thread at launch; 24 for the producer, 240 for the consumers).  The
//   work items are (head, 128-row query tile) pairs.  Either one block an
//   SM walks its share of them round by round (the key tiles ring on across
//   items, and the next item's Q loads into a second buffer up to D = 128,
//   so the start of an item runs under the end of the last), or one block
//   takes one item; the launcher models both and takes the faster
//   (grid_size).  Within a head the longest causal rows come first.
//   Loads: TMA (cp.async.bulk.tensor) from three-dimensional tensor maps
//   over (D, S, BH), encoded on the host for every call (wgmma_tma.cuh): a
//   box never reaches into the next head, and rows past S come back zero
//   (the key mask j < S still applies: a zero key scores 0, not -1e30).
//   Rows are 128-byte swizzled boxes of 64 columns (D / 64 boxes a tile;
//   at D = 32 one box of 64-byte rows with the 64-byte swizzle).  K and V
//   tiles of BN keys go into a ring of kStages stages (Geom: BN = 128 and 3
//   stages at D <= 64, 128 and 2 at D = 128, 64 and 2 at D = 256, where
//   Q's 64 KB and two stages of K and V take 193 KB of the SM's 227 KB),
//   K and V of a stage each completing on its own mbarrier, each consumer
//   warp handing a stage back on its "empty" mbarrier.
//   Products: S = Q K^T as wgmma m64nBNk16 with Q and K both K-major from
//   shared memory; O += P V as wgmma m64nDk16 with A = P from registers (the
//   scores' accumulator fragments, rounded to bf16, are the register A
//   layout) and B = V read N-major through the descriptor's transpose bit.
//   A warpgroup's loop is software-pipelined: tile j's Q K^T and tile
//   j - 1's P V are in flight together and O's rescale runs under the
//   former (ptxas waits for the P V before tile j's exponentials, so the
//   softmax does not run under it).  Up to D = 128 the two warpgroups take
//   turns issuing their products (named barriers), so that one's softmax
//   runs under the other's products.  A warpgroup multiplies only the key tiles some row
//   of its 64 keeps (exact to skip the rest: their p would be 0) and masks
//   entry by entry only in a tile that straddles a mask edge.
//   Softmax: fp32 and online, in log2 units: p = 2^(s c - m c) with
//   c = log2(e) / sqrt(D), one FFMA and one ex2.approx a score; masked
//   scores are -1e30, and while a row has no kept key its maximum is -1e30
//   and its p are 0.  A row's scores lie in the 4 threads of a quad: its
//   max is combined by a fixed shuffle tree (xor 1, then 2); each thread
//   keeps a partial normalizer, added over the quad the same way at the
//   end.  The rounding of p to bf16 is one the plain version does not make:
//   each p_j moves by at most 2^-8 p_j (bf16's unit roundoff), so an output
//   sum_j p_j v_j / l moves by at most 2^-8 sum_j p_j |v_j| / l.  The checks
//   hold each output entry to that, plus 2^-12 of it for the fp32 sums and
//   2^-8 of each result for its rounding to bf16 (chip_smoke.py,
//   ATTN_BF16_U).  O is normalised in registers, rounded to bf16 and stored
//   row by row with the row < S guard.  No atomics: every sum has one
//   order, so a launch repeats bit for bit, whichever block takes an item.
//   ``nvcc -Xptxas -v`` with the flags of ``kernels/backend.py`` (CUDA 12.9,
//   sm_90a): 168 registers a thread at launch and no spills at D = 32, 64,
//   128 and 256 (the consumers' code is allocated within their 240).
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <functional>
#include <mutex>
#include <queue>
#include <type_traits>
#include <vector>

#include "smem_opt_in.cuh"
#include "wgmma_tma.cuh"

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

using namespace repro;
using bf16 = __nv_bfloat16;
constexpr int BQ = 128;          // query rows per block: two consumer warpgroups of 64
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // then the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
// Registers a thread after setmaxnreg: the 168 of a 384-thread launch, moved
// from the producer to the consumers (4 x 24 + 8 x 240 = 12 x 168).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// Keys per K / V tile (BN), ring stages and the rest of the geometry by
// head width, and the shared memory it takes: the Q buffers, the ring of K
// and V tiles, the barriers and item slots (below), and slack to align the
// tiles to the 1024-byte swizzle atom.  A tile row of D bf16 is loaded as
// D / 64 boxes of 64 columns, 128 bytes a row (the 128-byte swizzle); at
// D = 32 one box of 64-byte rows (the 64-byte swizzle).
template <int D>
struct Geom {
  static constexpr int BN = D <= 128 ? 128 : 64;
  static constexpr int kStages = D <= 64 ? 3 : 2;
  // The two warpgroups take turns issuing their products (below), so that
  // one's softmax runs under the other's products; at D = 256 the products
  // dominate and the turns would only hold them back.
  static constexpr bool kPingPong = D <= 128;
  // Register sets of P: two at D <= 64 (see the pipeline; measured a few
  // percent faster there); wider heads have no registers for a second set.
  static constexpr int kPSets = D <= 64 ? 2 : 1;
  static constexpr int kRowBytes = D >= 64 ? 128 : 2 * D;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor code
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = D / kBoxCols;
  // Q buffers: two up to D = 128, so an item's Q loads while the last one
  // is multiplied; at D = 256 there is room for one.
  static constexpr int kQBufs = D <= 128 ? 2 : 1;
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kTileBytes = BN * D * 2;
  static constexpr int kBars = 2 * kQBufs + 3 * kStages;
  static constexpr int kSmem =
      1024 + kQBufs * kQBytes + 2 * kStages * kTileBytes + 8 * kBars + 8 * kQBufs;
};
// The geometry that kernels/local_attention.py's TC_GEOM and tc_plan describe.
static_assert(Geom<32>::BN == 128 && Geom<32>::kStages == 3 && Geom<32>::kSmem == 66680,
              "tc_plan");
static_assert(Geom<64>::BN == 128 && Geom<64>::kStages == 3 && Geom<64>::kSmem == 132216,
              "tc_plan");
static_assert(Geom<128>::BN == 128 && Geom<128>::kStages == 2 && Geom<128>::kSmem == 197728,
              "tc_plan");
static_assert(Geom<256>::BN == 64 && Geom<256>::kStages == 2 && Geom<256>::kSmem == 197704,
              "tc_plan");
static_assert(Geom<256>::kSmem <= 232448, "a block's shared memory on the H100");

// 2^x by the SFU (ex2.approx, ~2 ulp): exactly 0 for the masked scores,
// exactly 1 at 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 (0 is __syncthreads'): the turns of the two
// consumer warpgroups, 256 threads each (the waiting warpgroup's and the
// one that hands over).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int to_wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(1 + to_wg) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Keeps the compiler from moving reads or writes of P's fragments across
// the asynchronous products that read them.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[i][e])::"memory");
}

// Issues S = Q K^T for the warpgroup's 64 rows and one stage's BN keys:
// Q and K both K-major; a 16-wide k step is 32 bytes along a box row, the
// next 64 columns the next box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Geom<D>::BN / 2], uint32_t q_wg, uint32_t ks) {
  using G = Geom<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / G::kBoxCols, off = (kk * 16 % G::kBoxCols) * 2;
    wgmma_ss<0>(s, smem_desc(q_wg + box * BQ * G::kRowBytes + off, 16, 8 * G::kRowBytes,
                             G::kSwizzle),
                smem_desc(ks + box * G::BN * G::kRowBytes + off, 16, 8 * G::kRowBytes,
                          G::kSwizzle),
                kk > 0);
  }
  wgmma_commit();
}

// Issues O += P V for one stage: P's register fragments of keys
// [16 kk, 16 kk + 16), V (keys x D) read N-major, its 64-column boxes a
// leading offset apart, 8 keys a stride offset.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[Geom<D>::BN / 16][4], uint32_t vs) {
  using G = Geom<D>;
#pragma unroll
  for (int kk = 0; kk < G::BN / 16; ++kk)
    wgmma_rs(o, p[kk], smem_desc(vs + kk * 16 * G::kRowBytes, G::BN * G::kRowBytes,
                                 8 * G::kRowBytes, G::kSwizzle));
  wgmma_commit();
}

// The online softmax of one tile of raw scores s (q . k) for this thread's
// rows r0 and r0 + 8 (h = 0, 1): masks (when `masked`) with -1e30, updates
// the running maxima m (raw units) and partial normalizers l, overwrites s
// with p = 2^(s c - m c), c = log2(e) / sqrt(D) (one FFMA and one ex2 a
// score), and returns each row's rescale factor of O in alpha.  A row's
// scores lie in the 4 threads of a quad: its max is combined by a fixed
// shuffle tree (xor 1, then 2).  While a row has no kept key its maximum is
// -1e30 and its p are 0.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked, int t0, int r0,
                                             int c0, int S, int window, int causal, float c) {
  if (masked) {
    // Row r keeps keys [r - window + 1 (with a window), min(r, S - 1) (causal)
    // or S - 1]; entry (j, e) of row h holds key t0 + c0 + 8 j + e.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const int hi = (causal ? min(row, S - 1) : S - 1) - (t0 + c0);
      const int lo = row - window + 1 - (t0 + c0);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int off = 8 * j + e;
          if (off > hi || (window && off < lo)) s[4 * j + 2 * h + e] = kNegInf;
        }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    alpha[h] = exp2_approx((m[h] - m_new) * c);
    const float base = m_new == kNegInf ? 0.f : m_new * c;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp2_approx(fmaf(s[4 * j + 2 * h + e], c, -base));
        s[4 * j + 2 * h + e] = pe;
        psum += pe;
      }
    l[h] = l[h] * alpha[h] + psum;
    m[h] = m_new;
  }
}

// The scores' accumulator fragments, rounded to bf16, are the register A
// fragments of P V: keys 16 kk + [0, 8) in p[kk][0, 1], + [8, 16) in [2, 3].
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  fence_frags(p);
}

// O's rows times their rescale factors (row r0: alpha[0], r0 + 8: alpha[1]).
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
  fence_acc(o);
}

// The block's share of the work items, (head, query tile) pairs of 128
// rows: items go round by round, gridDim.x to a round, in head-major order
// with each head's longest causal rows first; even rounds hand them to the
// blocks in block order and odd rounds in reverse, which evens out the
// blocks' work when the tiles' lengths repeat with the heads.  Item n of
// the block, or n_items when it has no n-th.
__host__ __device__ __forceinline__ int item_of(int n, int n_items, int g, int c) {
  const int idx = n * g + (n % 2 ? g - 1 - c : c);
  return idx < n_items ? idx : n_items;
}

// A work item's head, first query row, and the key tiles its rows need:
// [t_first, t_first + n_tiles), up to the tile of key_last.
struct Item {
  int bh, q0, key_last, t_first, n_tiles;
};
template <int BN>
__host__ __device__ __forceinline__ Item item_tiles(int idx, int n_qt, int S, int window,
                                                    int causal) {
  Item it;
  it.bh = idx / n_qt;
  it.q0 = (n_qt - 1 - idx % n_qt) * BQ;
  it.key_last = causal && it.q0 + BQ < S ? it.q0 + BQ - 1 : S - 1;
  it.t_first = window && it.q0 - window + 1 > 0 ? (it.q0 - window + 1) / BN : 0;
  it.n_tiles = it.key_last / BN - it.t_first + 1;
  return it;
}

// A block, one an SM walking its share of the items or one an item
// (grid_size): threads 0-255 are two consumer warpgroups (64 query rows
// each), 256-383 the producer warpgroup, of which one thread issues every
// load.  The ring of K and V stages runs on across the block's items, and
// the producer loads an item's Q as soon as its Q buffer is free, so the
// next item's loads run under this item's products and its stores.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int S, int BH,
             int window, int causal, float scale_log2) {
  using G = Geom<D>;
  constexpr int BN = G::BN, ST = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  constexpr int QB = G::kQBufs;
  const uint32_t k_s = q_s + QB * G::kQBytes;         // stage s at k_s + s kTileBytes
  const uint32_t v_s = k_s + ST * G::kTileBytes;
  // Barriers: per Q buffer loaded and released, then per stage K loaded, V
  // loaded and the stage released; after them, per Q buffer, the slot that
  // passes its item's index from the producer to the consumers (-1: no
  // more items).  Item n of the block uses Q buffer n % QB.
  const uint32_t q_full = v_s + ST * G::kTileBytes, q_empty = q_full + 8 * QB;
  const uint32_t full_k = q_empty + 8 * QB, full_v = full_k + 8 * ST, empty = full_v + 8 * ST;
  volatile int* slot = reinterpret_cast<volatile int*>(
      smem_raw + (empty + 8 * ST - smem_u32(smem_raw)));  // slot[b] at 8-byte steps
  const int n_qt = (S + BQ - 1) / BQ, n_items = n_qt * BH;

  if (threadIdx.x == 0) {
    for (int b = 0; b < QB; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, kConsumerWarps);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup gives its registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int ring = 0;  // K / V tiles loaded so far
      for (int n = 0;; ++n) {
        const int idx = item_of(n, n_items, gridDim.x, blockIdx.x), qb = n % QB;
        const uint32_t qf = q_full + 8 * qb;
        if (n >= QB) mbar_wait(q_empty + 8 * qb, ((n / QB) - 1) & 1);
        if (idx == n_items) {
          slot[2 * qb] = -1;
          mbar_arrive(qf);
          break;
        }
        slot[2 * qb] = idx;
        const Item w = item_tiles<BN>(idx, n_qt, S, window, causal);
        mbar_expect_tx(qf, G::kQBytes);
        for (int c = 0; c < G::kBoxes; ++c)
          tma_load_3d(q_s + qb * G::kQBytes + c * BQ * G::kRowBytes, &tm_q, c * G::kBoxCols, w.q0,
                      w.bh, qf);
        for (int it = 0; it < w.n_tiles; ++it, ++ring) {
          const int s = ring % ST;
          if (ring >= ST) mbar_wait(empty + 8 * s, ((ring / ST) - 1) & 1);
          const int key0 = (w.t_first + it) * BN;
          const uint32_t ks = k_s + s * G::kTileBytes, vs = v_s + s * G::kTileBytes;
          mbar_expect_tx(full_k + 8 * s, G::kTileBytes);
          for (int c = 0; c < G::kBoxes; ++c)
            tma_load_3d(ks + c * BN * G::kRowBytes, &tm_k, c * G::kBoxCols, key0, w.bh,
                        full_k + 8 * s);
          mbar_expect_tx(full_v + 8 * s, G::kTileBytes);
          for (int c = 0; c < G::kBoxes; ++c)
            tma_load_3d(vs + c * BN * G::kRowBytes, &tm_v, c * G::kBoxCols, key0, w.bh,
                        full_v + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // Consumer warpgroup wg: rows [w_lo, w_lo + 64) of an item; this
    // thread's rows are r0 and r0 + 8 (the fragment layout of wgmma_tma.cuh).
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int c0 = 2 * (lane & 3);
    int ring = 0;  // K / V tiles consumed so far
    auto wait_full = [&](uint32_t bars, int pos) {
      mbar_wait(bars + 8 * (pos % ST), (pos / ST) & 1);
      __syncwarp();  // the warpgroup's .aligned instructions need converged warps
    };
    auto arrive = [&](uint32_t bar) {  // one arrival a warp
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Ping-pong: for every tile of every item, in order, warpgroup 0 and
    // then warpgroup 1 issue their products (or, for a tile they skip,
    // nothing) in their turn.  Warpgroup 0 gives itself the first turn and,
    // at the end, takes back the last hand-over, so that no barrier is left
    // half arrived.
    auto turn_begin = [&]() {
      if constexpr (G::kPingPong) turn_wait(wg);
    };
    auto turn_end = [&]() {
      if constexpr (G::kPingPong) turn_pass(1 - wg);
    };
    if constexpr (G::kPingPong)
      if (wg == 0) turn_pass(0);

    for (int n = 0;; ++n) {
      const int qb = n % QB;
      mbar_wait(q_full + 8 * qb, (n / QB) & 1);
      const int idx = slot[2 * qb];
      if (idx < 0) break;
      const uint32_t q_wg = q_s + qb * G::kQBytes + 64 * wg * G::kRowBytes;
      const Item w = item_tiles<BN>(idx, n_qt, S, window, causal);
      const int w_lo = w.q0 + 64 * wg, w_hi = w_lo + 63;
      const int r0 = w_lo + 16 * warp + (lane >> 2);
      // The warpgroup's own key tiles, [a, b) of the item's: the others are
      // masked for all its rows (exact to skip: their p would be 0).  It
      // still waits for them and hands them back, so that the ring's phases
      // stay in step.
      int a = 0, b = 0;
      if (w_lo < S) {
        a = (window ? max(0, w_lo - window + 1) / BN : 0) - w.t_first;
        b = (causal ? min(w_hi, w.key_last) : w.key_last) / BN - w.t_first + 1;
      }
      // Whether a tile straddles a mask edge of some row of the warpgroup.
      auto needs_mask = [&](int t0) {
        return (causal && t0 + BN - 1 > w_lo) || t0 + BN > S || (window && t0 <= w_hi - window);
      };
      auto skip_tile = [&](int it) {
        wait_full(full_k, ring + it);
        wait_full(full_v, ring + it);
        turn_begin();
        turn_end();
        arrive(empty + 8 * ((ring + it) % ST));
      };

      float o_acc[D / 2], s_acc[BN / 2], m_run[2] = {kNegInf, kNegInf}, l_part[2] = {0.f, 0.f};
      float alpha[2];
      uint32_t pa[G::kPSets][BN / 16][4];  // P of one or two tiles (below)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s_acc[i] = 0.f;

      for (int it = 0; it < a; ++it) skip_tile(it);
      if (a < b) {
        // Software pipeline: tile it's Q K^T and tile it - 1's P V are in
        // flight together, and O's rescale runs under the former.  Each
        // batch of products has its own wgmma fence, after the registers it
        // reads were last written.  At D <= 64 P's fragments alternate
        // between two register sets (the loop is unrolled by two); with one
        // set, P is packed once the P V that reads it is done.  The softmax
        // of tile it is written to run under tile it - 1's P V, but ptxas
        // (CUDA 12.9) places the wait for that product before the softmax's
        // exponentials (cuobjdump -sass): the products overlap another
        // warpgroup's softmax (the turns), not this one's.
        wait_full(full_k, ring + a);
        turn_begin();
        wgmma_fence();
        issue_qk<D>(s_acc, q_wg, k_s + ((ring + a) % ST) * G::kTileBytes);
        turn_end();
        wgmma_wait<0>();
        fence_acc(s_acc);
        const int t0a = (w.t_first + a) * BN;
        softmax_tile<BN>(s_acc, m_run, l_part, alpha, needs_mask(t0a), t0a, r0, c0, S, window,
                         causal, scale_log2);
        pack_p<BN>(pa[0], s_acc);
        // Tile it, with tile it - 1's P in pa[cur]; tile it's goes to the other set.
        auto step = [&](int it, auto cur) {
          constexpr int kCur = decltype(cur)::value % G::kPSets;
          constexpr int kNext = (kCur + 1) % G::kPSets;
          wait_full(full_k, ring + it);
          turn_begin();
          wgmma_fence();
          issue_qk<D>(s_acc, q_wg, k_s + ((ring + it) % ST) * G::kTileBytes);
          rescale<D>(o_acc, alpha);
          wait_full(full_v, ring + it - 1);
          wgmma_fence();
          issue_pv<D>(o_acc, pa[kCur], v_s + ((ring + it - 1) % ST) * G::kTileBytes);
          turn_end();
          wgmma_wait<1>();  // Q K^T of tile it is done
          fence_acc(s_acc);
          const int t0 = (w.t_first + it) * BN;
          softmax_tile<BN>(s_acc, m_run, l_part, alpha, needs_mask(t0), t0, r0, c0, S, window,
                           causal, scale_log2);
          if constexpr (G::kPSets == 2) pack_p<BN>(pa[kNext], s_acc);
          wgmma_wait<0>();  // P V of tile it - 1 is done
          fence_acc(o_acc);
          fence_frags(pa[kCur]);
          arrive(empty + 8 * ((ring + it - 1) % ST));
          if constexpr (G::kPSets == 1) pack_p<BN>(pa[kNext], s_acc);
        };
        // The last tile's P V, from pa[cur].
        auto last = [&](auto cur) {
          constexpr int kCur = decltype(cur)::value % G::kPSets;
          arrive(q_empty + 8 * qb);  // the warpgroup's last product that reads Q is done
          rescale<D>(o_acc, alpha);
          wait_full(full_v, ring + b - 1);
          wgmma_fence();
          issue_pv<D>(o_acc, pa[kCur], v_s + ((ring + b - 1) % ST) * G::kTileBytes);
          wgmma_wait<0>();
          fence_acc(o_acc);
          fence_frags(pa[kCur]);
          arrive(empty + 8 * ((ring + b - 1) % ST));
        };
        using Set0 = std::integral_constant<int, 0>;
        using Set1 = std::integral_constant<int, 1>;
        int it = a + 1;
        if constexpr (G::kPSets == 2) {
          for (; it + 1 < b; it += 2) {
            step(it, Set0{});
            step(it + 1, Set1{});
          }
          if (it < b) {
            step(it, Set0{});
            last(Set1{});
          } else {
            last(Set0{});
          }
        } else {
          for (; it < b; ++it) step(it, Set0{});
          last(Set0{});
        }
      } else {
        arrive(q_empty + 8 * qb);
      }
      for (int it = max(a, b); it < w.n_tiles; ++it) skip_tile(it);
      ring += w.n_tiles;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = l_part[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = r0 + 8 * h;
        if (row >= S) continue;
        const float inv = 1.f / fmaxf(l, 1e-30f);
        bf16* out = o + (static_cast<size_t>(w.bh) * S + row) * D + c0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(o_acc[4 * j + 2 * h] * inv, o_acc[4 * j + 2 * h + 1] * inv);
      }
    }
    if constexpr (G::kPingPong)
      if (wg == 0) turn_wait(0);
  }
}

// A (BH, S, D) bf16 tensor as a three-dimensional map (D innermost), read
// in boxes of (kBoxCols, rows, 1) with the tile's swizzle; rows past S come
// back zero and a box never reaches into the next head.
template <int D>
bool encode_3d(CUtensorMap* map, const void* ptr, int S, int BH, int rows) {
  using G = Geom<D>;
  const EncodeTiled fn = tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {G::kBoxCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The grid.  One block an SM, each walking its share of the items round by
// round, saves each item a block's start and lets the next item's loads run
// under this one's end; one block an item lets the hardware hand each SM
// its next item as it frees up, which evens out items of uneven length.
// The launcher models both in units of key tiles (an item's tiles plus 1
// for its start and end in a persistent block, plus 2 in a fresh one) and
// takes the one whose busiest SM finishes first.  One block an item wins
// when a window shorter than S makes the early query tiles short and the
// rounds fall out of step with the heads (RecurrentGemma's prefill).  The
// choice is kept for the last few shapes, so a model's layers pay for it
// once.
template <int D>
int grid_size(int n_items, int n_qt, int S, int window, int causal, int sms) {
  const int g = n_items < sms ? n_items : sms;
  if (n_items > 64 * g) return g;  // many items a block: the rounds even out
  struct Shape {
    int n_items, S, window, causal, sms, grid;
  };
  static Shape seen[8] = {};
  static int next = 0;
  static std::mutex lock;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (const Shape& e : seen)
      if (e.grid && e.n_items == n_items && e.S == S && e.window == window &&
          e.causal == causal && e.sms == sms)
        return e.grid;
  }
  auto cost = [&](int idx) {
    return item_tiles<Geom<D>::BN>(idx, n_qt, S, window, causal).n_tiles;
  };
  long long persistent = 0;
  for (int c = 0; c < g; ++c) {
    long long load = 0;
    for (int n = 0, idx; (idx = item_of(n, n_items, g, c)) < n_items; ++n) load += cost(idx) + 1;
    persistent = load > persistent ? load : persistent;
  }
  std::priority_queue<long long, std::vector<long long>, std::greater<long long>> free_at;
  for (int c = 0; c < g; ++c) free_at.push(0);
  long long per_item = 0;
  for (int idx = 0; idx < n_items; ++idx) {
    const long long t = free_at.top() + cost(idx) + 2;
    free_at.pop();
    free_at.push(t);
    per_item = t > per_item ? t : per_item;
  }
  const int grid = persistent <= per_item ? g : n_items;
  std::lock_guard<std::mutex> hold(lock);
  seen[next] = {n_items, S, window, causal, sms, grid};
  next = (next + 1) % 8;
  return grid;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int window,
           int causal, float scale, cudaStream_t st) {
  using G = Geom<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_3d<D>(&tm_q, q, S, BH, BQ) || !encode_3d<D>(&tm_k, k, S, BH, G::BN) ||
      !encode_3d<D>(&tm_v, v, S, BH, G::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  static repro::SmemOptIn opt_in;
  const cudaError_t err = opt_in.need(attention_tc<D>, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (S + BQ - 1) / BQ;
  const long long n_items = static_cast<long long>(n_qt) * BH;
  if (n_items > (1ll << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_size<D>(static_cast<int>(n_items), n_qt, S, window, causal, sms);
  attention_tc<D><<<grid, kThreads, G::kSmem, st>>>(tm_q, tm_k, tm_v, static_cast<bf16*>(o), S,
                                                    BH, window, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel's geometry at head width D, for the wrapper's
// tc_geometry: BQ, BN, stages, shared bytes, registers a thread at launch
// (from the compiled kernel), and after setmaxnreg (consumers, producer).
template <int D>
int geometry(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, attention_tc<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[7] = {BQ, Geom<D>::BN, Geom<D>::kStages, Geom<D>::kSmem, attr.numRegs,
                         kConsumerRegs, kProducerRegs};
  for (int i = 0; i < 7; ++i) out[i] = values[i];
  return 0;
}

}  // namespace tc

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int window,
           int causal, bool tensor, cudaStream_t st) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  if (tensor) return tc::launch<D>(q, k, v, o, BH, S, window, causal, scale, st);
  dim3 grid((S + ScalarGeom<D>::kRows - 1) / ScalarGeom<D>::kRows, BH);
  attention_scalar<D><<<grid, ScalarGeom<D>::kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, window, causal, scale);
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

// Writes the bf16 route's geometry at head width D into out[0..7) (see
// tc::geometry); returns a cudaError_t.
int repro_local_attention_tc_geometry(int D, int* out) {
  if (D == 32) return tc::geometry<32>(out);
  if (D == 64) return tc::geometry<64>(out);
  if (D == 128) return tc::geometry<128>(out);
  if (D == 256) return tc::geometry<256>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
