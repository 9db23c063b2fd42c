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
// -inf), out = acc / max(l, 1e-30).  q, k, v and out are float or bf16;
// every product and sum is fp32.
//
// Bound: at prefill (BH = 256, S = 512, D = 64, causal) the kernel does
// 4 * D operations per (query, key) pair it keeps, 8.6 GFLOP, against
// 67 MB of bf16 operands: at the tensor cores' rate the bytes would bind
// (0.020 ms against 0.009 ms), but this kernel runs its products as fp32
// FMA on the CUDA cores, where the operations bind (0.13 ms at 67 TFLOP/s).
//
// Design.  One block of 64 threads per 64-query tile of one (batch*head);
// each thread owns one query row, holding q and acc (D floats each) in
// registers, so the softmax needs no cross-thread reduction.  The block
// walks only the key tiles its rows need (the causal and window skip of the
// TPU kernel): from the tile of the oldest key in the window of its first
// row to the tile of its last row.  Each 32-key tile of K and V is staged in
// shared memory as fp32 and read by all threads at the same address (a
// broadcast).  Keys past S in a ragged last tile are masked.  No atomics:
// the same inputs give the same bits on every launch.  D is 32 or 64: two
// D-float register arrays per thread must fit the 255-register limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per block, one per thread
constexpr int BKV = 32;  // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
local_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int window,
                       int causal, float scale) {
  __shared__ __align__(16) float ks[BKV][D];
  __shared__ __align__(16) float vs[BKV][D];
  const int q_lo = blockIdx.x * BQ;
  const int qi = q_lo + threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = qi < S ? to_f(q[base + static_cast<size_t>(qi) * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int q_last = min(q_lo + BQ, S) - 1;
  const int key_last = causal ? q_last : S - 1;
  const int key_first = window ? max(0, q_lo - window + 1) : 0;
  for (int t0 = (key_first / BKV) * BKV; t0 <= key_last; t0 += BKV) {
    for (int e = threadIdx.x; e < BKV * D; e += BQ) {
      const int j = e / D, d = e % D;
      const int kpos = t0 + j;
      const size_t off = base + static_cast<size_t>(kpos) * D + d;
      ks[j][d] = kpos < S ? to_f(k[off]) : 0.f;
      vs[j][d] = kpos < S ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[BKV];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
        dot = fmaf(qr[4 * d4], kv.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
      }
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
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] = fmaf(s[j], vv.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(s[j], vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(s[j], vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(s[j], vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* out = o + base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = from_f<T>(acc[d] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int window,
           int causal, cudaStream_t st) {
  dim3 grid((S + BQ - 1) / BQ, BH);
  local_attention_kernel<T, D><<<grid, BQ, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, window, causal, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the launch's cudaError_t.
int repro_local_attention(const void* q, const void* k, const void* v, void* o, int BH, int S,
                          int D, int window, int causal, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH > 65535 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, BH, S, window, causal, st)
                           : launch<float, 64>(q, k, v, o, BH, S, window, causal, st);
  if (D == 32) return bf16 ? launch<__nv_bfloat16, 32>(q, k, v, o, BH, S, window, causal, st)
                           : launch<float, 32>(q, k, v, o, BH, S, window, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
