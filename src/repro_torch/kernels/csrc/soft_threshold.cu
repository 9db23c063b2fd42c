// Elementwise soft threshold for Hopper (sm_90a):
//
//   out = sign(x) * max(|x| - t, 0)
//
// Replaces the Pallas TPU kernel src/repro/kernels/soft_threshold.py::
// soft_threshold (the RPCA shrinkage operator over a 2-D array).  x and out
// are float or bf16; the threshold t is a float, either passed by value or
// read from a device pointer (a 0-d tensor on the card, never copied to the
// host).  The arithmetic is tail_common.cuh's shrink in fp32, rounded once
// to the element type; x == 0 is returned as it is, so a negative t keeps
// sign(0) = 0 as the plain version does.
//
// Bound: 4 (float) or 2 (bf16) bytes read and written per element and three
// operations, so device-memory bytes bind: 63 MB for the (196608, 40) float
// bucket of path B flattened, 0.019 ms at 3.35 TB/s.
//
// Design.  One 16-byte vector a thread (4 floats or 8 bf16) when the
// pointers are 16-byte aligned, enough blocks to cover the array once (a
// grid-stride loop past 2^20 blocks), then the remaining elements one by
// one.  No reduction: the same inputs give the same bits on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tail_common.cuh"

namespace {

constexpr long long kMaxBlocks = 1 << 20;  // past this, threads loop

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T apply(T v, float t) {
  const float z = to_f(v);
  return z == 0.f ? v : from_f<T>(repro::shrink(z, t));
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
soft_threshold_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                      const float* __restrict__ t_ptr, float t_val, int vec) {
  const float t = t_ptr != nullptr ? *t_ptr : t_val;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = first; i < nv; i += stride) {
      uint4 raw = xv[i];
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = apply<T>(e[k], t);
      ov[i] = raw;
    }
    done = nv * V;
  }
  for (long long i = done + first; i < n; i += stride) out[i] = apply<T>(x[i], t);
}

template <typename T>
int launch(const void* x, void* out, long long n, const float* t_ptr, float t_val, int vec,
           cudaStream_t st) {
  const long long items = vec ? n / (16 / sizeof(T)) + n % (16 / sizeof(T)) : n;
  long long blocks = (items + repro::kThreads - 1) / repro::kThreads;
  blocks = blocks > kMaxBlocks ? kMaxBlocks : blocks;
  soft_threshold_kernel<T><<<static_cast<int>(blocks), repro::kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, t_ptr, t_val, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the launch's cudaError_t.  t_ptr
// is a device float or null (then t_val is the threshold); vec says both
// pointers are 16-byte aligned.
int repro_soft_threshold(const void* x, void* out, long long n, const void* t_ptr,
                         float t_val, int bf16, int vec, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(t_ptr);
  return bf16 ? launch<__nv_bfloat16>(x, out, n, tp, t_val, vec, st)
              : launch<float>(x, out, n, tp, t_val, vec, st);
}

}  // extern "C"
