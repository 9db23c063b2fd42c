// Shared device helpers of the tensor-core fp32 kernels (subspace_apply.cu,
// ssd_scan.cu): float32 products on the TF32 tensor cores in three passes
// ("3xTF32"), and cp.async copies from global to shared memory.
//
// 3xTF32.  A float32 x splits into hi = tf32(x) (round to nearest, 11
// significant bits) and lo = x - hi, exact in fp32 with |lo| <= 2^-11 |x|;
// lo goes to the tensor cores as its fp32 bits, whose low 13 bits the TF32
// product ignores (a truncation of at most 2^-10 |lo|).  A product a * b is
// then taken as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b with fp32
// accumulation: the dropped lo_a * lo_b and the truncation of lo leave
// about 2^-20 of |a b|, where one TF32 pass would leave 2^-11.  The small terms go first, so they are added before
// the large one swamps the accumulator; see mma_3xtf32 for where the sums
// across k-steps are taken.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi + lo == x exactly; the tensor cores read lo to 2^-21 of |x| (above).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8, row) @ b (8 x 8, col), TF32 in, fp32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): a = {A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, c = {C[g][2t],
// C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// t += a @ b in 3xTF32 inside one fragment (the caller bounds how many
// steps share it; see mma_3xtf32).
__device__ __forceinline__ void mma_3xtf32_into(float (&t)[4], const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                                const uint32_t (&bl)[2]) {
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
}

// c += a @ b in 3xTF32 from the split fragments of a and b.  The three
// passes accumulate into a zeroed fragment, which is then added to c by
// ordinary fp32 adds: the tensor cores' own accumulation rounds toward zero,
// and a long chain of it inside one fragment (K = 128, or the thousands of
// rows of a Gram) drifts by one truncation per pass, all in one direction.
// Kept to one k-step, the truncation bounds the error of that step's eight
// products only, and the sum across steps rounds to nearest.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32_into(t, ah, al, bh, bl);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// Split four A values / two B values into their hi and lo fragments.
__device__ __forceinline__ void split_a(const float (&v)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}
__device__ __forceinline__ void split_b(float v0, float v1, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split_tf32(v0, hi[0], lo[0]);
  split_tf32(v1, hi[1], lo[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (both 16-byte aligned); zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace repro
