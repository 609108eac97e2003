// bf16 tensor-core building blocks for sm_90a, shared by the training
// attention (K2, attention_train.cu) and the C-blocked training conv-FF
// (K4, conv_ff_blocked_tc.cu): cp.async copies into shared memory,
// ldmatrix operand loads and mma.sync m16n8k16 bf16 -> f32.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t holds the
// accumulator's rows g and g + 8 at columns 2t, 2t + 1; the A operand the
// same rows over k = 2t, 2t + 1 and 2t + 8, 2t + 9; the B operand column
// g over the same k.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when
// !valid (the source is then not read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N groups (the tiles being prefetched) are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_wait_one() { cp_wait<1>(); }

__device__ __forceinline__ void cp_wait_all() { cp_wait<0>(); }

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 operands, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with the 16 products summed from zero on the tensor cores and
// that sum added to c by a rounded float32 add. mma.sync does not round its
// accumulation to nearest: chained over a long K, its sums drift further
// from the exact ones than float32 sums do; this keeps each chained term
// short.
__device__ __forceinline__ void mma_rn(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// Two floats rounded to bf16 (nearest even, as rnd()), low half first.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of the next product from two n8 accumulator tiles of one
// 16-column step: the m16n8 accumulator layout (row g / g + 8, columns
// 2t, 2t + 1) is the m16k16 A layout's, split in two column halves.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// This lane's ldmatrix row address for the 16 x 16 block at (r0, c0) of a
// tile with row stride LD. a_addr: an A operand (rows = m, columns = k),
// or with ldsm_t a B operand whose k runs along the tile's rows; the four
// registers are then b0, b1 of the n8 tile c0.. and b0, b1 of c0 + 8...
// b_addr: a B operand whose n runs along the tile's rows (ldsm, no
// transpose): b0, b1 of rows r0..r0 + 7, then of rows r0 + 8...; or with
// ldsm_t an A operand whose k runs along the tile's rows (m = columns c0..).
template <int LD>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int c0, int lane) {
  return tile + 2 * ((r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int r0, int c0, int lane) {
  return tile + 2 * ((r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 + ((lane >> 3) & 1) * 8);
}

}  // namespace tc
}  // namespace
