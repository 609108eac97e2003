// Counter-based dropout bits shared by the training kernels (K2, K3).
//
// Bit-equal to daft_exprt_tpu/ops/attention_train.py:_hash_bits: murmur3
// fmix32 over seed + salt * 0x9E3779B9 + row * 0x85EBCA6B + col *
// 0xC2B2AE35. The JAX code multiplies wrapping int32s and shifts
// logically, which is uint32 arithmetic bit for bit. An element is kept
// iff its bits are >= round(rate * 2^32) (see dropout_threshold in the
// Python wrappers).

#pragma once

#include <stdint.h>

// The hash's terms that do not depend on the column: a kernel that hashes
// many columns of one row computes this once per row.
__device__ __forceinline__ uint32_t dropout_row(uint32_t seed, uint32_t salt, uint32_t row) {
  return seed + salt * 0x9E3779B9u + row * 0x85EBCA6Bu;
}

__device__ __forceinline__ uint32_t dropout_col(uint32_t col) { return col * 0xC2B2AE35u; }

// fmix32 of dropout_row(...) + dropout_col(col).
__device__ __forceinline__ uint32_t dropout_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t salt,
                                                 uint32_t row, uint32_t col) {
  return dropout_mix(dropout_row(seed, salt, row) + dropout_col(col));
}
