// K1's tensor-core instance at the partial-sum depths the port does not
// run (chip_smoke.py's k1_sums times them against the shipped k64 sums at
// the frame decoder's two widths). A library of its own, so that the
// shipped one (fft_block_tc.cu) builds only what the port runs.

#include "fft_block_tc.cuh"

namespace {

// The forward at width E and head dim D with partial sums of KP k16
// products (null but at the two frame decoders' shapes).
template <int KP>
Forward depth(int E, int D) {
  if (E == 128 && D == 64) return forward<128, 64, KP>;
  if (E == 512 && D == 128) return forward<512, 128, KP>;
  return nullptr;
}

}  // namespace

// fft_block_tc_forward (fft_block_tc.cu) with another depth of the
// products' partial sums: sum_k 32 or 16 k-columns a partial, or 0 (every
// product of a sum chained inside the tensor cores); at E=128 with D=64
// and E=512 with D=128 only.
extern "C" int fft_block_tc_forward_sums(const float* x, const int* lengths, const void* images,
                                         const float* bqkv, const float* bo, const float* ln1_s,
                                         const float* ln1_b, const float* b1, const float* b2,
                                         const float* ln2_s, const float* ln2_b,
                                         const float* film, int film_stride, void* ws,
                                         float* out, int B, int T, int E, int C, int H, int sum_k,
                                         void* stream_handle) {
  switch (sum_k) {
#define K1_SUMS(k, kp)                                                                          \
  case k:                                                                                       \
    return call(depth<kp>(E, head_dim(E, H)), x, lengths, images, bqkv, bo, ln1_s, ln1_b, b1, \
                b2, ln2_s, ln2_b, film, film_stride, ws, out, B, T, E, C, H, stream_handle);
    K1_SUMS(32, 2) K1_SUMS(16, 1) K1_SUMS(0, 0)
#undef K1_SUMS
    default:
      return cudaErrorInvalidValue;
  }
}
