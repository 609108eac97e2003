// The bf16 tensor-core attention building blocks of the training
// attention (K2, attention_train.cu) and the inference FFT block's
// tensor-core instance (K1, fft_block_tc.cu): 64-row bf16 tiles of one
// head in dynamic shared memory (cp.async, rows padded by 16 bytes so that
// ldmatrix is free of bank conflicts), a warp's 16 query rows as A
// fragments, S = Q K^T and P V on mma.sync m16n8k16 bf16 -> f32, and the
// stores of a warp's 16 x D accumulator.

#pragma once

#include "mma_bf16.cuh"

namespace {
namespace tc {

constexpr int WARPS = 4, THREADS = 32 * WARPS;
// Rows a block owns (16 per warp: query rows in the forward and dq, key
// rows in dk-dv) and rows per streamed tile (keys, or queries in dk-dv).
constexpr int ROWS = 16 * WARPS, TILE = 64;
static_assert(ROWS == TILE, "owned and streamed tiles share one layout");

// Shared-memory row of D bf16 padded by 16 bytes: the 8 rows one ldmatrix
// phase reads then fall on distinct 16-byte bank groups.
template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }
template <int D>
__host__ __device__ constexpr int tile_elems() { return TILE * ld<D>(); }

// Dynamic shared memory of the forward (and K2's dq): two stages of
// (K, V); the block's own Q (and G) tiles wait in a stage that is not
// yet streamed until their fragments are in registers, so that three
// blocks fit on an SM at D=128.
template <int D>
constexpr size_t key_smem() { return 4 * tile_elems<D>() * sizeof(bf16); }

// Rows [r0, r0 + TILE) of head h (columns h D ..) of a bf16 matrix of T
// rows with row stride E into a tile; rows at or past T read as zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int T, int E,
                                          int h) {
  constexpr int CH = D / 8, LD = ld<D>();  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool valid = r0 + r < T;
    cp16(saddr(dst + r * LD + c * 8), src + (size_t)(valid ? r0 + r : 0) * E + h * D + c * 8,
         valid);
  }
}

// S = Q K^T for 16 rows of this warp and the 16 keys at tile row c0:
// qf holds the warp's A fragments over D, the tile holds the keys. RN:
// each k16 term added by a rounded float32 add (tc::mma_rn).
template <int D, bool RN = false>
__device__ __forceinline__ void scores16(float (&s)[2][4], const uint32_t (&qf)[D / 16][4],
                                         uint32_t tile, int c0, int lane) {
  constexpr int LD = ld<D>();
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t b[4];
    ldsm(b, b_addr<LD>(tile, c0, ks * 16, lane));
    if (RN) {
      mma_rn(s[0], qf[ks], b[0], b[1]);
      mma_rn(s[1], qf[ks], b[2], b[3]);
    } else {
      mma(s[0], qf[ks], b[0], b[1]);
      mma(s[1], qf[ks], b[2], b[3]);
    }
  }
}

// acc (16 x D) += a (16 x 16) * the 16 tile rows at r0 (k runs along the
// tile's rows: ldmatrix with transpose). RN: as scores16.
template <int D, bool RN = false>
__device__ __forceinline__ void accumulate16(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                             uint32_t tile, int r0, int lane) {
  constexpr int LD = ld<D>();
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    uint32_t b[4];
    ldsm_t(b, a_addr<LD>(tile, r0, dn * 16, lane));
    if (RN) {
      mma_rn(acc[2 * dn], a, b[0], b[1]);
      mma_rn(acc[2 * dn + 1], a, b[2], b[3]);
    } else {
      mma(acc[2 * dn], a, b[0], b[1]);
      mma(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// This warp's A fragments of rows [r0, r0 + 16) over D from a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4], uint32_t tile, int r0,
                                       int lane) {
  constexpr int LD = ld<D>();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm(f[ks], a_addr<LD>(tile, r0, ks * 16, lane));
}

// A 16 x D f32 accumulator (rows r0 + g, r0 + g + 8) to (T, E) device
// memory at head h, rows at or past T skipped; f32 as float2, bf16 as
// bfloat162.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}

template <int D, typename Out>
__device__ __forceinline__ void store_rows(Out* dst, const float (&acc)[D / 8][4], int r0,
                                           int T, int E, int h, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= T) continue;
    Out* p = dst + (size_t)row * E + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) store_pair(p + n * 8, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

}  // namespace tc
}  // namespace
