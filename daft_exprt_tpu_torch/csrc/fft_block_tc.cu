// K1's tensor-core instance as the port runs it: the three launches of
// fft_block_tc.cuh (which states the design) at every width and head dim
// with k64 partial sums, and the plan's and the checks' queries.
// fft_block_tc_sums.cu builds the other sum depths, for timing only.

#include <vector>

#include "fft_block_tc.cuh"

namespace {

// The shipped forward at width E and head dim D (null outside the
// instance).
Forward shipped(int E, int D) {
  switch (E * 1000 + D) {
#define K1_FORWARD(e, d) \
  case e * 1000 + d:     \
    return forward<e, d, 4>;
    K1_FORWARD(128, 16) K1_FORWARD(128, 64) K1_FORWARD(128, 128)
    K1_FORWARD(256, 16) K1_FORWARD(256, 64) K1_FORWARD(256, 128)
    K1_FORWARD(512, 16) K1_FORWARD(512, 64) K1_FORWARD(512, 128)
#undef K1_FORWARD
    default: return nullptr;
  }
}

}  // namespace

// Bytes of device scratch one call needs (-1 outside the instance): the
// q, k and v images over T rounded up to 64 rows, a in f32 and its bf16
// image, and conv2's f32 partial sums where launch 3 runs in chunks.
extern "C" long long fft_block_tc_workspace_bytes(int B, int T, int E, int C, int H) {
  if (!takes(B, T, E, C, H)) return -1;
  Carve cv{nullptr};
  carve(cv, B, T, E, C);
  return (long long)cv.used;
}

// The largest dynamic shared memory of the instance's launches at width
// E, H heads and C conv channels (launch 3 at its largest chunk and its
// smallest cluster): what the wrapper's plan mirrors (0 outside the
// instance).
extern "C" long long fft_block_tc_smem_bytes(int E, int H, int C) {
  return takes(1, 1, E, C, H) ? (long long)smem_bytes(E, H, C) : 0;
}

// Launch 3's cluster size for a call, at its first chunk (0 outside the
// instance).
extern "C" int fft_block_tc_cluster_size(int B, int T, int E, int C, int H) {
  return takes(B, T, E, C, H) ? pick_cluster(B, T, E, chunk_lo(C / 64, conv_chunks(E, C), 1)) : 0;
}

// x, out (B, T, E) f32; images: the bf16 dot-weight images (Wqkv, Wo, W1,
// W2, ops/fft_block.py pack_images); the vectors f32; film (B rows
// film_stride floats apart, [gammas | betas]) or null; lengths (B,) int32;
// ws: fft_block_tc_workspace_bytes bytes. Every pointer 16-byte aligned.
// Returns the first CUDA error (0 on success).
extern "C" int fft_block_tc_forward(const float* x, const int* lengths, const void* images,
                                    const float* bqkv, const float* bo, const float* ln1_s,
                                    const float* ln1_b, const float* b1, const float* b2,
                                    const float* ln2_s, const float* ln2_b, const float* film,
                                    int film_stride, void* ws, float* out, int B, int T, int E,
                                    int C, int H, void* stream_handle) {
  return call(shipped(E, head_dim(E, H)), x, lengths, images, bqkv, bo, ln1_s, ln1_b, b1, b2,
              ln2_s, ln2_b, film, film_stride, ws, out, B, T, E, C, H, stream_handle);
}

// The edges of a captured CUDA graph: out[0] all, out[1] the programmatic
// ones (a launch with programmatic stream serialization, captured, becomes
// such an edge from the kernel it depends on). chip_smoke's check that
// K1's three launches keep their overlap inside the engine's graphs.
extern "C" int fft_block_tc_graph_edges(void* graph, long long* out) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
  if ((err = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n)) != cudaSuccess)
    return err;
  long long programmatic = 0;
  for (size_t i = 0; i < n; ++i) programmatic += data[i].type == cudaGraphDependencyTypeProgrammatic;
  out[0] = (long long)n;
  out[1] = programmatic;
  return cudaSuccess;
}
