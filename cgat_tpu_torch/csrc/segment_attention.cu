// Segment softmax + weighted aggregation over destination-sorted edges.
//
// Replaces the TPU kernel cgat_tpu/ops/pallas/segment_attention.py:
// _fwd_kernel (launched by _fwd_impl). For every destination node n and
// column c of the flat (E, H*F) inputs:
//
//   out[n, c] = sum_{e -> n} exp(a[e,c] - max_n[c]) * m[e,c]
//               / (sum_{e -> n} exp(a[e,c] - max_n[c]) + 1e-16)
//
// where max_n is the exact per-node column max. Node n's in-edges are the
// contiguous run [offn[n], offn[n+1]) of the sorted edge arrays, clamped to
// the real-edge count, so padded edges (a suffix) never count and a node
// with no in-edge gets 0.
//
// Bound on the H100: bytes. At the flagship message-passing shape (E = 18432
// edges, H*F = 640, bf16) the kernel must read alpha and m once (47 MB) and
// write out (1 MB): ~14 us at 3.35 TB/s, against ~60 M exp/add/fma
// operations, under 1 us at the card's f32 rate.
//
// Design: one block per destination node (the TPU kernel's one-hot
// membership matmuls over 128-node blocks are not needed: a block reads its
// own CSR range). Threads own 4 adjacent columns each, so each warp reads
// whole 256- or 512-byte row segments. Two passes over the node's ~24 edges:
// the first finds the exact column max, the second re-reads the rows (now in
// L1/L2) and accumulates the exp-sum and the weighted sum in f32. The
// optional f32 max/den outputs are what a backward kernel needs.
#include "common.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr float SOFTMAX_EPS = 1e-16f;

template <typename T, int VEC>
__global__ void segment_attention_fwd(const T* __restrict__ alpha,
                                      const T* __restrict__ m,
                                      const int* __restrict__ offn,
                                      const int* __restrict__ n_real,
                                      int hf, T* __restrict__ out,
                                      float* __restrict__ max_out,
                                      float* __restrict__ den_out) {
  const int node = blockIdx.x;
  const int real = *n_real;
  const int start = min(offn[node], real);
  const int end = min(offn[node + 1], real);
  const int groups = hf / VEC;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int col = g * VEC;
    float mx[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) mx[v] = NEG_BIG;
    for (int e = start; e < end; ++e) {
      float a[VEC];
      load_vec<VEC>(alpha + static_cast<size_t>(e) * hf + col, a);
#pragma unroll
      for (int v = 0; v < VEC; ++v) mx[v] = fmaxf(mx[v], a[v]);
    }
    float den[VEC], num[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) { den[v] = 0.f; num[v] = 0.f; }
    for (int e = start; e < end; ++e) {
      float a[VEC], mv[VEC];
      load_vec<VEC>(alpha + static_cast<size_t>(e) * hf + col, a);
      load_vec<VEC>(m + static_cast<size_t>(e) * hf + col, mv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float ex = expf(a[v] - mx[v]);
        den[v] += ex;
        num[v] = fmaf(ex, mv[v], num[v]);
      }
    }
    float o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) o[v] = num[v] / (den[v] + SOFTMAX_EPS);
    const size_t at = static_cast<size_t>(node) * hf + col;
    store_vec<VEC>(out + at, o);
    if (max_out != nullptr) store_vec<VEC>(max_out + at, mx);
    if (den_out != nullptr) store_vec<VEC>(den_out + at, den);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* alpha, const void* m, const int* offn,
                   const int* n_real, int num_nodes, int hf, void* out,
                   float* max_out, float* den_out, cudaStream_t stream) {
  const int groups = hf / VEC;
  int threads = ((groups + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  segment_attention_fwd<T, VEC><<<num_nodes, threads, 0, stream>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(m), offn, n_real,
      hf, static_cast<T*>(out), max_out, den_out);
  return cudaGetLastError();
}

}  // namespace

// alpha, m: (E, hf) of one dtype (bf16 if is_bf16 else f32), C-contiguous;
// offn: (>= num_nodes + 1,) int32 unclamped CSR pointers over the sorted
// destinations; n_real: device int32 scalar, the real-edge count; out:
// (num_nodes, hf) in the input dtype; max_out, den_out: optional
// (num_nodes, hf) f32 (null to skip).
CGAT_EXPORT int cgat_segment_attention_fwd(const void* alpha, const void* m,
                                           const int* offn, const int* n_real,
                                           int num_nodes, int hf, int is_bf16,
                                           void* out, float* max_out,
                                           float* den_out, void* stream) {
  if (num_nodes <= 0 || hf <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(alpha) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(max_out) |
                         reinterpret_cast<uintptr_t>(den_out);
  const bool vec4 = (hf % 4 == 0) && (addr % 16 == 0);
  cudaError_t err;
  if (is_bf16) {
    err = vec4 ? launch<bf16, 4>(alpha, m, offn, n_real, num_nodes, hf, out,
                                 max_out, den_out, s)
               : launch<bf16, 1>(alpha, m, offn, n_real, num_nodes, hf, out,
                                 max_out, den_out, s);
  } else {
    err = vec4 ? launch<float, 4>(alpha, m, offn, n_real, num_nodes, hf, out,
                                  max_out, den_out, s)
               : launch<float, 1>(alpha, m, offn, n_real, num_nodes, hf, out,
                                  max_out, den_out, s);
  }
  return static_cast<int>(err);
}
