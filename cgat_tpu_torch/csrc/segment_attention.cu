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
// optional f32 max/den outputs are what the backward kernel needs.
//
// Backward: replaces _bwd_kernel (launched by _bwd_call). Per real edge
// e -> n and column c, with q = g[n] / (den[n] + 1e-16):
//
//   dm[e, c] = exp(a[e,c] - max_n[c]) * q[n, c]
//   dalpha[e, c] = dm[e, c] * (m[e,c] - out[n, c])
//
// and 0 for padded edges (e >= n_real). It reads the f32 max and den the
// forward wrote, never a bf16-rounded max. Bound: bytes. At the flagship
// shape it reads alpha and m and writes dalpha and dm, four (E, 640) bf16
// arrays (102 MB), plus the node arrays g, out, max and den (6.4 MB):
// ~32 us at 3.35 TB/s. Design: edge-parallel, one thread per 4 adjacent
// columns of one edge row; each edge reads its destination's node rows
// directly through its dst id (the TPU kernel's one-hot gather matmul over
// a node window is not needed). The node rows are re-read by the ~24 edges
// of each node from L1/L2. q is formed in the kernel, so no (N, H*F) q
// array is written.
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

template <typename T, int VEC>
__global__ void segment_attention_bwd(
    const T* __restrict__ alpha, const T* __restrict__ m,
    const int* __restrict__ ids, const int* __restrict__ n_real,
    const T* __restrict__ g, const T* __restrict__ out,
    const float* __restrict__ max_in, const float* __restrict__ den_in,
    int n_rows, int hf, T* __restrict__ dalpha, T* __restrict__ dm) {
  const int groups = hf / VEC;
  const int64_t total = static_cast<int64_t>(n_rows) * groups;
  const int real = *n_real;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(t / groups);
    const int col = static_cast<int>(t % groups) * VEC;
    const size_t at = static_cast<size_t>(e) * hf + col;
    float da[VEC], dmv[VEC];
    if (e < real) {
      const size_t nat = static_cast<size_t>(ids[e]) * hf + col;
      float a[VEC], mv[VEC], gv[VEC], o[VEC], mx[VEC], den[VEC];
      load_vec<VEC>(alpha + at, a);
      load_vec<VEC>(m + at, mv);
      load_vec<VEC>(g + nat, gv);
      load_vec<VEC>(out + nat, o);
      load_vec<VEC>(max_in + nat, mx);
      load_vec<VEC>(den_in + nat, den);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float q = gv[v] / (den[v] + SOFTMAX_EPS);
        dmv[v] = expf(a[v] - mx[v]) * q;
        da[v] = dmv[v] * (mv[v] - o[v]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) { da[v] = 0.f; dmv[v] = 0.f; }
    }
    store_vec<VEC>(dalpha + at, da);
    store_vec<VEC>(dm + at, dmv);
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* alpha, const void* m, const int* ids,
                       const int* n_real, const void* g, const void* out,
                       const float* max_in, const float* den_in, int n_rows,
                       int hf, void* dalpha, void* dm, cudaStream_t stream) {
  constexpr int THREADS = 256;
  const int64_t total = static_cast<int64_t>(n_rows) * (hf / VEC);
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 65535 * 16 ? want : 65535 * 16);
  segment_attention_bwd<T, VEC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(m), ids, n_real,
      static_cast<const T*>(g), static_cast<const T*>(out), max_in, den_in,
      n_rows, hf, static_cast<T*>(dalpha), static_cast<T*>(dm));
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

// alpha, m, dalpha, dm: (n_rows, hf) of one dtype (bf16 if is_bf16 else
// f32), C-contiguous; ids: (n_rows,) int32 destination per row; n_real:
// device int32 scalar, the real-row count; g, out: (num_nodes, hf) in the
// input dtype; max_in, den_in: (num_nodes, hf) f32 from the forward.
CGAT_EXPORT int cgat_segment_attention_bwd(
    const void* alpha, const void* m, const int* ids, const int* n_real,
    const void* g, const void* out, const float* max_in, const float* den_in,
    int n_rows, int hf, int is_bf16, void* dalpha, void* dm, void* stream) {
  if (n_rows <= 0 || hf <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(alpha) | reinterpret_cast<uintptr_t>(m) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(max_in) |
      reinterpret_cast<uintptr_t>(den_in) |
      reinterpret_cast<uintptr_t>(dalpha) | reinterpret_cast<uintptr_t>(dm);
  const bool vec4 = (hf % 4 == 0) && (addr % 16 == 0);
  cudaError_t err;
  if (is_bf16) {
    err = vec4 ? launch_bwd<bf16, 4>(alpha, m, ids, n_real, g, out, max_in,
                                     den_in, n_rows, hf, dalpha, dm, s)
               : launch_bwd<bf16, 1>(alpha, m, ids, n_real, g, out, max_in,
                                     den_in, n_rows, hf, dalpha, dm, s);
  } else {
    err = vec4 ? launch_bwd<float, 4>(alpha, m, ids, n_real, g, out, max_in,
                                      den_in, n_rows, hf, dalpha, dm, s)
               : launch_bwd<float, 1>(alpha, m, ids, n_real, g, out, max_in,
                                      den_in, n_rows, hf, dalpha, dm, s);
  }
  return static_cast<int>(err);
}
