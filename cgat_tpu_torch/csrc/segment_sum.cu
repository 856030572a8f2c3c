// Sorted CSR segment sum: the backward of the node-table gathers.
//
// Replaces the TPU kernel cgat_tpu/ops/pallas/segment_sum.py: _kernel
// (launched by csr_segment_sum). For rows sorted by segment id and the
// unclamped CSR pointers offn of those ids:
//
//   out[n, c] = sum_{offn[n] <= e < offn[n+1]} vals[e, c]
//
// f32 accumulation, output in the input dtype. Every row counts, padding
// included (padded edges point at the last node slot), as in the JAX
// package's GatherPlan with unclamped host pointers.
//
// Bound on the H100: bytes. At the flagship gather backward (E = 19968
// edges, F = 128, N = 832 node slots, bf16) the kernel must read vals once
// (5.1 MB) and write out (0.2 MB): ~1.6 us at 3.35 TB/s, against 2.6 M adds.
//
// Design: a block of 8 warps per segment, over its own CSR range (the TPU
// kernel's one-hot membership matmul over 128-segment blocks is not
// needed). Each thread loads 16 bytes (8 bf16 or 4 f32 columns); a row
// takes `lpr` threads (16 for bf16 F = 128), so the block covers 256 / lpr
// rows at once, and each thread issues 8 rows' loads before adding any:
// 128 rows (32 KB) in flight per segment: a segment of the step's ~24 rows
// costs one round trip to memory, and the padded edges' segment (up to
// ~1,000 rows on the last node slot) about eight. The row groups meet in a
// fixed xor-shuffle tree within a warp and then in warp order, so every
// sum is taken in the same order in every launch: deterministic, no
// atomics. F not a multiple of the vector (or unaligned data) takes the
// same path one element a thread.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;   // warps per segment
constexpr int UNROLL = 8;  // rows a thread has in flight

// V consecutive elements as f32: 16 bytes (V = 8 bf16, V = 4 f32) or one
template <int V>
__device__ __forceinline__ void load(const bf16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = a.x;
      v[2 * i + 1] = a.y;
    }
  } else {
    load_vec<V>(p, v);
  }
}

template <int V>
__device__ __forceinline__ void load(const float* p, float* v) {
  load_vec<V>(p, v);
}

// block: WARPS warps per segment (blockIdx.x). A thread owns vector `sub`
// of the row chunk [c0, c0 + lpr) and rows start + grp, start + grp + rp,
// ... with rp = 32 * WARPS / lpr row groups; each warp adds its row groups
// in an xor-shuffle tree, then the warps' sums meet in warp order.
template <typename T, int V>
__global__ void __launch_bounds__(WARPS * 32)
segment_sum_kernel(const T* __restrict__ vals, const int* __restrict__ offn,
                   int f, int lpr_log2, T* __restrict__ out) {
  __shared__ float red[WARPS][32 * V];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int seg = blockIdx.x;
  const int lpr = 1 << lpr_log2;
  const int rp = (32 * WARPS) >> lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const int grp = threadIdx.x >> lpr_log2;
  const int start = offn[seg];
  const int end = offn[seg + 1];
  const int vecs = f / V;
  // the chunk loop's trip count is the same for every thread of the block,
  // so all reach the shuffles and barriers
  for (int c0 = 0; c0 < vecs; c0 += lpr) {
    const bool active = c0 + sub < vecs;
    const T* col = vals + (c0 + sub) * V;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    if (active)
      // UNROLL rows' loads in flight before any add; rows past the end
      // load nothing and add 0, which changes no sum
      for (int e = start + grp; e < end; e += UNROLL * rp) {
        float x[UNROLL][V];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (e + u * rp < end) {
            load<V>(col + static_cast<size_t>(e + u * rp) * f, x[u]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) x[u][v] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += x[u][v];
      }
    // the warp's row groups, in a fixed tree
    for (int off = lpr; off < 32; off <<= 1)
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
    if (lane < lpr)
#pragma unroll
      for (int v = 0; v < V; ++v) red[warp][lane * V + v] = acc[v];
    __syncthreads();
    // the warps' sums in warp order, one column a thread
    for (int i = threadIdx.x; i < lpr * V; i += WARPS * 32) {
      const int c = c0 * V + i;
      if (c < f) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += red[w][i];
        store_vec<1>(out + static_cast<size_t>(seg) * f + c, &sum);
      }
    }
    __syncthreads();   // red is reused by the next chunk
  }
}

template <typename T, int V>
cudaError_t launch(const void* vals, const int* offn, int num_segments, int f,
                   void* out, cudaStream_t stream) {
  const int vecs = f / V;
  int lpr_log2 = 0;
  while ((1 << lpr_log2) < vecs && lpr_log2 < 5) ++lpr_log2;
  segment_sum_kernel<T, V><<<num_segments, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(vals), offn, f, lpr_log2, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// vals: (E, f) bf16 (is_bf16) or f32, rows sorted by segment, C-contiguous;
// offn: (>= num_segments + 1,) int32 unclamped CSR pointers; out:
// (num_segments, f) in the input dtype.
CGAT_EXPORT int cgat_segment_sum(const void* vals, const int* offn,
                                 int num_segments, int f, int is_bf16,
                                 void* out, void* stream) {
  if (num_segments <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(vals) |
                         reinterpret_cast<uintptr_t>(out);
  // 16-byte vectors need 16-byte aligned rows
  const bool vec = addr % 16 == 0 && (f * (is_bf16 ? 2 : 4)) % 16 == 0;
  cudaError_t err;
  if (is_bf16) {
    err = vec ? launch<bf16, 8>(vals, offn, num_segments, f, out, s)
              : launch<bf16, 1>(vals, offn, num_segments, f, out, s);
  } else {
    err = vec ? launch<float, 4>(vals, offn, num_segments, f, out, s)
              : launch<float, 1>(vals, offn, num_segments, f, out, s);
  }
  return static_cast<int>(err);
}
