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
// Design: one block per segment reads its own CSR range (the TPU kernel's
// one-hot membership matmul over 128-segment blocks is not needed), threads
// own 4 adjacent columns, so a warp reads whole 256- or 512-byte row
// segments. Each column is summed in row order by one thread: deterministic,
// no atomics.
#include "common.cuh"

namespace {

template <typename T, int VEC>
__global__ void segment_sum_kernel(const T* __restrict__ vals,
                                   const int* __restrict__ offn, int f,
                                   T* __restrict__ out) {
  const int seg = blockIdx.x;
  const int start = offn[seg];
  const int end = offn[seg + 1];
  for (int g = threadIdx.x; g < f / VEC; g += blockDim.x) {
    const int col = g * VEC;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int e = start; e < end; ++e) {
      float x[VEC];
      load_vec<VEC>(vals + static_cast<size_t>(e) * f + col, x);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += x[v];
    }
    store_vec<VEC>(out + static_cast<size_t>(seg) * f + col, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* vals, const int* offn, int num_segments, int f,
                   void* out, cudaStream_t stream) {
  int threads = ((f / VEC + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  segment_sum_kernel<T, VEC><<<num_segments, threads, 0, stream>>>(
      static_cast<const T*>(vals), offn, f, static_cast<T*>(out));
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
  const bool vec4 = (f % 4 == 0) && (addr % 16 == 0);
  cudaError_t err;
  if (is_bf16) {
    err = vec4 ? launch<bf16, 4>(vals, offn, num_segments, f, out, s)
               : launch<bf16, 1>(vals, offn, num_segments, f, out, s);
  } else {
    err = vec4 ? launch<float, 4>(vals, offn, num_segments, f, out, s)
               : launch<float, 1>(vals, offn, num_segments, f, out, s);
  }
  return static_cast<int>(err);
}
