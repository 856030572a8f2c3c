// Dropout with its masks drawn on the card: out = keep ? x * scale : 0.
//
// The port's own kernel: cgat_tpu draws its dropout masks with XLA's RNG
// (flax.linen.Dropout), not with a Pallas kernel, so there is no TPU kernel
// it replaces. It exists so that a CUDA graph of a training step draws new
// masks at every replay: the masks come from Philox4x32-10 (Salmon et al.,
// "Parallel random numbers: as easy as 1, 2, 3", SC 2011; the constants of
// Random123), written out here, keyed by two uint32 the host derives from
// the dropout site's static path (seed[, dp index, edge index], site) and
// counted by
//
//   counter = (q as two uint32, step as two uint32),  q = element / 4
//
// with `step` read from a device int64 the trainer advances inside the
// step, so no host value is baked into a capture. Element i takes word
// i % 4 of its counter's output and is kept when (word >> 8) < threshold,
// threshold = round((1 - rate) * 2**24): an integer test, so the plain
// PyTorch version (cgat_tpu_torch/ops/kernels/dropout.py) draws the same
// masks bit for bit. The kept values are x * scale with scale the f32 value
// of 1 / (1 - rate), rounded once to x's dtype. The backward is this kernel
// on the incoming gradient: the same key, counter and step give the same
// mask, so no mask is stored.
//
// Bound on the H100: bytes. x is read once and out written once: at the
// training step's node-layer site (18,432 edge rows, 5 heads of 128, bf16)
// 2 x 23.6 MB, ~14 us at 3.35 TB/s; Philox's 10 rounds of two 32-bit
// multiplies for every 4 elements are ~2.5 integer operations an element
// and stay under that.
//
// Design: one thread for each counter, i.e. for 4 consecutive elements,
// loaded and stored as one 16-byte (f32) or 8-byte (bf16) vector where the
// four lie inside the tensor and the addresses are aligned, else one at a
// time. Two entry points of the same body, so that the profiler tells the
// forward's launches from the backward's by name.
#include "common.cuh"

namespace {

constexpr uint32_t M0 = 0xD2511F53u;
constexpr uint32_t M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u;
constexpr uint32_t W1 = 0xBB67AE85u;
constexpr int THREADS = 256;

// Philox4x32-10 of counter c under key k
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ void apply(const T* __restrict__ x,
                                      T* __restrict__ out, long long n,
                                      uint2 key,
                                      const long long* __restrict__ step,
                                      uint32_t threshold, float scale) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long i0 = 4 * q;
  if (i0 >= n) return;
  const unsigned long long s = static_cast<unsigned long long>(*step);
  const uint4 r = philox(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                 static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)),
      key);
  const uint32_t word[4] = {r.x, r.y, r.z, r.w};
  const uintptr_t align = 4 * sizeof(T) - 1;
  if (i0 + 4 <= n && !(reinterpret_cast<uintptr_t>(x + i0) & align) &&
      !(reinterpret_cast<uintptr_t>(out + i0) & align)) {
    float v[4];
    load_vec<4>(x + i0, v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (word[j] >> 8) < threshold ? v[j] * scale : 0.0f;
    store_vec<4>(out + i0, v);
    return;
  }
  for (int j = 0; j < 4 && i0 + j < n; ++j) {
    const long long i = i0 + j;
    put(out + i, (word[j] >> 8) < threshold ? to_float(x[i]) * scale : 0.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_fwd_kernel(const T* x, T* out, long long n, uint2 key,
                       const long long* step, uint32_t threshold,
                       float scale) {
  apply(x, out, n, key, step, threshold, scale);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_bwd_kernel(const T* g, T* out, long long n, uint2 key,
                       const long long* step, uint32_t threshold,
                       float scale) {
  apply(g, out, n, key, step, threshold, scale);
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long n, uint2 key,
                   const void* step, uint32_t threshold, float scale,
                   int backward, cudaStream_t stream) {
  const long long counters = (n + 3) / 4;
  const unsigned int blocks =
      static_cast<unsigned int>((counters + THREADS - 1) / THREADS);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const long long* st = static_cast<const long long*>(step);
  if (backward)
    dropout_bwd_kernel<T><<<blocks, THREADS, 0, stream>>>(
        xt, ot, n, key, st, threshold, scale);
  else
    dropout_fwd_kernel<T><<<blocks, THREADS, 0, stream>>>(
        xt, ot, n, key, st, threshold, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out: n contiguous bf16 (is_bf16) or f32 values; step: one int64 on
// the card; n > 0 and at most 2**31 * 256 * 4 elements.
CGAT_EXPORT int cgat_dropout(const void* x, void* out, long long n,
                             unsigned int key0, unsigned int key1,
                             const void* step, unsigned int threshold,
                             float scale, int is_bf16, int backward,
                             cudaStream_t stream) {
  const uint2 key = make_uint2(key0, key1);
  return static_cast<int>(
      is_bf16 ? launch<bf16>(x, out, n, key, step, threshold, scale,
                             backward, stream)
              : launch<float>(x, out, n, key, step, threshold, scale,
                              backward, stream));
}
