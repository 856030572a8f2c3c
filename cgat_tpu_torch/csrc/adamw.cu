// AdamW's update in one pass over a list of tensors: the trainer's optimizer
// (cgat_tpu_torch/training/optim.py AdamW) on the card.
//
// The port's own kernel: it replaces no Pallas kernel, since the JAX package
// leaves optax's update to XLA. In the port the update was ~17
// torch._foreach_* passes over the flat layout (training/flatten.py), each
// reading one or two whole-model lists and writing one, four of them into
// whole-model f32 temporaries; they stay as the plain version
// (AdamW.update_plain), the path of CPU tensors.
//
// Bound on the H100: bytes. Each element reads g, p and nu (f32) and mu (bf16
// or f32) once and writes p, mu and nu once: 24 bytes with a bf16 mu, 28 with
// an f32 one. At the default model's 62,293,836 parameters and a bf16 mu that
// is 1.495 GB, 0.446 ms at 3.35 TB/s. The arithmetic (two multiplies and an
// add for the moments, a square root, three divisions, the decay and the
// step: 16 f32 operations an element) stays under it.
//
// Bit-equal to the _foreach sequence: the same f32 operations in the same
// order, each rounded on its own, with the constants the f32 values torch
// turns the Python scalars into:
//
//   mu_s = round_to(mu's dtype, b1 * mu)       (_foreach_mul_ on mu's list)
//   m    = g * (1 - b1) + mu_s
//   nu   = nu * b2 + (g * g) * (1 - b2)
//   u    = (m / bc1) / (sqrt(nu / bc2) + eps)
//   p    = p + (u + p * weight_decay) * neg_lr
//   mu   = round_to(mu's dtype, m)
//
// Written with the __f*_rn intrinsics, which nvcc never contracts: the build
// leaves -fmad at its default of true for every source, and a contracted
// nu * b2 + g2 (one rounding where the _foreach passes make two) would move
// the trajectory off the plain one's by a rounding an update.
//
// Design: one pass, each byte moved once, no temporaries. A launch's table
// of tensors (pointers, lengths, each tensor's first chunk) is passed by
// value in the kernel's parameters, as PyTorch's multi_tensor_apply passes
// its metadata: a CUDA graph bakes the addresses in, and no copy to the
// device is needed inside a capture. The table holds MAX_TENSORS tensors in
// the 4 KB of parameters every toolkit takes; the wrapper
// (ops/kernels/adamw.py) splits a longer list over more launches. What
// changes between steps (the bias corrections bc1 and bc2, the learning
// rate) is read from device memory, so a replay reads each step's values.
// Each tensor is cut into chunks of `chunk` elements, numbered through the
// launch; the blocks, one wave of BLOCKS_PER_SM an SM, walk them
// grid-stride, so a block's chunks only move forward through the table. A
// thread moves 4 elements a step (16 bytes of each f32 array, 8 of a bf16
// mu) where the tensor's addresses are aligned, with the tail of a length
// that is not a multiple of 4 (and an unaligned tensor) one element at a
// time.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_TENSORS = 80;

struct Entry {
  float* p;
  const float* g;
  void* mu;
  float* nu;
  long long numel;
  long long chunk0;  // the launch's number of this tensor's first chunk
};

// ops/kernels/adamw.py's ctypes Table mirrors this, field for field
struct Table {
  const float* bc1;
  const float* bc2;
  const float* neg_lr;
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
  int n;             // tensors
  int chunk;         // elements a chunk, a multiple of 4
  long long chunks;  // the launch's chunks
  Entry e[MAX_TENSORS];
};
static_assert(sizeof(Table) <= 4096, "the table must fit the 4 KB of "
                                     "kernel parameters");

// x rounded to M and back
template <typename M>
__device__ __forceinline__ float rounded(float x) { return x; }
template <>
__device__ __forceinline__ float rounded<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one element's update; mu comes in as f32 and leaves as the f32 value to
// be stored (rounded to M by the store)
template <typename M>
__device__ __forceinline__ void update(const Table& t, float bc1, float bc2,
                                       float neg_lr, float g, float& p,
                                       float& mu, float& nu) {
  const float mu_s = rounded<M>(__fmul_rn(mu, t.b1));
  const float m = __fadd_rn(__fmul_rn(g, t.one_minus_b1), mu_s);
  const float g2 = __fmul_rn(__fmul_rn(g, g), t.one_minus_b2);
  nu = __fadd_rn(__fmul_rn(nu, t.b2), g2);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), t.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  u = __fadd_rn(u, __fmul_rn(p, t.weight_decay));
  u = __fmul_rn(u, neg_lr);
  p = __fadd_rn(p, u);
  mu = m;
}

template <typename M>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
adamw_multi_tensor_apply_kernel(const __grid_constant__ Table t) {
  const float bc1 = *t.bc1, bc2 = *t.bc2, neg_lr = *t.neg_lr;
  int k = 0;
  for (long long c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    while (k + 1 < t.n && t.e[k + 1].chunk0 <= c) ++k;
    const Entry& e = t.e[k];
    float* p = e.p;
    const float* g = e.g;
    M* mu = static_cast<M*>(e.mu);
    float* nu = e.nu;
    const long long start = (c - e.chunk0) * t.chunk;
    const long long end = min(e.numel, start + t.chunk);
    long long tail = start;  // [start, tail) goes 4 elements a thread
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p) |
                           reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(nu);
    if (addr % 16 == 0 &&
        reinterpret_cast<uintptr_t>(mu) % (4 * sizeof(M)) == 0) {
      tail = start + ((end - start) & ~3LL);
      for (long long i = start + 4 * threadIdx.x; i < tail; i += 4 * THREADS) {
        float pv[4], gv[4], mv[4], nv[4];
        load_vec<4>(p + i, pv);
        load_vec<4>(g + i, gv);
        load_vec<4>(mu + i, mv);
        load_vec<4>(nu + i, nv);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          update<M>(t, bc1, bc2, neg_lr, gv[j], pv[j], mv[j], nv[j]);
        store_vec<4>(p + i, pv);
        store_vec<4>(mu + i, mv);
        store_vec<4>(nu + i, nv);
      }
    }
    for (long long i = tail + threadIdx.x; i < end; i += THREADS) {
      float pv = p[i], mv = to_float(mu[i]), nv = nu[i];
      update<M>(t, bc1, bc2, neg_lr, g[i], pv, mv, nv);
      p[i] = pv;
      store_vec<1>(mu + i, &mv);
      nu[i] = nv;
    }
  }
}

}  // namespace

// table: a Table of table_bytes bytes (checked against this build's size,
// so a wrapper whose mirror differs is refused); mu_bf16: every mu of the
// table is bf16 (else f32); grid: blocks, at most BLOCKS_PER_SM an SM.
CGAT_EXPORT int cgat_adamw(const void* table, int table_bytes, int mu_bf16,
                           int grid, void* stream) {
  if (table_bytes != static_cast<int>(sizeof(Table)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Table& t = *static_cast<const Table*>(table);
  if (t.n < 0 || t.n > MAX_TENSORS || t.chunk <= 0 || t.chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t.chunks <= 0 || grid <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu_bf16) {
    adamw_multi_tensor_apply_kernel<bf16><<<grid, THREADS, 0, s>>>(t);
  } else {
    adamw_multi_tensor_apply_kernel<float><<<grid, THREADS, 0, s>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}
