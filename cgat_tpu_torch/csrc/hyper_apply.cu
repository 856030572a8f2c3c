// Fused hypernetwork predict + apply.
//
// Replaces the TPU kernel cgat_tpu/ops/pallas/hyper_apply.py: _fwd_kernel
// (launched by _fwd_impl). The last hypernetwork Linear predicts, per row
// b, a weight matrix and bias, which are applied at once to that row's own
// input x[b]:
//
//   P[b, :] = bf16(hidden[b] @ K^T + c)          K: (O*I + O, C)
//   out[b, o] = bf16(sum_i P[b, o*I + i] * x[b, i] + P[b, O*I + o])
//
// The products and the sum over each group of I lanes are f32. P (B, O*I+O)
// never reaches device memory.
//
// Bound on the H100: operations. At the flagship shape (B = 768 node slots,
// C = I = O = 128, bf16) one call is 3.25 GFLOP, ~3.3 us at 989 TFLOP/s,
// against 4.6 MB of input and output (K is 4.2 MB of it), ~1.4 us at
// 3.35 TB/s. Writing and re-reading P instead would add 51 MB.
//
// Design: a 2-D grid of (64-row block) x (16 outputs). A block stages its
// hidden and x rows in shared memory and, output by output, computes the
// (64, I) slice P_o with bf16 WMMA fragments (f32 accumulation; K streams
// from L2). Each warp moves its accumulator fragment through a per-warp
// scratch, adds the bias, rounds to bf16 as the TPU kernel does, multiplies
// by x and reduces the row's 16 lanes in f32; the per-warp partial sums are
// added across warps at the end. The bias tail P[:, O*I + o] of the block's
// 16 outputs is one more 16-column fragment. Rows past B are zero-filled
// and never stored, so B needs no padding.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;          // rows per block
constexpr int OC = 16;          // outputs per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RT = BM / 16;
constexpr int SCR_LD = 20;

__host__ __device__ constexpr int pad_ld(int n) { return n + 8; }

// [per-warp scratch | partial sums | bias tail | hidden tile | x tile]
__host__ __device__ inline int smem_bytes(int c, int in_ch) {
  return WARPS * 16 * SCR_LD * 4 + WARPS * BM * OC * 4 + BM * OC * 4 +
         BM * pad_ld(c) * 2 + BM * pad_ld(in_ch) * 2;
}

__device__ __forceinline__ void stage_rows(bf16* dst, int ldd,
                                           const bf16* src, int width,
                                           int row0, int n_rows) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < BM * chunks; i += THREADS) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * width + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
  }
}

__device__ __forceinline__ void tile_product(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[RT],
    const bf16* tile_s, int lds, const bf16* w, int kdim) {
#pragma unroll
  for (int i = 0; i < RT; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int kk = 0; kk < kdim; kk += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::load_matrix_sync(b, w + kk, kdim);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, tile_s + i * 16 * lds + kk, lds);
      wmma::mma_sync(acc[i], a, b, acc[i]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
hyper_apply_fwd(const bf16* __restrict__ hidden, const bf16* __restrict__ k,
                const bf16* __restrict__ bias, const bf16* __restrict__ x,
                bf16* __restrict__ out, int n_rows, int c_dim, int in_ch,
                int out_ch) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  float* part = scratch + WARPS * 16 * SCR_LD;   // (WARPS, BM, OC)
  float* tail = part + WARPS * BM * OC;          // (BM, OC)
  bf16* hs = reinterpret_cast<bf16*>(tail + BM * OC);
  const int ldh = pad_ld(c_dim);
  bf16* xs = hs + BM * ldh;
  const int ldx = pad_ld(in_ch);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ws = scratch + warp * 16 * SCR_LD;
  float* wpart = part + warp * BM * OC;
  const int row0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * OC;
  const int w_cols = out_ch * in_ch;

  stage_rows(hs, ldh, hidden, c_dim, row0, n_rows);
  stage_rows(xs, ldx, x, in_ch, row0, n_rows);
  for (int i = threadIdx.x; i < WARPS * BM * OC; i += THREADS) part[i] = 0.f;
  __syncthreads();

  // lane -> (row r of the fragment, 8 lanes starting at c0)
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
  for (int ol = 0; ol < OC; ++ol) {
    const int o = o0 + ol;
    for (int nt = warp; nt < in_ch / 16; nt += WARPS) {
      const int p0 = o * in_ch + nt * 16;   // first predicted column
      tile_product(acc, hs, ldh, k + static_cast<size_t>(p0) * c_dim, c_dim);
      for (int i = 0; i < RT; ++i) {
        wmma::store_matrix_sync(ws, acc[i], SCR_LD, wmma::mem_row_major);
        __syncwarp();
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + j;
          // the predicted weight is rounded to bf16 before it is applied
          const float p = __bfloat162float(__float2bfloat16(
              ws[r * SCR_LD + c] + __bfloat162float(bias[p0 + c])));
          s = fmaf(p, __bfloat162float(xs[(i * 16 + r) * ldx + nt * 16 + c]), s);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (lane % 2 == 0) wpart[(i * 16 + r) * OC + ol] += s;
        __syncwarp();
      }
    }
  }
  // bias tail: P[:, O*I + o0 : O*I + o0 + 16], one row fragment per warp
  if (warp < RT) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> t;
    wmma::fill_fragment(t, 0.f);
    const bf16* kt = k + static_cast<size_t>(w_cols + o0) * c_dim;
    for (int kk = 0; kk < c_dim; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(b, kt + kk, c_dim);
      wmma::load_matrix_sync(a, hs + warp * 16 * ldh + kk, ldh);
      wmma::mma_sync(t, a, b, t);
    }
    wmma::store_matrix_sync(ws, t, SCR_LD, wmma::mem_row_major);
    __syncwarp();
    for (int q = lane; q < 256; q += 32) {
      const int rr = q / 16, ol = q % 16;
      tail[(warp * 16 + rr) * OC + ol] = __bfloat162float(__float2bfloat16(
          ws[rr * SCR_LD + ol] + __bfloat162float(bias[w_cols + o0 + ol])));
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < BM * OC; q += THREADS) {
    const int rr = q / OC, ol = q % OC;
    if (row0 + rr >= n_rows) continue;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += part[(w * BM + rr) * OC + ol];
    out[static_cast<size_t>(row0 + rr) * out_ch + o0 + ol] =
        __float2bfloat16(s + tail[rr * OC + ol]);
  }
}

}  // namespace

// hidden: (n_rows, c_dim); k: (out_ch*in_ch + out_ch, c_dim) (torch Linear
// layout); bias: (out_ch*in_ch + out_ch,); x: (n_rows, in_ch);
// out: (n_rows, out_ch). All bf16, C-contiguous, 32-byte aligned; c_dim,
// in_ch and out_ch multiples of 16.
CGAT_EXPORT int cgat_hyper_apply_fwd(const void* hidden, const void* k,
                                     const void* bias, const void* x,
                                     void* out, int n_rows, int c_dim,
                                     int in_ch, int out_ch, void* stream) {
  if (n_rows <= 0) return 0;
  const int bytes = smem_bytes(c_dim, in_ch);
  cudaError_t err = allow_smem(hyper_apply_fwd, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + BM - 1) / BM, out_ch / OC);
  hyper_apply_fwd<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(k),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), n_rows, c_dim, in_ch, out_ch);
  return static_cast<int>(cudaGetLastError());
}
