// Head-parallel two-layer MLP over a shared input (MultiHeadNetwork).
//
// Replaces the TPU kernel cgat_tpu/ops/pallas/mh_network.py: _fwd_kernel
// (launched by _fwd_impl). For an edge tile of x (E, cat) and each head k:
//
//   h_k = bf16(leaky_relu(x @ Win_k^T + b_in_k, 0.01))      (tile, hid)
//   out[:, k*F:(k+1)*F] = bf16(h_k @ Wout_k^T + b_out_k)    (tile, F)
//
// with Win (H*hid, cat) and Wout (H*F, hid) in the reference's grouped
// Conv1d layout (rows of head k are contiguous), so both products are
// "row times row" and need no transposed copy. The grouped second product
// runs per head, never as a dense (H*hid, H*F) block-diagonal matrix.
//
// Bound on the H100: operations. At the flagship shape (E = 18432,
// cat = 384, hid = 256, H = 5, F = 128, bf16) one call is 24.2 GFLOP of
// tensor-core work, ~24 us at 989 TFLOP/s, against 16 MB of input and
// output, ~5 us at 3.35 TB/s.
//
// Design: one block of 8 warps per 64-edge tile. The x tile is staged in
// shared memory once and reused by all heads; the bf16 hidden activation
// h_k never leaves shared memory. Both products use bf16 WMMA fragments
// (mma.sync, f32 accumulation); weight fragments stream from L2, which
// holds the whole 1.3 MB weight set. Each warp moves its accumulator
// fragment through a small per-warp scratch to apply the bias, the
// leaky-ReLU and the bf16 rounding in f32, as the TPU kernel does. The last
// tile is ragged: rows past E are zero-filled on load and never stored, so
// E needs no divisor rule. wgmma/TMA pipelining is later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;          // edge rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RT = BM / 16;     // 16-row fragments per tile
constexpr int SCR_LD = 20;      // per-warp f32 scratch leading dimension
constexpr float LEAKY_SLOPE = 0.01f;

__host__ __device__ constexpr int pad_ld(int n) { return n + 8; }

__host__ __device__ inline int smem_bytes(int cat, int hid) {
  return WARPS * 16 * SCR_LD * 4 + BM * pad_ld(cat) * 2 + BM * pad_ld(hid) * 2;
}

// acc[RT] = tile_s (BM, kdim; leading dim lds) @ W[n0:n0+16, :kdim]^T, with
// W row-major (rows of length kdim) in global memory
__device__ __forceinline__ void tile_product(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[RT],
    const bf16* tile_s, int lds, const bf16* w, int kdim, int n0) {
#pragma unroll
  for (int i = 0; i < RT; ++i) wmma::fill_fragment(acc[i], 0.f);
  const bf16* wn = w + static_cast<size_t>(n0) * kdim;
  for (int kk = 0; kk < kdim; kk += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::load_matrix_sync(b, wn + kk, kdim);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, tile_s + i * 16 * lds + kk, lds);
      wmma::mma_sync(acc[i], a, b, acc[i]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mh_network_fwd(const bf16* __restrict__ x, const bf16* __restrict__ win,
               const bf16* __restrict__ b_in, const bf16* __restrict__ wout,
               const bf16* __restrict__ b_out, bf16* __restrict__ out,
               int n_rows, int cat, int hid, int f, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + WARPS * 16 * SCR_LD * 4);
  const int ldx = pad_ld(cat);
  bf16* hs = xs + BM * ldx;
  const int ldh = pad_ld(hid);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ws = scratch + warp * 16 * SCR_LD;
  const int row0 = blockIdx.x * BM;
  const int hf = heads * f;

  // stage the x tile, 8 bf16 (16 bytes) per load; rows past E are zeros
  const int chunks = cat / 8;
  for (int i = threadIdx.x; i < BM * chunks; i += THREADS) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + r) * cat + c);
    *reinterpret_cast<uint4*>(xs + r * ldx + c) = v;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
  for (int k = 0; k < heads; ++k) {
    // first product: h_k = leaky(x @ Win_k^T + b_in_k), kept in shared memory
    const bf16* wk = win + static_cast<size_t>(k) * hid * cat;
    for (int nt = warp; nt < hid / 16; nt += WARPS) {
      tile_product(acc, xs, ldx, wk, cat, nt * 16);
      for (int i = 0; i < RT; ++i) {
        wmma::store_matrix_sync(ws, acc[i], SCR_LD, wmma::mem_row_major);
        __syncwarp();
        for (int t = lane; t < 256; t += 32) {
          const int r = t / 16, c = t % 16;
          const int j = nt * 16 + c;
          float p = ws[r * SCR_LD + c] + __bfloat162float(b_in[k * hid + j]);
          p = p > 0.f ? p : LEAKY_SLOPE * p;
          hs[(i * 16 + r) * ldh + j] = __float2bfloat16(p);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // second product: out[:, k*F:(k+1)*F] = h_k @ Wout_k^T + b_out_k
    const bf16* wo = wout + static_cast<size_t>(k) * f * hid;
    for (int nt = warp; nt < f / 16; nt += WARPS) {
      tile_product(acc, hs, ldh, wo, hid, nt * 16);
      for (int i = 0; i < RT; ++i) {
        wmma::store_matrix_sync(ws, acc[i], SCR_LD, wmma::mem_row_major);
        __syncwarp();
        for (int t = lane; t < 256; t += 32) {
          const int r = t / 16, c = t % 16;
          const int row = row0 + i * 16 + r;
          const int col = nt * 16 + c;
          if (row < n_rows)
            out[static_cast<size_t>(row) * hf + k * f + col] = __float2bfloat16(
                ws[r * SCR_LD + c] + __bfloat162float(b_out[k * f + col]));
        }
        __syncwarp();
      }
    }
    // the next head overwrites hs
    __syncthreads();
  }
}

}  // namespace

// x: (n_rows, cat); win: (heads*hid, cat); b_in: (heads*hid,);
// wout: (heads*f, hid); b_out: (heads*f,); out: (n_rows, heads*f). All bf16,
// C-contiguous, 32-byte aligned; cat, hid and f multiples of 16.
CGAT_EXPORT int cgat_mh_network_fwd(const void* x, const void* win,
                                    const void* b_in, const void* wout,
                                    const void* b_out, void* out, int n_rows,
                                    int cat, int hid, int f, int heads,
                                    void* stream) {
  if (n_rows <= 0) return 0;
  const int bytes = smem_bytes(cat, hid);
  cudaError_t err = allow_smem(mh_network_fwd, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rows + BM - 1) / BM;
  mh_network_fwd<<<blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(win),
      static_cast<const bf16*>(b_in), static_cast<const bf16*>(wout),
      static_cast<const bf16*>(b_out), static_cast<bf16*>(out), n_rows, cat,
      hid, f, heads);
  return static_cast<int>(cudaGetLastError());
}
