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
// E needs no divisor rule. wgmma/TMA pipelining is later work. When the
// caller asks for it (training), the forward also writes the bf16 hidden
// activation h (E, H*hid), which the backward needs.
//
// Backward: replaces _bwd_kernel (launched by _vjp_bwd). From x, the saved
// h and the cotangent g (E, H*F):
//
//   dpre_k = where(h_k > 0, g_k @ Wout_k, 0.01 * g_k @ Wout_k)   (f32)
//   dx = bf16(bf16(dpre) @ Win)           dWin = bf16(dpre)^T @ x
//   db_in = sum_e dpre                    dWout_k = g_k^T @ h_k
//   db_out = sum_e g
//
// with f32 accumulation and bf16 weight grads, as the TPU kernel rounds
// them. Bound: operations. At the flagship shape the four products are
// 52 GFLOP (twice the forward), ~53 us at 989 TFLOP/s, against ~130 MB of
// x, h, g, dx and weights, ~39 us at 3.35 TB/s. Design, three steps, none
// with atomics, so the sums are deterministic:
//   1. a row kernel per (64-edge tile, head, 128 columns of hid) computes
//      its slice of dpre with WMMA from g_k, staged 128 columns at a time,
//      writes bf16 dpre to a scratch array and adds the tile's column sums
//      of dpre and g to per-tile partials; a second row kernel per
//      (64-edge tile, 128 columns of cat) forms dx = bf16(dpre) @ Win from
//      that array, again 128 columns at a time. Both use a fixed, small
//      shared memory, so every width the forward takes fits;
//   2. the weight grads are reductions over all E rows, which the TPU
//      kernel carries across its sequential grid. Here a split-K kernel
//      gives each 64x64 tile of dWin (dpre^T x) and of each head's dWout
//      (g_k^T h_k) a block per split of the rows; the block stages 32-row
//      slices of both operands in shared memory (zero past E) and writes
//      its f32 partial tile;
//   3. a reduce kernel adds the partials in split order and rounds to bf16.
// Ragged E needs no fallback: every step masks the rows past E.
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

// copy a (BM, width) bf16 tile (leading dim lds) to rows row0.. of dst
// (leading dim ldd, column col0), 8 values per store, rows past n_rows
// skipped
__device__ __forceinline__ void store_tile(bf16* dst, int ldd, int col0,
                                           const bf16* tile_s, int lds,
                                           int width, int row0, int n_rows) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < BM * chunks; i += THREADS) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * ldd + col0 + c) =
          *reinterpret_cast<const uint4*>(tile_s + r * lds + c);
  }
}

// stage rows row0.. of columns [col0, col0 + width) of src (leading dim
// lds) as a (BM, width) tile with leading dim ldd; rows past n_rows are 0
__device__ __forceinline__ void stage_tile(bf16* tile_s, int ldd,
                                           const bf16* src, int lds, int col0,
                                           int width, int row0, int n_rows) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < BM * chunks; i += THREADS) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * lds + col0 + c);
    *reinterpret_cast<uint4*>(tile_s + r * ldd + c) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
mh_network_fwd(const bf16* __restrict__ x, const bf16* __restrict__ win,
               const bf16* __restrict__ b_in, const bf16* __restrict__ wout,
               const bf16* __restrict__ b_out, bf16* __restrict__ out,
               bf16* __restrict__ h_out, int n_rows, int cat, int hid, int f,
               int heads) {
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
  stage_tile(xs, ldx, x, cat, 0, cat, row0, n_rows);
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
    if (h_out != nullptr)
      store_tile(h_out, heads * hid, k * hid, hs, ldh, hid, row0, n_rows);
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

constexpr int JW = WARPS * 16;   // output columns of a backward job: a 16-column tile per warp
constexpr int GK = 128;          // product columns staged per step
constexpr int GK_LD = GK + 8;

// Step 1a of the backward, grid (row tiles, heads, ceil(hid / JW)): block
// (t, k, c) computes dpre_k's columns [c JW, c JW + JW) for the 64 rows of
// tile t, g_k staged GK columns at a time; warp w owns column tile w. It
// writes bf16 dpre and the tile's f32 column sums of dpre (db_in) and, in
// the first column job, of g_k (db_out). Shared memory is fixed, so every
// width the forward takes fits.
__global__ void __launch_bounds__(THREADS)
mh_network_bwd_dpre(const bf16* __restrict__ h, const bf16* __restrict__ g,
                    const bf16* __restrict__ wout, bf16* __restrict__ dpre,
                    float* __restrict__ part_bin,
                    float* __restrict__ part_bout, int n_rows, int hid,
                    int f, int heads) {
  __shared__ __align__(128) float scratch[WARPS * 16 * SCR_LD];
  __shared__ __align__(128) bf16 gs[BM * GK_LD];
  const int hh = heads * hid;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ws = scratch + warp * 16 * SCR_LD;
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int row0 = tile * BM;
  const int nt = blockIdx.z * (JW / 16) + warp;
  const bool active = nt < hid / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) wmma::fill_fragment(acc[i], 0.f);
  // dh_k = g_k @ Wout_k, Wout_k (f, hid) row-major
  const bf16* wk = wout + static_cast<size_t>(k) * f * hid;
  for (int kc = 0; kc < f; kc += GK) {
    const int kw = min(GK, f - kc);
    stage_tile(gs, GK_LD, g, heads * f, k * f + kc, kw, row0, n_rows);
    __syncthreads();
    // db_out partial: the tile's column sums of g_k, in row order
    if (blockIdx.z == 0)
      for (int c = threadIdx.x; c < kw; c += THREADS) {
        float sum = 0.f;
        for (int r = 0; r < BM; ++r) sum += __bfloat162float(gs[r * GK_LD + c]);
        part_bout[static_cast<size_t>(tile) * heads * f + k * f + kc + c] = sum;
      }
    if (active)
      for (int kk = 0; kk < kw; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wk + static_cast<size_t>(kc + kk) * hid + nt * 16, hid);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, gs + i * 16 * GK_LD + kk, GK_LD);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    // the next step overwrites gs
    __syncthreads();
  }
  if (!active) return;
  float colsum = 0.f;   // lane c < 16 sums column nt*16 + c
  for (int i = 0; i < RT; ++i) {
    wmma::store_matrix_sync(ws, acc[i], SCR_LD, wmma::mem_row_major);
    __syncwarp();
    for (int t = lane; t < 256; t += 32) {
      const int r = t / 16, c = t % 16;
      const int row = row0 + i * 16 + r;
      const size_t j = static_cast<size_t>(row) * hh + k * hid + nt * 16 + c;
      const float hv = row < n_rows ? __bfloat162float(h[j]) : 0.f;
      const float dh = ws[r * SCR_LD + c];
      const float dp = hv > 0.f ? dh : LEAKY_SLOPE * dh;
      ws[r * SCR_LD + c] = dp;
      if (row < n_rows) dpre[j] = __float2bfloat16(dp);
    }
    __syncwarp();
    if (lane < 16)
      for (int r = 0; r < 16; ++r) colsum += ws[r * SCR_LD + lane];
    __syncwarp();
  }
  if (lane < 16)
    part_bin[static_cast<size_t>(tile) * hh + k * hid + nt * 16 + lane] = colsum;
}

// Step 1b, grid (row tiles, ceil(cat / JW)): dx[:, c JW : c JW + JW] =
// bf16(dpre @ Win[:, c JW : c JW + JW]) for the 64 rows of a tile, dpre
// staged GK columns at a time; warp w owns column tile w.
__global__ void __launch_bounds__(THREADS)
mh_network_bwd_dx(const bf16* __restrict__ dpre, const bf16* __restrict__ win,
                  bf16* __restrict__ dx, int n_rows, int cat, int hh) {
  __shared__ __align__(128) float scratch[WARPS * 16 * SCR_LD];
  __shared__ __align__(128) bf16 ds[BM * GK_LD];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ws = scratch + warp * 16 * SCR_LD;
  const int row0 = blockIdx.x * BM;
  const int nt = blockIdx.y * (JW / 16) + warp;
  const bool active = nt < cat / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int kc = 0; kc < hh; kc += GK) {
    const int kw = min(GK, hh - kc);
    stage_tile(ds, GK_LD, dpre, hh, kc, kw, row0, n_rows);
    __syncthreads();
    // Win (heads*hid, cat) row-major
    if (active)
      for (int kk = 0; kk < kw; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, win + static_cast<size_t>(kc + kk) * cat + nt * 16, cat);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, ds + i * 16 * GK_LD + kk, GK_LD);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    // the next step overwrites ds
    __syncthreads();
  }
  if (!active) return;
  for (int i = 0; i < RT; ++i) {
    wmma::store_matrix_sync(ws, acc[i], SCR_LD, wmma::mem_row_major);
    __syncwarp();
    for (int t = lane; t < 256; t += 32) {
      const int r = t / 16, c = t % 16;
      const int row = row0 + i * 16 + r;
      if (row < n_rows)
        dx[static_cast<size_t>(row) * cat + nt * 16 + c] =
            __float2bfloat16(ws[r * SCR_LD + c]);
    }
    __syncwarp();
  }
}

// Step 2: part[s, z*m + i, j] = sum over the rows of split s of
// a[e, z*a_head + i] * b[e, z*b_head + j], for an (m, n) output per head z;
// grid (n/64, m/64, splits*heads). m and n are multiples of 16; 64-wide
// tiles past them are zero-filled and their fragments not stored.
constexpr int AT = 64;          // output tile
constexpr int AK = 32;          // rows staged per step
constexpr int AT_LD = AT + 8;

__global__ void __launch_bounds__(THREADS)
atb_partial(const bf16* __restrict__ a, int lda, int a_head,
            const bf16* __restrict__ b, int ldb, int b_head, int m, int n,
            int n_rows, int rows_per_split, int heads,
            float* __restrict__ part) {
  __shared__ __align__(128) bf16 a_s[AK * AT_LD];
  __shared__ __align__(128) bf16 b_s[AK * AT_LD];
  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * AT, m0 = blockIdx.y * AT;
  const int z = blockIdx.z % heads, split = blockIdx.z / heads;
  const int e_begin = split * rows_per_split;
  const int e_end = min(n_rows, e_begin + rows_per_split);
  const int fm = warp / 2;            // fragment row of this warp
  const int fn0 = (warp % 2) * 2;     // its two fragment columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int e0 = e_begin; e0 < e_end; e0 += AK) {
    // one 16-byte chunk of each operand per thread: (32 rows) x (8 chunks)
    const int r = threadIdx.x / 8;
    const int c = (threadIdx.x % 8) * 8;
    uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
    if (e0 + r < e_end) {
      const size_t row = static_cast<size_t>(e0 + r);
      if (m0 + c < m)
        va = *reinterpret_cast<const uint4*>(a + row * lda + z * a_head + m0 + c);
      if (n0 + c < n)
        vb = *reinterpret_cast<const uint4*>(b + row * ldb + z * b_head + n0 + c);
    }
    *reinterpret_cast<uint4*>(a_s + r * AT_LD + c) = va;
    *reinterpret_cast<uint4*>(b_s + r * AT_LD + c) = vb;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AK; kk += 16) {
      // a^T: element (i, e) of the fragment is a_s[(kk + e) * AT_LD + i]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, a_s + kk * AT_LD + fm * 16, AT_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b_s + kk * AT_LD + (fn0 + j) * 16, AT_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  const int i0 = m0 + fm * 16;
  if (i0 >= m) return;
  float* out = part + (static_cast<size_t>(split) * heads + z) * m * n;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int j0 = n0 + (fn0 + j) * 16;
    if (j0 < n)
      wmma::store_matrix_sync(out + static_cast<size_t>(i0) * n + j0, acc[j], n,
                              wmma::mem_row_major);
  }
}

// Step 3: out[i] = bf16(sum_s part[s * len + i]), s in order.
__global__ void reduce_splits(const float* __restrict__ part, int splits,
                              int64_t len, bf16* __restrict__ out) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * len + i];
    out[i] = __float2bfloat16(sum);
  }
}

cudaError_t launch_atb(const bf16* a, int lda, int a_head, const bf16* b,
                       int ldb, int b_head, int m, int n, int n_rows,
                       int splits, int heads, float* part,
                       cudaStream_t stream) {
  const int rows_per_split = ((n_rows + splits - 1) / splits + AK - 1) / AK * AK;
  const dim3 grid((n + AT - 1) / AT, (m + AT - 1) / AT, splits * heads);
  atb_partial<<<grid, THREADS, 0, stream>>>(a, lda, a_head, b, ldb, b_head, m,
                                            n, n_rows, rows_per_split, heads,
                                            part);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* part, int splits, int64_t len,
                          bf16* out, cudaStream_t stream) {
  const int64_t want = (len + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce_splits<<<blocks, THREADS, 0, stream>>>(part, splits, len, out);
  return cudaGetLastError();
}

}  // namespace

// x: (n_rows, cat); win: (heads*hid, cat); b_in: (heads*hid,);
// wout: (heads*f, hid); b_out: (heads*f,); out: (n_rows, heads*f); h_out:
// (n_rows, heads*hid) or null. All bf16, C-contiguous, 32-byte aligned;
// cat, hid and f multiples of 16.
CGAT_EXPORT int cgat_mh_network_fwd(const void* x, const void* win,
                                    const void* b_in, const void* wout,
                                    const void* b_out, void* out, void* h_out,
                                    int n_rows, int cat, int hid, int f,
                                    int heads, void* stream) {
  if (n_rows <= 0) return 0;
  const int bytes = smem_bytes(cat, hid);
  cudaError_t err = allow_smem(mh_network_fwd, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rows + BM - 1) / BM;
  mh_network_fwd<<<blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(win),
      static_cast<const bf16*>(b_in), static_cast<const bf16*>(wout),
      static_cast<const bf16*>(b_out), static_cast<bf16*>(out),
      static_cast<bf16*>(h_out), n_rows, cat, hid, f, heads);
  return static_cast<int>(cudaGetLastError());
}

// x: (n_rows, cat); h: (n_rows, heads*hid) from the forward; g: (n_rows,
// heads*f) cotangent; win, wout as in the forward. Outputs: dx (n_rows,
// cat), dwin (heads*hid, cat), dbin (heads*hid,), dwout (heads*f, hid),
// dbout (heads*f,), all bf16. Scratch: dpre (n_rows, heads*hid) bf16;
// part_bin (tiles, heads*hid) and part_bout (tiles, heads*f) f32 with
// tiles = ceil(n_rows / 64); part_win (s_win, heads*hid, cat) and part_wout
// (s_wout, heads*f, hid) f32. Same layout rules as the forward.
CGAT_EXPORT int cgat_mh_network_bwd(
    const void* x, const void* h, const void* g, const void* win,
    const void* wout, int n_rows, int cat, int hid, int f, int heads,
    void* dx, void* dpre, float* part_bin, float* part_bout, int s_win,
    float* part_win, int s_wout, float* part_wout, void* dwin, void* dbin,
    void* dwout, void* dbout, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n_rows + BM - 1) / BM;
  const int hh = heads * hid;
  mh_network_bwd_dpre<<<dim3(tiles, heads, (hid + JW - 1) / JW), THREADS, 0, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(g),
      static_cast<const bf16*>(wout), static_cast<bf16*>(dpre), part_bin,
      part_bout, n_rows, hid, f, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mh_network_bwd_dx<<<dim3(tiles, (cat + JW - 1) / JW), THREADS, 0, st>>>(
      static_cast<const bf16*>(dpre), static_cast<const bf16*>(win),
      static_cast<bf16*>(dx), n_rows, cat, hh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dWin = dpre^T x (one head of width heads*hid); dWout_k = g_k^T h_k
  if ((err = launch_atb(static_cast<const bf16*>(dpre), hh, 0,
                        static_cast<const bf16*>(x), cat, 0, hh, cat, n_rows,
                        s_win, 1, part_win, st)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = launch_atb(static_cast<const bf16*>(g), heads * f, f,
                        static_cast<const bf16*>(h), hh, hid, f, hid, n_rows,
                        s_wout, heads, part_wout, st)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = launch_reduce(part_win, s_win, static_cast<int64_t>(hh) * cat,
                           static_cast<bf16*>(dwin), st)) != cudaSuccess ||
      (err = launch_reduce(part_wout, s_wout,
                           static_cast<int64_t>(heads) * f * hid,
                           static_cast<bf16*>(dwout), st)) != cudaSuccess ||
      (err = launch_reduce(part_bin, tiles, hh, static_cast<bf16*>(dbin),
                           st)) != cudaSuccess ||
      (err = launch_reduce(part_bout, tiles, heads * f,
                           static_cast<bf16*>(dbout), st)) != cudaSuccess)
    return static_cast<int>(err);
  return 0;
}
