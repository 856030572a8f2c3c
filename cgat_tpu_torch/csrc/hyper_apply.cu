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
//
// Backward, for the cotangent g (B, O), with dP[b, o*I + i] =
// bf16(g[b, o] * x[b, i]) and dP[b, O*I + o] = g[b, o]:
//
// * dh/dx, replacing _bwd_dhdx_kernel (launched by _fused_bwd):
//     dh = bf16(dP @ K)        dx[b, i] = bf16(sum_o bf16(g[b,o] * P[b, o*I+i]))
//   Bound: operations, 7 GFLOP at the flagship shape (P recomputed, then
//   dP @ K), ~7 us at 989 TFLOP/s. Design: the forward's grid of (64-row
//   block) x (16 outputs), times a third axis of 128-column jobs, so that
//   any width the forward takes fits: a dx job recomputes, per output o,
//   its 128 columns of P_o with WMMA from the staged hidden rows, as the
//   forward does, and adds bf16(g * P_o) into an f32 dx tile in shared
//   memory (one 16-column tile per warp); a dh job builds dP_o =
//   bf16(g[:, o] * x) in shared memory 128 columns at a time and
//   accumulates dP_o @ K_o into its 128 columns of dh, which the warps keep
//   in register fragments over all 16 outputs, then adds the bias tail
//   g_group @ K_tail. P and dP never reach device memory. The 16 outputs'
//   partial dh and dx go to an f32 array per output group, and a reduce
//   kernel adds the groups in order and rounds to bf16: no atomics.
// * dK, replacing _bwd_dk_kernel (launched by _fused_bwd):
//     dK[o*I + i, :] = bf16(sum_b dP[b, o*I + i] * hidden[b, :])
//     db[o*I + i] = sum_b dP[b, o*I + i]                      (f32)
//   Bound: operations, 3.5 GFLOP, ~3.5 us. Design: one block per 64 rows
//   and 256 columns of dK loops over the batch in 32-row steps, building
//   the (32, 64) dP slice in shared memory from g and x and multiplying its
//   transpose by the staged hidden columns with WMMA; each block writes its
//   tile of dK once and the first column's blocks sum db in row order, so
//   the sums are deterministic.
// The bias-tail rows of dK and db (g^T hidden and sum g) are left to plain
// torch ops, as the JAX package computes them outside Pallas.
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

constexpr int JW = WARPS * 16; // dx or dh columns of one job: a 16-column tile per warp
constexpr int DPK = 128;        // dP columns staged per step of a dh job
constexpr int DP_LD = DPK + 8;

// [per-warp scratch | g tile (BM, OC) | job area]: a dx job's area is the
// f32 dx tile (BM, JW) and the hidden tile (BM, c + 8), a dh job's the dP
// slice (BM, DPK + 8), which is smaller
__host__ __device__ inline int dhdx_smem_bytes(int c) {
  return WARPS * 16 * SCR_LD * 4 + BM * OC * 2 + BM * JW * 4 + BM * pad_ld(c) * 2;
}

// grid (row blocks, out_ch / 16, dx jobs + dh jobs); job z < ceil(in_ch /
// JW) computes dx columns [z*JW, z*JW + JW), the others dh columns
__global__ void __launch_bounds__(THREADS)
hyper_apply_bwd_dhdx(const bf16* __restrict__ hidden,
                     const bf16* __restrict__ k,
                     const bf16* __restrict__ bias,
                     const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ part_dh, float* __restrict__ part_dx,
                     int n_rows, int c_dim, int in_ch, int out_ch) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  bf16* gs = reinterpret_cast<bf16*>(scratch + WARPS * 16 * SCR_LD);  // (BM, OC)
  unsigned char* area = reinterpret_cast<unsigned char*>(gs + BM * OC);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ws = scratch + warp * 16 * SCR_LD;
  const int row0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * OC;
  const size_t plane = static_cast<size_t>(gridDim.x) * BM;   // rows_pad
  const int x_jobs = (in_ch + JW - 1) / JW;

  for (int i = threadIdx.x; i < BM * OC; i += THREADS) {
    const int r = i / OC, ol = i % OC;
    gs[i] = row0 + r < n_rows
        ? g[static_cast<size_t>(row0 + r) * out_ch + o0 + ol] : __float2bfloat16(0.f);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];

  if (static_cast<int>(blockIdx.z) < x_jobs) {
    // dx job: P_o's columns of this job, recomputed from the hidden rows,
    // and dx += bf16(g[:, o] * P_o); warp w owns dx column tile x0/16 + w
    float* dxs = reinterpret_cast<float*>(area);                     // (BM, JW)
    bf16* hs = reinterpret_cast<bf16*>(dxs + BM * JW);
    const int ldh = pad_ld(c_dim);
    const int x0 = blockIdx.z * JW;
    const int nt = x0 / 16 + warp;
    stage_rows(hs, ldh, hidden, c_dim, row0, n_rows);
    for (int i = threadIdx.x; i < BM * JW; i += THREADS) dxs[i] = 0.f;
    __syncthreads();
    if (nt < in_ch / 16) {
      for (int ol = 0; ol < OC; ++ol) {
        const int p0 = (o0 + ol) * in_ch + nt * 16;
        tile_product(acc, hs, ldh, k + static_cast<size_t>(p0) * c_dim, c_dim);
        for (int i = 0; i < RT; ++i) {
          wmma::store_matrix_sync(ws, acc[i], SCR_LD, wmma::mem_row_major);
          __syncwarp();
          for (int t = lane; t < 256; t += 32) {
            const int r = t / 16, c = t % 16;
            const float p = __bfloat162float(__float2bfloat16(
                ws[r * SCR_LD + c] + __bfloat162float(bias[p0 + c])));
            const float gv = __bfloat162float(gs[(i * 16 + r) * OC + ol]);
            dxs[(i * 16 + r) * JW + warp * 16 + c] +=
                __bfloat162float(__float2bfloat16(gv * p));
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    const int width = min(JW, in_ch - x0);
    float* pdx = part_dx + (blockIdx.y * plane + row0) * in_ch + x0;
    for (int i = threadIdx.x; i < BM * width; i += THREADS) {
      const int r = i / width, c = i % width;
      pdx[static_cast<size_t>(r) * in_ch + c] = dxs[r * JW + c];
    }
    return;
  }

  // dh job: dh[:, c0:c0+JW] += dP_o @ K_o over the 16 outputs, dP_o =
  // bf16(g[:, o] * x) staged DPK columns at a time; warp w owns dh column
  // tile c0/16 + w and keeps its fragments in registers
  bf16* dps = reinterpret_cast<bf16*>(area);                         // (BM, DP_LD)
  const int nt = (blockIdx.z - x_jobs) * (JW / 16) + warp;
  const bool active = nt < c_dim / 16;
#pragma unroll
  for (int i = 0; i < RT; ++i) wmma::fill_fragment(acc[i], 0.f);
  __syncthreads();
  for (int ol = 0; ol < OC; ++ol) {
    const bf16* ko = k + static_cast<size_t>(o0 + ol) * in_ch * c_dim;
    for (int kc = 0; kc < in_ch; kc += DPK) {
      const int kw = min(DPK, in_ch - kc);
      for (int t = threadIdx.x; t < BM * kw; t += THREADS) {
        const int r = t / kw, i = t % kw;
        const float xv = row0 + r < n_rows
            ? __bfloat162float(x[static_cast<size_t>(row0 + r) * in_ch + kc + i]) : 0.f;
        dps[r * DP_LD + i] =
            __float2bfloat16(__bfloat162float(gs[r * OC + ol]) * xv);
      }
      __syncthreads();
      if (active) {
        // K row-major (rows of length c_dim)
        for (int kk = 0; kk < kw; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ko + static_cast<size_t>(kc + kk) * c_dim + nt * 16, c_dim);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, dps + i * 16 * DP_LD + kk, DP_LD);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
      // the next step overwrites dps
      __syncthreads();
    }
  }
  if (!active) return;
  // bias tail: dh += g[:, o0:o0+16] @ K[O*I + o0 : O*I + o0 + 16, :]
  const bf16* kt = k + static_cast<size_t>(out_ch * in_ch + o0) * c_dim;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  wmma::load_matrix_sync(b, kt + nt * 16, c_dim);
  float* pdh = part_dh + (blockIdx.y * plane + row0) * c_dim + nt * 16;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, gs + i * 16 * OC, OC);
    wmma::mma_sync(acc[i], a, b, acc[i]);
    wmma::store_matrix_sync(pdh + static_cast<size_t>(i) * 16 * c_dim, acc[i],
                            c_dim, wmma::mem_row_major);
  }
}

// out[b, j] = bf16(sum_group part[group, b, j]) for b < n_rows, groups in
// order; part is (groups, rows_pad, width)
__global__ void reduce_groups(const float* __restrict__ part, int groups,
                              int rows_pad, int n_rows, int width,
                              bf16* __restrict__ out) {
  const int64_t len = static_cast<int64_t>(n_rows) * width;
  const int64_t plane = static_cast<int64_t>(rows_pad) * width;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int gi = 0; gi < groups; ++gi) sum += part[gi * plane + i];
    out[i] = __float2bfloat16(sum);
  }
}

constexpr int DK_ROWS = 64;     // rows of dK per block
constexpr int DK_STEP = 32;     // batch rows staged per step
constexpr int DK_LD = DK_ROWS + 8;
constexpr int DK_FRAGS = 8;     // fragment columns per warp
constexpr int DK_COLS = DK_FRAGS * 32;  // columns of dK per block: 4 x 16 fragments over 8 warps

// [per-warp scratch | hidden slice (32, DK_COLS + 8) | dP slice (32, 72)]
constexpr int DK_SMEM = WARPS * 16 * SCR_LD * 4 + DK_STEP * pad_ld(DK_COLS) * 2 +
                        DK_STEP * DK_LD * 2;

// grid (out_ch*in_ch / 64, ceil(c_dim / DK_COLS)): block (f, c) owns rows
// [64 f, 64 f + 64) and columns [c DK_COLS, c DK_COLS + DK_COLS) of dK;
// blocks of the first column chunk also sum db
__global__ void __launch_bounds__(THREADS)
hyper_apply_bwd_dk(const bf16* __restrict__ hidden, const bf16* __restrict__ x,
                   const bf16* __restrict__ g, bf16* __restrict__ dk,
                   float* __restrict__ db, int n_rows, int c_dim, int in_ch,
                   int out_ch) {
  __shared__ __align__(128) unsigned char smem[DK_SMEM];
  float* scratch = reinterpret_cast<float*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(scratch + WARPS * 16 * SCR_LD);
  constexpr int ldh = pad_ld(DK_COLS);
  bf16* dps = hs + DK_STEP * ldh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ws = scratch + warp * 16 * SCR_LD;
  const int f0 = blockIdx.x * DK_ROWS;
  const int col0 = blockIdx.y * DK_COLS;
  const int width = min(DK_COLS, c_dim - col0);
  const bool sum_db = blockIdx.y == 0;
  // warp w owns fragment row fm = w % 4 and fragment columns w / 4 + 2j
  const int fm = warp % 4;
  const int col_tiles = width / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DK_FRAGS];
#pragma unroll
  for (int j = 0; j < DK_FRAGS; ++j) wmma::fill_fragment(acc[j], 0.f);
  float db_sum = 0.f;       // thread t < 64 sums dP column f0 + t

  for (int b0 = 0; b0 < n_rows; b0 += DK_STEP) {
    const int chunks = width / 8;
    for (int i = threadIdx.x; i < DK_STEP * chunks; i += THREADS) {
      const int r = i / chunks;
      const int c = (i % chunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b0 + r < n_rows)
        v = *reinterpret_cast<const uint4*>(hidden + static_cast<size_t>(b0 + r) * c_dim + col0 + c);
      *reinterpret_cast<uint4*>(hs + r * ldh + c) = v;
    }
    for (int t = threadIdx.x; t < DK_STEP * DK_ROWS; t += THREADS) {
      const int r = t / DK_ROWS, fl = t % DK_ROWS;
      const int f = f0 + fl;
      float v = 0.f;
      if (b0 + r < n_rows) {
        const size_t b = static_cast<size_t>(b0 + r);
        v = __bfloat162float(__float2bfloat16(
            __bfloat162float(g[b * out_ch + f / in_ch]) *
            __bfloat162float(x[b * in_ch + f % in_ch])));
      }
      dps[r * DK_LD + fl] = __float2bfloat16(v);
    }
    __syncthreads();
    if (sum_db && threadIdx.x < DK_ROWS)
      for (int r = 0; r < DK_STEP; ++r)
        db_sum += __bfloat162float(dps[r * DK_LD + threadIdx.x]);
#pragma unroll
    for (int kk = 0; kk < DK_STEP; kk += 16) {
      // dP^T: element (f, b) of the fragment is dps[(kk + b) * DK_LD + f]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, dps + kk * DK_LD + fm * 16, DK_LD);
#pragma unroll
      for (int j = 0; j < DK_FRAGS; ++j) {
        const int nt = warp / 4 + 2 * j;
        if (nt >= col_tiles) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, hs + kk * ldh + nt * 16, ldh);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
  if (sum_db && threadIdx.x < DK_ROWS) db[f0 + threadIdx.x] = db_sum;
#pragma unroll
  for (int j = 0; j < DK_FRAGS; ++j) {
    const int nt = warp / 4 + 2 * j;
    if (nt >= col_tiles) break;
    wmma::store_matrix_sync(ws, acc[j], SCR_LD, wmma::mem_row_major);
    __syncwarp();
    for (int t = lane; t < 256; t += 32) {
      const int r = t / 16, c = t % 16;
      dk[static_cast<size_t>(f0 + fm * 16 + r) * c_dim + col0 + nt * 16 + c] =
          __float2bfloat16(ws[r * SCR_LD + c]);
    }
    __syncwarp();
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

// Same inputs as the forward plus g: (n_rows, out_ch). Outputs dh (n_rows,
// c_dim) and dx (n_rows, in_ch), bf16. Scratch part_dh (out_ch/16, rows_pad,
// c_dim) and part_dx (out_ch/16, rows_pad, in_ch) f32, rows_pad = n_rows
// rounded up to 64. Takes every width the forward takes.
CGAT_EXPORT int cgat_hyper_apply_bwd_dhdx(const void* hidden, const void* k,
                                          const void* bias, const void* x,
                                          const void* g, int n_rows,
                                          int c_dim, int in_ch, int out_ch,
                                          float* part_dh, float* part_dx,
                                          void* dh, void* dx, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = dhdx_smem_bytes(c_dim);
  cudaError_t err = allow_smem(hyper_apply_bwd_dhdx, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n_rows + BM - 1) / BM;
  const int jobs = (in_ch + JW - 1) / JW + (c_dim + JW - 1) / JW;
  const dim3 grid(row_blocks, out_ch / OC, jobs);
  hyper_apply_bwd_dhdx<<<grid, THREADS, bytes, st>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(k),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(x),
      static_cast<const bf16*>(g), part_dh, part_dx, n_rows, c_dim, in_ch,
      out_ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int rows_pad = row_blocks * BM;
  const int blocks = 264;
  reduce_groups<<<blocks, THREADS, 0, st>>>(part_dh, out_ch / OC, rows_pad,
                                            n_rows, c_dim,
                                            static_cast<bf16*>(dh));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_groups<<<blocks, THREADS, 0, st>>>(part_dx, out_ch / OC, rows_pad,
                                            n_rows, in_ch,
                                            static_cast<bf16*>(dx));
  return static_cast<int>(cudaGetLastError());
}

// hidden: (n_rows, c_dim); x: (n_rows, in_ch); g: (n_rows, out_ch), bf16.
// Outputs the weight rows of the last Linear's grads: dk (out_ch*in_ch,
// c_dim) bf16 and db (out_ch*in_ch,) f32.
CGAT_EXPORT int cgat_hyper_apply_bwd_dk(const void* hidden, const void* x,
                                        const void* g, int n_rows, int c_dim,
                                        int in_ch, int out_ch, void* dk,
                                        float* db, void* stream) {
  const dim3 grid(out_ch * in_ch / DK_ROWS, (c_dim + DK_COLS - 1) / DK_COLS);
  hyper_apply_bwd_dk<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(x),
      static_cast<const bf16*>(g), static_cast<bf16*>(dk), db, n_rows, c_dim,
      in_ch, out_ch);
  return static_cast<int>(cudaGetLastError());
}
