// Head-parallel two-layer MLP over a shared input (MultiHeadNetwork).
//
// Replaces the TPU kernel cgat_tpu/ops/pallas/mh_network.py: _fwd_kernel
// (launched by _fwd_impl). For x (E, cat) and each head k:
//
//   h_k = bf16(leaky_relu(x @ Win_k^T + b_in_k, 0.01))      (E, hid)
//   out[:, k*F:(k+1)*F] = bf16(h_k @ Wout_k^T + b_out_k)    (E, F)
//
// with f32 products and bias adds, and Win (H*hid, cat) and Wout (H*F, hid)
// in the reference's grouped Conv1d layout (rows of head k are
// contiguous): both products are "row times row", a K-major B, read from
// the weights as they are. The grouped second product runs per head, never
// as a dense (H*hid, H*F) block-diagonal matrix.
//
// Bound on the H100: operations. At the flagship shape (E = 18432,
// cat = 384, hid = 256, H = 5, F = 128, bf16) one call is 24.2 GFLOP of
// tensor-core work, ~24 us at 989 TFLOP/s, against 16 MB of input and
// output, ~5 us at 3.35 TB/s.
//
// Design: two products on the Hopper mainloop (gemm_sm90.cuh, described
// below for the backward), each with a bias epilogue that stores 16 bytes
// a lane, masked at E and at the width:
//   1. h = bf16(leaky(x @ Win^T + b_in)), all heads as one product
//      (M = E, N = H*hid, K = cat). h (E, H*hid) is the training form's
//      second output and the serving form's scratch (the wrapper allocates
//      it either way);
//   2. out_k = bf16(h_k @ Wout_k^T + b_out_k) per head (M = E, N = F,
//      K = hid): A is h through a rank-3 map (hid, heads, rows), B is Wout
//      through one whose outer axis is the head, so TMA's zero fill stops a
//      head's K at hid and its N at F.
// h makes a round trip through device memory (2 x 51 MB at the flagship,
// ~30 us at 3.35 TB/s, part of the read from L2); keeping h_k in shared
// memory between the two products needs a mainloop whose A comes from
// shared memory, and is later work. No atomics: the same bits every launch.
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
// 48 GFLOP, ~49 us at 989 TFLOP/s, against ~130 MB of x, h, g, dx and
// weights, ~39 us at 3.35 TB/s.
//
// Design: three launches on gemm_sm90.cuh's pieces (TMA into mbarrier
// stages, one producer thread, two consumer warpgroups on wgmma), no
// atomics, so two launches give the same bits:
//   A. dpre, dWout and both bias sums in one persistent launch (namespace
//      pass_a). A unit is (head k, 128 columns j of hid, a range of E
//      tiles), planned on the host for about one wave. The unit's Wout_kj
//      (F x 128) stays in shared memory; per 128-row E tile TMA brings g_k's
//      box (128 rows x F) and h_kj's tile into one of two stages. Warpgroup
//      0 runs dpre = g_k Wout_kj, masks it by h's sign, stores bf16 dpre
//      with 16-byte stores and sums db_in in f32 registers; warpgroup 1 runs
//      dWout_kj += g_k^T h_kj and db_out += g_k^T 1 (an n8 product with a
//      tile of ones) from the same two boxes, its accumulators held over
//      the range. g and h are read once. Each unit writes its f32 partials
//      of dWout, db_in and (j = 0) db_out, one per range. F > 128 does not
//      fit the stages: there dpre is a product of the generic mainloop
//      whose epilogue masks h's tile in a tile buffer (DpreEpi, per-tile
//      bias partials) and dWout a split-K product of its own;
//   B. dx = dpre @ Win and dWin = dpre^T x in one persistent launch
//      (namespace pass_b): the dWin units (128 x 128 tiles of H*hid x cat,
//      E cut into splits, A MN-major) first, then the dx tiles (128 x 128,
//      K = H*hid), spread over the blocks by a host plan so that they end
//      together; dx is stored 16 bytes a lane, dWin as f32 split partials;
//   C. one reduce adds the split and range partials in order and rounds to
//      bf16.
// Ragged E, F, hid and cat need no masked loads (TMA fills zeros past
// every edge, a head's included); stores are masked.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr float LEAKY_SLOPE = 0.01f;

// The 4 lanes q of a quad hold a row's columns in pairs, 8 columns apart
// from one fragment to the next: w[j] holds columns (4g + j) * 8 + 2q, + 1
// of fragments 4g .. 4g + 3. The quad transposes its 4 x 4 pairs by
// shuffles, in 2 x 2 blocks (lanes q, q ^ 1), then across them (q, q ^ 2),
// so that w[j] holds columns (4g + q) * 8 + 2j, + 1: 8 consecutive columns
// a lane, one 16-byte store, and a warp's store covers 8 rows x 64 bytes
// (with one 4-byte store a pair the forward took ~1.4x as long on the
// H100: chip_variants.py).
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int q) {
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    const uint32_t r =
        __shfl_xor_sync(0xffffffffu, (q & 1) ? w[k] : w[k + 1], 1);
    if (q & 1) w[k] = r; else w[k + 1] = r;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t r =
        __shfl_xor_sync(0xffffffffu, (q & 2) ? w[k] : w[k + 2], 2);
    if (q & 2) w[k] = r; else w[k + 2] = r;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Epilogue of the forward's products: out[row, z*n + col] =
// bf16(acc + bias[z*n + col]) with row stride ld, through the leaky ReLU
// when LEAKY; rows past m and columns past n (a multiple of 16) are not
// stored. 16-byte stores (quad_transpose).
template <bool LEAKY>
struct BiasEpi {
  static constexpr bool kTileIO = false;
  const bf16* bias;
  bf16* out;
  int m, n, ld;

  __device__ void operator()(float (&acc)[64], const sm90::Tile& t, float*,
                             unsigned char*) const {
    const int lane = t.thread % 32, warp = t.thread / 32, q = lane % 4;
    const int row0 = t.m0 + t.wg * 64 + warp * 16 + lane / 4;
    const bf16* b = bias + static_cast<size_t>(t.z) * n;
    bf16* o = out + static_cast<size_t>(t.z) * n;
#pragma unroll
    for (int g = 0; g < 4; ++g) {   // fragments 4g .. 4g + 3
      float2 bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t.n0 + (4 * g + j) * 8 + q * 2;
        bv[j] = col < n ? __bfloat1622float2(
                              *reinterpret_cast<const __nv_bfloat162*>(b + col))
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t w[4];   // w[j]: columns (4g + j) * 8 + 2q, + 1
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * g + j;
          float v0 = acc[i * 4 + half * 2] + bv[j].x;
          float v1 = acc[i * 4 + half * 2 + 1] + bv[j].y;
          if (LEAKY) {
            v0 = v0 > 0.f ? v0 : LEAKY_SLOPE * v0;
            v1 = v1 > 0.f ? v1 : LEAKY_SLOPE * v1;
          }
          w[j] = pack_bf16(v0, v1);
        }
        quad_transpose(w, q);
        const int row = row0 + half * 8;
        const int col = t.n0 + (4 * g + q) * 8;
        if (row < m && col < n)
          *reinterpret_cast<uint4*>(o + static_cast<size_t>(row) * ld + col) =
              make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

// Epilogue of dx (pass B): out[row, col] = bf16(acc), row stride ld, rows
// past m and columns past n (a multiple of 16) not stored; 16-byte stores
struct StoreEpi {
  bf16* out;
  int m, n, ld;

  __device__ void operator()(float (&acc)[64], const sm90::Tile& t, float*,
                             unsigned char*) const {
    const int lane = t.thread % 32, warp = t.thread / 32, q = lane % 4;
    const int row0 = t.m0 + t.wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * g + j;
          w[j] = pack_bf16(acc[i * 4 + half * 2], acc[i * 4 + half * 2 + 1]);
        }
        quad_transpose(w, q);
        const int row = row0 + half * 8;
        const int col = t.n0 + (4 * g + q) * 8;
        if (row < m && col < n)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * ld +
                                    col) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

// Epilogue of dpre where F > 128 (dpre of head z, on the generic
// mainloop): the tile of h_k arrives in the tile buffer (TMA); mask by its
// sign, write bf16 dpre over it in place (stored by TMA after the
// epilogue), and write per-tile f32 column sums of dpre (db_in) and of g_k
// (db_out, read back from L2).
struct DpreEpi {
  static constexpr bool kTileIO = true;
  const bf16* g;
  float* part_bin;    // (row tiles, heads*hid)
  float* part_bout;   // (row tiles, heads*f)
  int n_rows, hid, f, heads;

  __device__ void operator()(float (&acc)[64], const sm90::Tile& t,
                             float* scratch, unsigned char* tile) const {
    const int hh = heads * hid;
    const int lane = t.thread % 32, warp = t.thread / 32;
    float cs[32];   // this thread's column sums, (i, e) at 2*i + e
#pragma unroll
    for (int v = 0; v < 32; ++v) cs[v] = 0.f;
    // rows past E and columns past hid hold h = 0 and acc = 0: dpre 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = t.wg * 64 + warp * 16 + lane / 4 + half * 8;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            tile + sm90::tile_offset(r, i * 8 + (lane % 4) * 2));
        const float2 hv = __bfloat1622float2(*p);
        float d0 = acc[i * 4 + half * 2], d1 = acc[i * 4 + half * 2 + 1];
        d0 = hv.x > 0.f ? d0 : LEAKY_SLOPE * d0;
        d1 = hv.y > 0.f ? d1 : LEAKY_SLOPE * d1;
        *p = __floats2bfloat162_rn(d0, d1);
        cs[2 * i] += d0;
        cs[2 * i + 1] += d1;
      }
    }
    // the warp's 16 rows: lanes of one column pair differ in bits 2..4
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      cs[v] += __shfl_xor_sync(0xffffffffu, cs[v], 4);
      cs[v] += __shfl_xor_sync(0xffffffffu, cs[v], 8);
      cs[v] += __shfl_xor_sync(0xffffffffu, cs[v], 16);
    }
    if (lane < 4) {
      float* mine = scratch + (t.wg * 4 + warp) * 128;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mine[i * 8 + lane * 2] = cs[2 * i];
        mine[i * 8 + lane * 2 + 1] = cs[2 * i + 1];
      }
    }
    sm90::consumer_sync();
    // the 8 warps' sums in warp order
    if (t.wg == 0 && t.n0 + t.thread < hid) {
      float tot = 0.f;
      for (int w = 0; w < 8; ++w) tot += scratch[w * 128 + t.thread];
      part_bin[static_cast<size_t>(t.m_tile) * hh + t.z * hid + t.n0 +
               t.thread] = tot;
    }
    if (t.n0 != 0) return;
    // db_out: the tile's column sums of g_k, 128 columns a round; thread
    // (rg, chunk) sums 8 columns over rows [8 rg, 8 rg + 8) in row order,
    // its 8 rows' 16-byte loads in flight at once
    float* red = scratch + 8 * 128;
    const int tid = t.wg * 128 + t.thread;
    const int chunk = tid % 16, rg = tid / 16;
    for (int c0 = 0; c0 < f; c0 += 128) {
      const int c = c0 + chunk * 8;
      float sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = 0.f;
      if (c < f) {
        uint4 v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int row = t.m0 + rg * 8 + r;
          v[r] = row < n_rows
                     ? *reinterpret_cast<const uint4*>(
                           g + static_cast<size_t>(row) * heads * f +
                           t.z * f + c)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const unsigned int w[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
            sum[2 * e] += x.x;
            sum[2 * e + 1] += x.y;
          }
        }
      }
      sm90::consumer_sync();    // the previous round's sums are read
#pragma unroll
      for (int e = 0; e < 8; ++e) red[rg * 128 + chunk * 8 + e] = sum[e];
      sm90::consumer_sync();
      if (tid < 128 && c0 + tid < f) {
        float tot = 0.f;
        for (int i = 0; i < 16; ++i) tot += red[i * 128 + tid];
        part_bout[static_cast<size_t>(t.m_tile) * heads * f + t.z * f + c0 +
                  tid] = tot;
      }
    }
  }
};

// Epilogue of a weight grad's split (dWin in pass B, dWout where F > 128):
// the split's f32 partial of head z, at
// part[(split * heads + z) * m * n + row * n + col]
struct PartEpi {
  static constexpr bool kTileIO = false;
  float* part;
  int m, n, heads;

  __device__ void operator()(float (&acc)[64], const sm90::Tile& t, float*,
                             unsigned char*) const {
    const int lane = t.thread % 32, warp = t.thread / 32;
    const int row0 = t.m0 + t.wg * 64 + warp * 16 + lane / 4;
    float* out = part + static_cast<size_t>(t.split * heads + t.z) * m * n;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = t.n0 + i * 8 + (lane % 4) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        if (row < m && col < n)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * n +
                                     col) =
              make_float2(acc[i * 4 + half * 2], acc[i * 4 + half * 2 + 1]);
      }
    }
  }
};

// ---- pass A: dpre, dWout, db_in and db_out in one persistent launch -----
namespace pass_a {

constexpr int TILE = 128;                  // E rows of a tile; hid columns
constexpr int BOX = 64 * 2 * TILE;         // 64 columns x 128 lines, bf16
constexpr int G_BYTES = 2 * BOX;           // g_k: 128 rows x 128 of F
constexpr int H_BYTES = 2 * BOX;           // h_kj: 128 rows x 128 of hid
constexpr int STAGES = 2;
constexpr int STAGE_BYTES = G_BYTES + H_BYTES;
constexpr int W_BYTES = 2 * BOX;           // Wout_kj: 128 lines of F
constexpr int ONES_BYTES = 1024;           // the n8 product's B: all ones
constexpr int SCRATCH_FLOATS = 4 * TILE;   // warpgroup 0's column sums
constexpr int SMEM = 1024 + W_BYTES + STAGES * STAGE_BYTES + ONES_BYTES +
                     SCRATCH_FLOATS * 4 + (2 * STAGES + 2) * 8;

// The host's plan (bwd_plan in ops/kernels/mh_network.py): the E tiles
// cut into `ranges` ranges of `per` tiles; a unit is (range, head, hid
// tile), the hid tile fastest, then the head, so that the units that read
// one g box run side by side.
struct Plan {
  int n_rows, hid, f, heads;
  int j_tiles, m_tiles, ranges, per;
  __host__ __device__ int units() const { return ranges * heads * j_tiles; }
};

struct Unit {
  int range, k, j0, t_begin, t_end;
};

__device__ __forceinline__ Unit unit_at(const Plan& p, int u) {
  const int rest = u / p.j_tiles, range = rest / p.heads;
  return Unit{range, rest % p.heads, (u % p.j_tiles) * TILE, range * p.per,
              min(p.m_tiles, (range + 1) * p.per)};
}

// a named barrier of warpgroup 0 alone
__device__ __forceinline__ void wg0_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Warpgroup 1's f32 partial of dWout rows f0 + (r, r + 8) of the unit's
// head: 128 columns at wp, row stride hid; rows past f and columns past
// `cols` are not stored
__device__ __forceinline__ void store_wout(const float (&acc)[64], float* wp,
                                           int f0, int r, int q, int f,
                                           int hid, int cols) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = i * 8 + q * 2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = f0 + r + e * 8;
      if (row < f && col < cols)
        *reinterpret_cast<float2*>(wp + static_cast<size_t>(row) * hid +
                                   col) =
            make_float2(acc[i * 4 + e * 2], acc[i * 4 + e * 2 + 1]);
    }
  }
}

// Persistent: block b walks units b, b + gridDim.x, ... The producer thread
// loads the unit's Wout_kj once (two boxes of 64 hid columns x 128 lines of
// F, MN-major B) and, per 128-row E tile, g_k's box (two boxes of 64
// columns of F x 128 rows) and h_kj's tile (two boxes of 64 hid columns)
// into one of two stages. Past E, F and hid, and past a head's edge, TMA
// reads zeros.
// - Warpgroup 0 computes dpre for the tile's rows in two m64 halves:
//   wgmma with A K-major from g's box and B the resident Wout_kj, then an
//   epilogue that masks by h's sign (read from the stage), adds the f32
//   values into its 32 column sums, rounds to bf16 and stores 16 bytes a
//   lane. At the range's end the sums meet (quad shuffles, then the 4
//   warps in order) in db_in's partial.
// - Warpgroup 1 adds dWout_kj = g_k^T h_kj (A MN-major: g's two boxes are
//   F's two m64 halves; B MN-major: h's tile) and db_out = g_k^T 1 (n8,
//   B a tile of ones) into accumulators held over the range, keeping one
//   tile's products in flight, and at the range's end writes dWout's f32
//   partial and, for j = 0, db_out's.
__global__ void __launch_bounds__(sm90::THREADS, 1)
kernel(const __grid_constant__ CUtensorMap t_g,
       const __grid_constant__ CUtensorMap t_h,
       const __grid_constant__ CUtensorMap t_w, bf16* __restrict__ dpre,
       float* __restrict__ part_bin, float* __restrict__ part_bout,
       float* __restrict__ part_wout, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned buffers
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* w_s = smem;
  unsigned char* stages = w_s + W_BYTES;
  unsigned char* ones = stages + STAGES * STAGE_BYTES;
  float* scratch = reinterpret_cast<float*>(ones + ONES_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(scratch + SCRATCH_FLOATS);
  uint64_t* empty = full + STAGES;
  uint64_t* w_full = empty + STAGES;
  uint64_t* w_empty = w_full + 1;
  const int units = p.units();
  const int hh = p.heads * p.hid, hf = p.heads * p.f;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], sm90::CONSUMERS * 128);
    }
    sm90::mbar_init(w_full, 1);
    sm90::mbar_init(w_empty, 128);   // warpgroup 0 alone reads Wout_kj
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < ONES_BYTES / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(ones)[i] = 0x3F803F80u;   // bf16 1.0 pairs
  // the ones, written by threads, made visible to wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // `it` counts E tiles over all of this block's units: stage it % STAGES,
  // in its (it / STAGES)-th use; `ui` counts the block's units
  if (wg == sm90::CONSUMERS) {
    if (threadIdx.x == sm90::CONSUMERS * 128) {
      int it = 0, ui = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
        const Unit t = unit_at(p, u);
        sm90::mbar_wait(w_empty, (ui & 1) ^ 1);
        sm90::mbar_expect_tx(w_full, W_BYTES);
        sm90::tma_load(w_s, &t_w, w_full, t.j0, 0, t.k);
        sm90::tma_load(w_s + BOX, &t_w, w_full, t.j0 + 64, 0, t.k);
        for (int m = t.t_begin; m < t.t_end; ++m, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          unsigned char* g_s = stages + st * STAGE_BYTES;
          unsigned char* h_s = g_s + G_BYTES;
          sm90::mbar_expect_tx(&full[st], STAGE_BYTES);
          sm90::tma_load(g_s, &t_g, &full[st], 0, t.k, m * TILE);
          sm90::tma_load(g_s + BOX, &t_g, &full[st], 64, t.k, m * TILE);
          sm90::tma_load(h_s, &t_h, &full[st], t.j0, t.k, m * TILE);
          sm90::tma_load(h_s + BOX, &t_h, &full[st], t.j0 + 64, t.k,
                         m * TILE);
        }
      }
    }
    return;
  }

  const int thread = threadIdx.x % 128, warp = thread / 32, lane = thread % 32;
  const int q = lane % 4;
  const int r = warp * 16 + lane / 4;   // rows r and r + 8 of an m64 half
  int it = 0, ui = 0;
  if (wg == 0) {
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
      const Unit t = unit_at(p, u);
      float cs[32];   // column sums of dpre, (i, e) at 2i + e
#pragma unroll
      for (int v = 0; v < 32; ++v) cs[v] = 0.f;
      sm90::mbar_wait(w_full, ui & 1);
      const uint32_t w_addr = sm90::smem_u32(w_s);
      bf16* out = dpre + static_cast<size_t>(t.k) * p.hid + t.j0;
      for (int m = t.t_begin; m < t.t_end; ++m, ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(&full[st], (it / STAGES) & 1);
        unsigned char* g_s = stages + st * STAGE_BYTES;
        const unsigned char* h_s = g_s + G_BYTES;
        const uint32_t g_addr = sm90::smem_u32(g_s);
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {   // rows 64 half ..
          float acc[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0.f;
          sm90::fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          // K = F: 16 columns are 32 bytes along g's line, the next 64 the
          // next box; Wout's 16 K lines are 2048 bytes, LBO its next box
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            sm90::wgmma_m64n128k16<0, 1>(
                acc,
                sm90::smem_desc(g_addr + (kk / 4) * BOX + half * 64 * 128 +
                                    (kk % 4) * 32,
                                16, 1024),
                sm90::smem_desc(w_addr + kk * 2048, BOX, 1024));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          sm90::fence_acc(acc);
          // mask by h's sign, sum in f32, store bf16 16 bytes a lane; rows
          // past E and columns past hid hold h = 0 and acc = 0
          const int rr = half * 64 + r;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
#pragma unroll
            for (int hf8 = 0; hf8 < 2; ++hf8) {
              uint32_t w[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int i = 4 * g + j;
                const float2 hv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(
                        h_s + sm90::tile_offset(rr + hf8 * 8, i * 8 + q * 2)));
                float d0 = acc[i * 4 + hf8 * 2], d1 = acc[i * 4 + hf8 * 2 + 1];
                d0 = hv.x > 0.f ? d0 : LEAKY_SLOPE * d0;
                d1 = hv.y > 0.f ? d1 : LEAKY_SLOPE * d1;
                cs[2 * i] += d0;
                cs[2 * i + 1] += d1;
                w[j] = pack_bf16(d0, d1);
              }
              quad_transpose(w, q);
              const int row = m * TILE + rr + hf8 * 8;
              const int col = (4 * g + q) * 8;
              if (row < p.n_rows && t.j0 + col < p.hid)
                *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * hh +
                                          col) =
                    make_uint4(w[0], w[1], w[2], w[3]);
            }
          }
        }
        sm90::mbar_arrive(&empty[st]);
      }
      sm90::mbar_arrive(w_empty);
      // db_in: the warp's 32 rows (lanes of a column pair differ in bits
      // 2..4), then the 4 warps in order
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        cs[v] += __shfl_xor_sync(0xffffffffu, cs[v], 4);
        cs[v] += __shfl_xor_sync(0xffffffffu, cs[v], 8);
        cs[v] += __shfl_xor_sync(0xffffffffu, cs[v], 16);
      }
      if (lane < 4) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          scratch[warp * TILE + i * 8 + lane * 2] = cs[2 * i];
          scratch[warp * TILE + i * 8 + lane * 2 + 1] = cs[2 * i + 1];
        }
      }
      wg0_sync();
      if (t.j0 + thread < p.hid)
        part_bin[static_cast<size_t>(t.range) * hh + t.k * p.hid + t.j0 +
                 thread] = scratch[thread] + scratch[TILE + thread] +
                           scratch[2 * TILE + thread] +
                           scratch[3 * TILE + thread];
      wg0_sync();   // the sums are read before the next unit writes them
    }
    return;
  }

  // warpgroup 1: dWout_kj (F's halves 0 and 1) and db_out
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
    const Unit t = unit_at(p, u);
    float acc0[64], acc1[64], ob0[4], ob1[4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) ob0[i] = ob1[i] = 0.f;
    const uint32_t ones_addr = sm90::smem_u32(ones);
    for (int m = t.t_begin; m < t.t_end; ++m, ++it) {
      const int st = it % STAGES;
      sm90::mbar_wait(&full[st], (it / STAGES) & 1);
      const uint32_t g_addr = sm90::smem_u32(stages + st * STAGE_BYTES);
      const uint32_t h_addr = g_addr + G_BYTES;
      sm90::fence_acc(acc0);
      sm90::fence_acc(acc1);
      sm90::fence_acc(ob0);
      sm90::fence_acc(ob1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // K = the tile's 128 rows: 16 lines of 2048 bytes a step in g's box
      // (MN-major A, one m64 half a box) and in h's (MN-major B, LBO its
      // next 64 columns)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t hd = sm90::smem_desc(h_addr + kk * 2048, BOX, 1024);
        const uint64_t g0 = sm90::smem_desc(g_addr + kk * 2048, BOX, 1024);
        const uint64_t g1 =
            sm90::smem_desc(g_addr + BOX + kk * 2048, BOX, 1024);
        const uint64_t od = sm90::smem_desc(ones_addr, 16, 1024);
        sm90::wgmma_m64n128k16<1, 1>(acc0, g0, hd);
        sm90::wgmma_m64n128k16<1, 1>(acc1, g1, hd);
        sm90::wgmma_m64n8k16<1, 0>(ob0, g0, od);
        sm90::wgmma_m64n8k16<1, 0>(ob1, g1, od);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      sm90::fence_acc(acc0);
      sm90::fence_acc(acc1);
      sm90::fence_acc(ob0);
      sm90::fence_acc(ob1);
      // keep this tile's products in flight; the previous tile's are done
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (m > t.t_begin) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    sm90::fence_acc(acc0);
    sm90::fence_acc(acc1);
    sm90::fence_acc(ob0);
    sm90::fence_acc(ob1);
    if (t.t_end > t.t_begin) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
    // the range's f32 partials: dWout rows k*F + f, columns j0 + ...
    float* wp = part_wout +
                (static_cast<size_t>(t.range) * hf + t.k * p.f) * p.hid + t.j0;
    store_wout(acc0, wp, 0, r, q, p.f, p.hid, p.hid - t.j0);
    store_wout(acc1, wp, 64, r, q, p.f, p.hid, p.hid - t.j0);
    // db_out: every column of the n8 product is the row's sum; lane q = 0
    // holds column 0 of rows r and r + 8
    if (t.j0 == 0 && q == 0) {
      float* bp = part_bout + static_cast<size_t>(t.range) * hf + t.k * p.f;
      if (r < p.f) bp[r] = ob0[0];
      if (r + 8 < p.f) bp[r + 8] = ob0[2];
      if (64 + r < p.f) bp[64 + r] = ob1[0];
      if (72 + r < p.f) bp[72 + r] = ob1[2];
    }
  }
}

}  // namespace pass_a

// ---- pass B: dx and dWin in one persistent launch -----------------------
namespace pass_b {

using sm90::BK;
using sm90::HALF;
constexpr int TILE = 128;
constexpr int STAGES = 6;
constexpr int SMEM = 1024 + STAGES * sm90::STAGE_BYTES + 2 * STAGES * 8;

// The host's plan (bwd_plan in ops/kernels/mh_network.py). The dWin units
// are (tile of H*hid x cat, split of E), the tile fastest, n_w of them;
// block b takes units b, b + blocks, ... The dx tiles (m tile, cat tile,
// the cat tile fastest) are dealt out in rounds: a block with one dWin unit
// more than the others (b < n_w % blocks) takes x_a of them (+1 for the
// first x_ra of those blocks), every other block x_c (+1 for the first
// x_rc); in round j each block that takes a j-th tile takes the next one
// in block order, so that blocks side by side run tiles that share their
// rows of dpre while those rows are in L2.
struct Plan {
  int n_rows, cat, hh;
  int n_tiles;                  // 128-column tiles of cat
  int w_tiles;                  // 128 x 128 tiles of dWin
  int s_win, r_win;             // E splits of dWin, r_win a multiple of 64
  int x_tiles;                  // 128 x 128 tiles of dx
  int blocks, x_a, x_ra, x_c, x_rc;
  __host__ __device__ int n_w() const { return w_tiles * s_win; }
  __host__ __device__ int dx_count(int b) const {
    const int rw = n_w() % blocks;
    return b < rw ? x_a + (b < x_ra ? 1 : 0) : x_c + (b - rw < x_rc ? 1 : 0);
  }
  // block b's j-th dx tile: the tiles of rounds 0 .. j-1, then b's place
  // among round j's blocks
  __host__ __device__ int dx_tile(int b, int j) const {
    const int rw = n_w() % blocks, nb = blocks - rw;
    const int in_a = j < x_a ? rw : j == x_a ? x_ra : 0;
    const int before = rw * (j < x_a ? j : x_a) + (j > x_a ? x_ra : 0) +
                       nb * (j < x_c ? j : x_c) + (j > x_c ? x_rc : 0);
    return before + (b < rw ? b : in_a + b - rw);
  }
};

struct Unit {
  bool dx;
  int m0, n0, split, k_begin, k_end;
};

// the i-th unit of block b, which has `mine_w` dWin units
__device__ __forceinline__ Unit unit_at(const Plan& p, int b, int mine_w,
                                        int i) {
  if (i < mine_w) {
    const int u = b + i * p.blocks;
    const int tile = u % p.w_tiles, split = u / p.w_tiles;
    const int k0 = split * p.r_win;
    return Unit{false, (tile / p.n_tiles) * TILE, (tile % p.n_tiles) * TILE,
                split, k0, min(p.n_rows, k0 + p.r_win)};
  }
  const int x = p.dx_tile(b, i - mine_w);
  return Unit{true, (x / p.n_tiles) * TILE, (x % p.n_tiles) * TILE, 0, 0,
              p.hh};
}

// a consumer warpgroup's k-blocks of one unit: A K-major (dx: dpre's
// rows) or MN-major (TA, dWin: dpre^T), B MN-major (Win's or x's rows)
template <int TA>
__device__ __forceinline__ void mainloop(float (&acc)[64],
                                         unsigned char* smem, uint64_t* full,
                                         uint64_t* empty, int k_begin,
                                         int k_end, int wg, int& it) {
  for (int k0 = k_begin; k0 < k_end; k0 += BK, ++it) {
    const int st = it % STAGES;
    sm90::mbar_wait(&full[st], (it / STAGES) & 1);
    const uint32_t a_addr =
        sm90::smem_u32(smem + st * sm90::STAGE_BYTES) + wg * HALF;
    const uint32_t b_addr =
        sm90::smem_u32(smem + st * sm90::STAGE_BYTES + sm90::A_BYTES);
    sm90::fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TA ? sm90::smem_desc(a_addr + kk * 2048, HALF, 1024)
                             : sm90::smem_desc(a_addr + kk * 32, 16, 1024);
      sm90::wgmma_m64n128k16<TA, 1>(
          acc, da, sm90::smem_desc(b_addr + kk * 2048, HALF, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    sm90::fence_acc(acc);
    // keep this stage's products in flight; the previous stage is done
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (k0 > k_begin) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  sm90::fence_acc(acc);
  if (k_end > k_begin) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
}

// Persistent: the producer thread keeps up to STAGES k-blocks of the
// block's units in flight (dWin: two MN-major boxes of dpre's and of x's
// rows; dx: a K-major box of dpre's rows and two MN-major boxes of Win's),
// and each consumer warpgroup runs its 64 rows of the unit's tile, then
// its epilogue while the next unit's stages arrive.
__global__ void __launch_bounds__(sm90::THREADS, 1)
kernel(const __grid_constant__ CUtensorMap t_dpre_mn,
       const __grid_constant__ CUtensorMap t_x,
       const __grid_constant__ CUtensorMap t_dpre_k,
       const __grid_constant__ CUtensorMap t_win, bf16* __restrict__ dx,
       float* __restrict__ part_win, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * sm90::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int b = blockIdx.x;
  const int mine_w = p.n_w() / p.blocks + (b < p.n_w() % p.blocks ? 1 : 0);
  const int count = mine_w + p.dx_count(b);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], sm90::CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == sm90::CONSUMERS) {
    if (threadIdx.x == sm90::CONSUMERS * 128) {
      int it = 0;
      for (int i = 0; i < count; ++i) {
        const Unit t = unit_at(p, b, mine_w, i);
        for (int k0 = t.k_begin; k0 < t.k_end; k0 += BK, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          unsigned char* a_s = smem + st * sm90::STAGE_BYTES;
          unsigned char* b_s = a_s + sm90::A_BYTES;
          sm90::mbar_expect_tx(&full[st], sm90::STAGE_BYTES);
          if (t.dx) {
            sm90::tma_load(a_s, &t_dpre_k, &full[st], k0, 0, t.m0);
            sm90::tma_load(b_s, &t_win, &full[st], t.n0, k0, 0);
            sm90::tma_load(b_s + HALF, &t_win, &full[st], t.n0 + 64, k0, 0);
          } else {
            sm90::tma_load(a_s, &t_dpre_mn, &full[st], t.m0, 0, k0);
            sm90::tma_load(a_s + HALF, &t_dpre_mn, &full[st], t.m0 + 64, 0,
                           k0);
            sm90::tma_load(b_s, &t_x, &full[st], t.n0, 0, k0);
            sm90::tma_load(b_s + HALF, &t_x, &full[st], t.n0 + 64, 0, k0);
          }
        }
      }
    }
    return;
  }

  int it = 0;
  for (int i = 0; i < count; ++i) {
    const Unit t = unit_at(p, b, mine_w, i);
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    const sm90::Tile tl{t.m0, t.n0, 0, 0, t.split, wg,
                        static_cast<int>(threadIdx.x % 128)};
    if (t.dx) {
      mainloop<0>(acc, smem, full, empty, t.k_begin, t.k_end, wg, it);
      StoreEpi{dx, p.n_rows, p.cat, p.cat}(acc, tl, nullptr, nullptr);
    } else {
      mainloop<1>(acc, smem, full, empty, t.k_begin, t.k_end, wg, it);
      PartEpi{part_win, p.hh, p.cat, 1}(acc, tl, nullptr, nullptr);
    }
  }
}

}  // namespace pass_b

// Pass C: out[i] = bf16(sum_s part[s * len + i]), s in order, for the four
// outputs of one backward in one launch. Blocks [0, short_blocks) take the
// weight grads (lengths multiples of 4), whose few splits or ranges a
// thread loads 4 entries at a time, 8 parts in flight; the rest take the
// bias grads, whose partials (one per range, or per tile where F > 128) 16
// threads share: thread l sums parts l, l + 16, ... in order, and the 16
// meet in a fixed tree.
struct ReduceJob {
  const float* part;
  int parts;
  int64_t len;
  bf16* out;
};

__global__ void reduce_parts(ReduceJob w_in, ReduceJob w_out, ReduceJob b_in,
                             ReduceJob b_out, int short_blocks) {
  if (static_cast<int>(blockIdx.x) < short_blocks) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    const bool first = i < w_in.len / 4;
    const ReduceJob j = first ? w_in : w_out;
    const int64_t k = first ? i : i - w_in.len / 4;
    if (k >= j.len / 4) return;
    const float4* part = reinterpret_cast<const float4*>(j.part);
    // added in part order (a part past the last adds 0, which changes no
    // sum)
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < j.parts; s += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = s + u < j.parts ? part[(s + u) * (j.len / 4) + k]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        sum.x += v[u].x;
        sum.y += v[u].y;
        sum.z += v[u].z;
        sum.w += v[u].w;
      }
    }
    *reinterpret_cast<uint2*>(j.out + 4 * k) =
        make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    return;
  }
  const int64_t q =
      static_cast<int64_t>(blockIdx.x - short_blocks) * blockDim.x +
      threadIdx.x;
  const int64_t i = q / 16;
  const int l = static_cast<int>(q % 16);
  const bool first = i < b_in.len;
  const ReduceJob j = first ? b_in : b_out;
  const int64_t k = first ? i : i - b_in.len;
  float sum = 0.f;
  if (k < j.len) {
#pragma unroll 4
    for (int s = l; s < j.parts; s += 16) sum += j.part[s * j.len + k];
  }
  // every lane of the warp takes part in the tree
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (l == 0 && k < j.len) j.out[k] = __float2bfloat16(sum);
}

}  // namespace

// x: (n_rows, cat); win: (heads*hid, cat); b_in: (heads*hid,);
// wout: (heads*f, hid); b_out: (heads*f,); out: (n_rows, heads*f); h:
// (n_rows, heads*hid), written by the first product and read by the second
// (never null). All bf16, C-contiguous, 32-byte aligned; cat, hid and f
// multiples of 16.
CGAT_EXPORT int cgat_mh_network_fwd(const void* x, const void* win,
                                    const void* b_in, const void* wout,
                                    const void* b_out, void* out, void* h,
                                    int n_rows, int cat, int hid, int f,
                                    int heads, void* stream) {
  if (n_rows <= 0) return 0;
  if (h == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hh = heads * hid;
  cudaError_t err;
  CUtensorMap x_k, win_k, h_k, wout_k;
  if ((err = sm90::map_k_major(&x_k, x, cat, 1, n_rows, cat)) ||
      (err = sm90::map_k_major_b(&win_k, win, cat, hh, cat, 1,
                                 static_cast<uint64_t>(hh) * cat)) ||
      (err = sm90::map_k_major(&h_k, h, hid, heads, n_rows, hh)) ||
      (err = sm90::map_k_major_b(&wout_k, wout, hid, f, hid, heads,
                                 static_cast<uint64_t>(f) * hid)))
    return static_cast<int>(err);
  // 1. h = bf16(leaky(x @ Win^T + b_in)), every head in one product
  if ((err = sm90::launch<false, false>(
           x_k, win_k, sm90::Shape{n_rows, hh, cat, cat, 1, 1, 0, 0},
           BiasEpi<true>{static_cast<const bf16*>(b_in),
                         static_cast<bf16*>(h), n_rows, hh, hh},
           st)))
    return static_cast<int>(err);
  // 2. out_k = bf16(h_k @ Wout_k^T + b_out_k), per head
  return static_cast<int>(sm90::launch<false, false>(
      h_k, wout_k, sm90::Shape{n_rows, f, hid, hid, heads, 1, 0, 0},
      BiasEpi<false>{static_cast<const bf16*>(b_out),
                     static_cast<bf16*>(out), n_rows, f, heads * f},
      st));
}

// x: (n_rows, cat); h: (n_rows, heads*hid) from the forward; g: (n_rows,
// heads*f) cotangent; win, wout as in the forward. Outputs: dx (n_rows,
// cat), dwin (heads*hid, cat), dbin (heads*hid,), dwout (heads*f, hid),
// dbout (heads*f,), all bf16. Scratch: dpre (n_rows, heads*hid) bf16;
// part_bin (bias_parts, heads*hid), part_bout (bias_parts, heads*f),
// part_wout (s_wout, heads*f, hid) and part_win (s_win, heads*hid, cat),
// f32. The wrapper's bwd_plan makes the plan, ints in this order:
//   fused       1: pass A (f <= 128); 0: dpre and dWout as two products
//   bias_parts  fused: s_wout; else the count of 128-row tiles
//   s_wout, r_wout  fused: E ranges of r_wout rows (a multiple of 128, none
//                   empty); else dWout's E splits (multiples of 64)
//   s_win, r_win    dWin's E splits (multiples of 64 rows, none empty)
//   blocks, x_a, x_ra, x_c, x_rc   pass B's grid and dx runs (pass_b::Plan)
// A plan made for another tiling is refused. Same layout rules as the
// forward.

CGAT_EXPORT int cgat_mh_network_bwd(
    const void* x, const void* h, const void* g, const void* win,
    const void* wout, int n_rows, int cat, int hid, int f, int heads,
    const int* plan, void* dx, void* dpre, float* part_bin,
    float* part_bout, float* part_wout, float* part_win, void* dwin,
    void* dbin, void* dwout, void* dbout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hh = heads * hid, hf = heads * f;
  cudaError_t err;
  if (n_rows <= 0) {   // no rows: every gradient is zero
    if ((err = cudaMemsetAsync(dwin, 0, sizeof(bf16) * hh * cat, st)) ||
        (err = cudaMemsetAsync(dbin, 0, sizeof(bf16) * hh, st)) ||
        (err = cudaMemsetAsync(dwout, 0, sizeof(bf16) * hf * hid, st)) ||
        (err = cudaMemsetAsync(dbout, 0, sizeof(bf16) * hf, st)))
      return static_cast<int>(err);
    return 0;
  }
  const int fused = plan[0], bias_parts = plan[1], s_wout = plan[2],
            r_wout = plan[3], s_win = plan[4], r_win = plan[5];
  const int m_tiles = (n_rows + sm90::BM - 1) / sm90::BM;
  const auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
  const pass_b::Plan pb{n_rows, cat, hh, cdiv(cat, pass_b::TILE),
                        cdiv(hh, pass_b::TILE) * cdiv(cat, pass_b::TILE),
                        s_win, r_win, m_tiles * cdiv(cat, pass_b::TILE),
                        plan[6], plan[7], plan[8], plan[9], plan[10]};
  const bool bad_a =
      fused ? f > pass_a::TILE || bias_parts != s_wout ||
                  r_wout % pass_a::TILE || r_wout <= 0 ||
                  s_wout != cdiv(n_rows, r_wout)
            : bias_parts != m_tiles || r_wout % sm90::BK || r_wout <= 0 ||
                  s_wout != cdiv(n_rows, r_wout);
  const int rw = pb.blocks > 0 ? pb.n_w() % pb.blocks : 0;
  const bool bad_b = r_win % sm90::BK || r_win <= 0 ||
                     s_win != cdiv(n_rows, r_win) || pb.blocks < 1 ||
                     pb.x_a < 0 || pb.x_c < 0 || pb.x_ra < 0 ||
                     pb.x_rc < 0 || pb.x_ra > rw ||
                     pb.x_rc > pb.blocks - rw ||
                     rw * pb.x_a + pb.x_ra + (pb.blocks - rw) * pb.x_c +
                             pb.x_rc != pb.x_tiles;
  if (bad_a || bad_b) return static_cast<int>(cudaErrorInvalidValue);

  // A. dpre, dWout and the bias partials
  if (fused) {
    CUtensorMap t_g, t_h, t_w;
    if ((err = sm90::map_k_major(&t_g, g, f, heads, n_rows, hf)) ||
        (err = sm90::map_k_major(&t_h, h, hid, heads, n_rows, hh)) ||
        (err = sm90::make_map(&t_w, wout, hid, f, hid * 2, heads,
                              static_cast<uint64_t>(f) * hid * 2,
                              pass_a::TILE, 1)))
      return static_cast<int>(err);
    static int per_device[sm90::MAX_DEVICES] = {};
    int sms = 0;
    if ((err = sm90::prepare(pass_a::kernel, pass_a::SMEM, per_device, &sms)))
      return static_cast<int>(err);
    const pass_a::Plan pa{n_rows, hid, f, heads, cdiv(hid, pass_a::TILE),
                          m_tiles, s_wout, r_wout / pass_a::TILE};
    const int units = pa.units();
    pass_a::kernel<<<units < sms ? units : sms, sm90::THREADS, pass_a::SMEM,
                     st>>>(t_g, t_h, t_w, static_cast<bf16*>(dpre), part_bin,
                           part_bout, part_wout, pa);
    if ((err = cudaGetLastError())) return static_cast<int>(err);
  } else {
    CUtensorMap g_k, wout_mn, h_tile, dpre_tile, g_mn, h_mn;
    if ((err = sm90::map_k_major(&g_k, g, f, heads, n_rows, hf)) ||
        (err = sm90::map_k_major(&h_tile, h, hid, heads, n_rows, hh)) ||
        (err = sm90::map_k_major(&dpre_tile, dpre, hid, heads, n_rows, hh)) ||
        (err = sm90::map_mn_major(&wout_mn, wout, hid, heads, f, hid,
                                  static_cast<uint64_t>(f) * hid, false)) ||
        (err = sm90::map_mn_major(&g_mn, g, f, heads, n_rows, hf, 0, true)) ||
        (err = sm90::map_mn_major(&h_mn, h, hid, heads, n_rows, hh, 0, true)))
      return static_cast<int>(err);
    const DpreEpi dpre_epi{static_cast<const bf16*>(g), part_bin, part_bout,
                           n_rows, hid, f, heads};
    if ((err = sm90::launch<false>(
             g_k, wout_mn, sm90::Shape{n_rows, hid, f, f, heads, 1, 0, 0},
             dpre_epi, st, &h_tile, &dpre_tile)) ||
        (err = sm90::launch<true>(
             g_mn, h_mn,
             sm90::Shape{f, hid, n_rows, r_wout, heads, s_wout, 1, 1},
             PartEpi{part_wout, f, hid, heads}, st)))
      return static_cast<int>(err);
  }

  // B. dx and the split partials of dWin
  {
    CUtensorMap dpre_mn, x_mn, dpre_k, win_mn;
    if ((err = sm90::map_mn_major(&dpre_mn, dpre, hh, 1, n_rows, hh, 0,
                                  true)) ||
        (err = sm90::map_mn_major(&x_mn, x, cat, 1, n_rows, cat, 0, true)) ||
        (err = sm90::map_k_major(&dpre_k, dpre, hh, 1, n_rows, hh)) ||
        (err = sm90::map_mn_major(&win_mn, win, cat, 1, hh, cat,
                                  static_cast<uint64_t>(hh) * cat, false)))
      return static_cast<int>(err);
    static int per_device[sm90::MAX_DEVICES] = {};
    int sms = 0;
    if ((err = sm90::prepare(pass_b::kernel, pass_b::SMEM, per_device, &sms)))
      return static_cast<int>(err);
    pass_b::kernel<<<pb.blocks, sm90::THREADS, pass_b::SMEM, st>>>(
        dpre_mn, x_mn, dpre_k, win_mn, static_cast<bf16*>(dx), part_win, pb);
    if ((err = cudaGetLastError())) return static_cast<int>(err);
  }

  // C. the four sums in order, rounded to bf16
  const ReduceJob w_in{part_win, s_win, static_cast<int64_t>(hh) * cat,
                       static_cast<bf16*>(dwin)};
  const ReduceJob w_out{part_wout, s_wout, static_cast<int64_t>(hf) * hid,
                        static_cast<bf16*>(dwout)};
  const ReduceJob b_in{part_bin, bias_parts, hh, static_cast<bf16*>(dbin)};
  const ReduceJob b_out{part_bout, bias_parts, hf, static_cast<bf16*>(dbout)};
  const int short_blocks =
      static_cast<int>((w_in.len / 4 + w_out.len / 4 + 255) / 256);
  const int long_blocks = static_cast<int>((16 * (b_in.len + b_out.len) +
                                            255) / 256);
  reduce_parts<<<short_blocks + long_blocks, 256, 0, st>>>(
      w_in, w_out, b_in, b_out, short_blocks);
  return static_cast<int>(cudaGetLastError());
}
