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
// Design: the four products run on one Hopper mainloop (gemm_sm90.cuh:
// TMA into a 4-stage shared-memory ring, a producer thread, two consumer
// warpgroups on wgmma, 128 x 128 tiles), each with its own epilogue, then
// one reduce. No atomics, so two launches give the same bits:
//   1. dpre, per head (M = E, N = hid, K = F): TMA brings the tile of h_k
//      into a shared-memory buffer (two, so the next tile's arrives during
//      this epilogue); the epilogue masks by its sign, writes bf16 dpre
//      over it, which TMA stores to a scratch array, and writes the tile's
//      f32 column sums of dpre (db_in) and, in the first column tile, of
//      g_k (db_out, read back from L2) as per-tile partials;
//   2. dx = dpre @ Win (M = E, N = cat, K = H*hid), bf16 store;
//   3. dWin = dpre^T x (M = H*hid, N = cat) and dWout_k = g_k^T h_k
//      (M = F, N = hid) reduce over the E rows, which the TPU kernel
//      carries across its sequential grid. Both operands are E-major, so A
//      is MN-major and wgmma reads it transposed from shared memory. E is
//      split into ranges of at least 1024 rows (a multiple of 64) so that
//      about one wave fills the 132 SMs (the wrapper plans them); each
//      split writes its f32 partial tile;
//   4. one reduce adds the split partials and the per-tile bias partials
//      in order and rounds to bf16.
// Ragged E, F, hid and cat need no masked loads (TMA fills zeros past
// every edge, a head's included); stores are masked.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr float LEAKY_SLOPE = 0.01f;

// Epilogue of the forward's products: out[row, z*n + col] =
// bf16(acc + bias[z*n + col]) with row stride ld, through the leaky ReLU
// when LEAKY; rows past m and columns past n (a multiple of 16) are not
// stored. The 4 lanes of a quad hold a row's columns in pairs (8 columns
// apart from one fragment to the next); per 4 fragments they transpose
// their 4 x 4 pairs by shuffles, so that each lane stores 8 consecutive
// columns in one 16-byte store and a warp's store covers 8 rows x 64
// bytes (with one 4-byte store a pair the forward took ~1.4x as long on
// the H100: chip_variants.py).
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
          const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
          w[j] = *reinterpret_cast<const uint32_t*>(&p);
        }
        // transpose in 2 x 2 blocks (lanes q, q ^ 1), then across them
        // (q, q ^ 2): w[j] becomes columns (4g + q) * 8 + 2j, + 1
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
        const int row = row0 + half * 8;
        const int col = t.n0 + (4 * g + q) * 8;
        if (row < m && col < n)
          *reinterpret_cast<uint4*>(o + static_cast<size_t>(row) * ld + col) =
              make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

// Epilogue of step 1 (dpre of head z): the tile of h_k arrives in the tile
// buffer (TMA); mask by its sign, write bf16 dpre over it in place (stored
// by TMA after the epilogue), and write per-tile f32 column sums of dpre
// (db_in) and of g_k (db_out).
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

// Epilogue of step 2: bf16 store of an (m, n) output, row stride ld
struct Bf16Epi {
  static constexpr bool kTileIO = false;
  bf16* out;
  int m, n, ld;

  __device__ void operator()(float (&acc)[64], const sm90::Tile& t, float*,
                             unsigned char*) const {
    const int lane = t.thread % 32, warp = t.thread / 32;
    const int row0 = t.m0 + t.wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = t.n0 + i * 8 + (lane % 4) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        if (row < m && col < n)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(row) * ld + col) =
              __floats2bfloat162_rn(acc[i * 4 + half * 2],
                                    acc[i * 4 + half * 2 + 1]);
      }
    }
  }
};

// Epilogue of step 3: the split's f32 partial of head z, at
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

// Step 4: out[i] = bf16(sum_s part[s * len + i]), s in order, for the four
// outputs of one backward in one launch. Blocks [0, short_blocks) take the
// weight grads, whose few splits a thread loads all at once; the rest take
// the bias grads, whose per-tile partials (~150) 16 threads share: thread l
// sums parts l, l + 16, ... in order, and the 16 meet in a fixed tree.
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
    const bool first = i < w_in.len;
    const ReduceJob j = first ? w_in : w_out;
    const int64_t k = first ? i : i - w_in.len;
    if (k >= j.len) return;
    // 16 loads in flight, added in split order (a split past the last adds
    // 0, which changes no sum)
    float sum = 0.f;
    for (int s = 0; s < j.parts; s += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        v[u] = s + u < j.parts ? j.part[(s + u) * j.len + k] : 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) sum += v[u];
    }
    j.out[k] = __float2bfloat16(sum);
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
// part_bin (tiles, heads*hid) and part_bout (tiles, heads*f) f32, tiles
// the count of sm90::BM-row tiles; part_win (s_win, heads*hid, cat) and
// part_wout (s_wout, heads*f, hid) f32, the splits r_win and r_wout rows
// long (multiples of sm90::BK). The wrapper's bwd_plan makes the plan;
// one made for another tiling is refused. Same layout rules as the
// forward.
CGAT_EXPORT int cgat_mh_network_bwd(
    const void* x, const void* h, const void* g, const void* win,
    const void* wout, int n_rows, int cat, int hid, int f, int heads,
    void* dx, void* dpre, int tiles, float* part_bin, float* part_bout,
    int s_win, int r_win, float* part_win, int s_wout, int r_wout,
    float* part_wout, void* dwin, void* dbin, void* dwout, void* dbout,
    void* stream) {
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
  if (tiles != (n_rows + sm90::BM - 1) / sm90::BM || s_win < 1 ||
      s_wout < 1 || r_win % sm90::BK || r_wout % sm90::BK ||
      static_cast<int64_t>(s_win) * r_win < n_rows ||
      static_cast<int64_t>(s_wout) * r_wout < n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap g_k, wout_mn, h_tile, dpre_tile, dpre_k, win_mn, dpre_mn, x_mn,
      g_mn, h_mn;
  if ((err = sm90::map_k_major(&g_k, g, f, heads, n_rows, hf)) ||
      (err = sm90::map_k_major(&h_tile, h, hid, heads, n_rows, hh)) ||
      (err = sm90::map_k_major(&dpre_tile, dpre, hid, heads, n_rows, hh)) ||
      (err = sm90::map_mn_major(&wout_mn, wout, hid, heads, f, hid,
                                static_cast<uint64_t>(f) * hid, false)) ||
      (err = sm90::map_k_major(&dpre_k, dpre, hh, 1, n_rows, hh)) ||
      (err = sm90::map_mn_major(&win_mn, win, cat, 1, hh, cat,
                                static_cast<uint64_t>(hh) * cat, false)) ||
      (err = sm90::map_mn_major(&dpre_mn, dpre, hh, 1, n_rows, hh, 0, true)) ||
      (err = sm90::map_mn_major(&x_mn, x, cat, 1, n_rows, cat, 0, true)) ||
      (err = sm90::map_mn_major(&g_mn, g, f, heads, n_rows, hf, 0, true)) ||
      (err = sm90::map_mn_major(&h_mn, h, hid, heads, n_rows, hh, 0, true)))
    return static_cast<int>(err);

  // 1. dpre_k = mask(h_k) (g_k @ Wout_k) per head, with the bias partials
  const DpreEpi dpre_epi{static_cast<const bf16*>(g), part_bin, part_bout,
                         n_rows, hid, f, heads};
  if ((err = sm90::launch<false>(
           g_k, wout_mn, sm90::Shape{n_rows, hid, f, f, heads, 1, 0, 0},
           dpre_epi, st, &h_tile, &dpre_tile)))
    return static_cast<int>(err);
  // 2. dx = bf16(dpre @ Win)
  if ((err = sm90::launch<false>(
           dpre_k, win_mn, sm90::Shape{n_rows, cat, hh, hh, 1, 1, 0, 0},
           Bf16Epi{static_cast<bf16*>(dx), n_rows, cat, cat}, st)))
    return static_cast<int>(err);
  // 3. split-K partials of dWin = dpre^T x and dWout_k = g_k^T h_k
  if ((err = sm90::launch<true>(
           dpre_mn, x_mn, sm90::Shape{hh, cat, n_rows, r_win, 1, s_win, 1, 1},
           PartEpi{part_win, hh, cat, 1}, st)) ||
      (err = sm90::launch<true>(
           g_mn, h_mn,
           sm90::Shape{f, hid, n_rows, r_wout, heads, s_wout, 1, 1},
           PartEpi{part_wout, f, hid, heads}, st)))
    return static_cast<int>(err);
  // 4. the four sums in order, rounded to bf16
  const ReduceJob w_in{part_win, s_win, static_cast<int64_t>(hh) * cat,
                       static_cast<bf16*>(dwin)};
  const ReduceJob w_out{part_wout, s_wout, static_cast<int64_t>(hf) * hid,
                        static_cast<bf16*>(dwout)};
  const ReduceJob b_in{part_bin, tiles, hh, static_cast<bf16*>(dbin)};
  const ReduceJob b_out{part_bout, tiles, hf, static_cast<bf16*>(dbout)};
  const int short_blocks =
      static_cast<int>((w_in.len + w_out.len + 255) / 256);
  const int long_blocks = static_cast<int>((16 * (b_in.len + b_out.len) +
                                            255) / 256);
  reduce_parts<<<short_blocks + long_blocks, 256, 0, st>>>(
      w_in, w_out, b_in, b_out, short_blocks);
  return static_cast<int>(cudaGetLastError());
}
