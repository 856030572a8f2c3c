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
// Design (namespace fwd below): one persistent launch of units planned on
// the host (fwd_plan in ops/kernels/hyper_apply.py), about one wave of the
// card's SMs, on the dh/dx kernel's mainloop (TMA into a ring of mbarrier
// stages, one producer thread, two consumer warpgroups on wgmma). A unit
// is a 128-row tile of B and a range of outputs. Per output o and
// 128-column tile of I it computes P_o = hidden K_o^T on wgmma, adds the
// bias c_o and rounds to bf16 as the TPU kernel does; the rounded P_o lies
// in registers as mma.sync's A fragments, so each warp multiplies its 16
// rows of it by its 16 rows of x on the tensor cores (f32 products and
// sums) and keeps the diagonal, the rows' sums. The bias tail
// P[:, O*I + o] of the unit's outputs is one more product, 8 outputs at a
// time (wgmma n8); each row's sum plus its tail, rounded once, is stored
// once. Rows past B are zero-filled and never stored, so B needs no
// padding.
//
// Backward, for the cotangent g (B, O), with dP[b, o*I + i] =
// bf16(g[b, o] * x[b, i]) and dP[b, O*I + o] = g[b, o]:
//
// * dh/dx, replacing _bwd_dhdx_kernel (launched by _fused_bwd):
//     dh = bf16(dP @ K)        dx[b, i] = bf16(sum_o bf16(g[b,o] * P[b, o*I+i]))
//   Bound: operations, 6.5 GFLOP at the flagship shape (P recomputed,
//   then dP @ K), ~6.6 us at 989 TFLOP/s, against 4.6 MB of input and
//   output, ~1.4 us at 3.35 TB/s. Design (namespace dhdx below): one
//   persistent launch of units planned on the host, about one wave of the
//   card's SMs, on the pieces of gemm_sm90.cuh (TMA into a ring of
//   mbarrier stages, one producer thread, two consumer warpgroups on
//   wgmma): a dx unit (128 rows, 128 columns of I, a range of outputs)
//   computes P_o = hidden K_o^T per output on the mainloop and adds
//   bf16(g[:, o] * bf16(P_o + c_o)) into f32 registers; a dh unit (128
//   rows, 128 columns of C, a range of outputs) adds dP_o K_o, its A
//   operand built in registers from x and g (wgmma's register-A form), and
//   the last group's unit adds g K_tail. o is the outer axis of K's tensor
//   maps, so a box stops at I. P and dP never reach device memory. Each
//   unit stores its f32 tile to its group's partial plane, and one reduce
//   launch adds the groups in order and rounds dh and dx to bf16: two
//   launches, no atomics.
// * dK, replacing _bwd_dk_kernel (launched by _fused_bwd):
//     dK[o*I + i, :] = bf16(sum_b dP[b, o*I + i] * hidden[b, :])
//     db[o*I + i] = sum_b dP[b, o*I + i]                      (f32)
//   Bound: operations, 3.2 GFLOP at the flagship shape, ~3.3 us at 989
//   TFLOP/s, against 4.6 MB of input and output, ~1.4 us. Design
//   (namespace dk below): the GEMM dK = dP^T hidden (M = O*I, N = C,
//   K = B) in one persistent launch on the pieces of gemm_sm90.cuh, about
//   one wave of the card's SMs. A tile is one output o, 128 columns of I
//   and 128 of C, so it needs one column of g; its k-blocks are TMA boxes
//   of x's, hidden's (wgmma's MN-major B) and g's rows, and each consumer
//   thread builds its fragment of dP^T = bf16(g x) in registers
//   (ldmatrix.trans of x, one bf16x2 multiply by g) for wgmma's register-A
//   form, adding the same values into db. dP never reaches device memory
//   (25 MB at the flagship shape). Each tile writes its dK tile once and
//   the first C tile's also db, so the sums are deterministic, with no
//   atomics and no partial planes.
// The bias-tail rows of dK and db (g^T hidden and sum g) are left to plain
// torch ops, as the JAX package computes them outside Pallas.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

// `bytes` contiguous bytes into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// ---- forward: one persistent launch built from gemm_sm90.cuh's pieces ----
namespace fwd {

using sm90::BK;
constexpr int TILE = 128;                   // rows of a unit; columns of I
constexpr int STAGES = 4;
constexpr int A_BYTES = sm90::A_BYTES;      // 128 rows x 64 of hidden
constexpr int B_BYTES = BK * TILE * 2;      // a box of K_o, 128 x 64
constexpr int TAIL_N = 8;                   // tail outputs of one product
constexpr int TAIL_BYTES = TAIL_N * BK * 2; // a box of K_tail, 8 x 64
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BIAS_BYTES = TILE * 2;        // c_o's columns of an I tile
constexpr int PER_MAX = 32;                 // outputs of a unit at most
constexpr int SUM_LD = PER_MAX + 1;         // a row of the unit's sums (f32)
constexpr int SMEM = 1024 + STAGES * (STAGE_BYTES + BIAS_BYTES) +
                     TILE * SUM_LD * 4 + 2 * STAGES * 8;

// The host's plan (fwd_plan in ops/kernels/hyper_apply.py): 128-row tiles
// of B, and the outputs o cut into `groups` groups of `per` outputs.
struct Plan {
  int n_rows, c_dim, in_ch, out_ch;
  int m_tiles, groups, per;
  __host__ __device__ int units() const { return m_tiles * groups; }
};

struct Unit {
  int m0, o_begin, o_end;   // first row; the outputs [o_begin, o_end)
};

// Unit u: the group runs fastest, then the row tile.
__device__ __forceinline__ Unit unit_at(const Plan& p, int u) {
  const int o_begin = (u % p.groups) * p.per;
  return Unit{(u / p.groups) * TILE, o_begin, min(p.out_ch, o_begin + p.per)};
}

// the pair of f32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b on one warp's tensor cores: a is a 16 x 16 bf16 fragment (rows
// lane / 4 and + 8, column pairs 2 (lane % 4) and + 8), b a 16 x 8 one (k
// pairs 2 (lane % 4) and + 8, column lane / 4), d f32 (rows lane / 4 and
// + 8, columns 2 (lane % 4) and + 1)
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Persistent: block b walks units b, b + gridDim.x, ... A producer thread
// keeps up to STAGES k-blocks in flight through TMA. A pass is one output o
// and one 128-column tile of I: its k-blocks are 64 columns of C, a box of
// hidden's rows and one of K_o's (both K-major; o is the outer axis of K's
// map, so a box stops at I), and with the last k-block the tile's values of
// the bias c_o (a bulk copy into the stage's bias slot). After the unit's
// outputs, a tail pass per 8 outputs: boxes of hidden's rows and of the 8
// rows of K_tail. The two consumer warpgroups each own 64 rows of the
// unit's 128-row tile:
// - P_o's tile = hidden K_o^T on wgmma (shared-memory A and B), then each
//   thread adds c_o and rounds to bf16 into mma.sync's A fragments, and
//   each warp adds P_w X_w^T (its 16 rows of P_o by its 16 rows of x, x's
//   pairs loaded once per unit and I tile as B fragments) into 16 x 16 f32
//   sums; after the last I tile their diagonal, the rows' sums, goes to
//   shared memory. The two warpgroups run side by side: one's products
//   (wgmma) overlap the other's epilogue (mma.sync and the rounding), and
//   neither waits for the other. A ring of 4 stages (two passes at
//   C = 128) leaves fewer loads waiting in L2's queues than 6, and measured
//   faster.
// - The tail pass: hidden K_tail^T on wgmma n8, plus c's tail, rounded to
//   bf16, added to the row's sum, rounded once and stored. Tail columns
//   past the unit's outputs are computed and not stored: every pass issues
//   all its products (a wgmma under a branch would be serialised).
// Columns past I read zeros from K_o's box, and their bias and x are taken
// as zeros, so the bias slot's stale bytes past I never reach a sum.
__global__ void __launch_bounds__(sm90::THREADS, 1)
kernel(const __grid_constant__ CUtensorMap t_hidden,
       const __grid_constant__ CUtensorMap t_kw,
       const __grid_constant__ CUtensorMap t_tail,
       const bf16* __restrict__ bias, const bf16* __restrict__ x,
       bf16* __restrict__ out, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned stages
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* bias_s = smem + STAGES * STAGE_BYTES;
  float* sums = reinterpret_cast<float*>(bias_s + STAGES * BIAS_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sums + TILE * SUM_LD);
  uint64_t* empty = full + STAGES;
  const int units = p.units();

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], sm90::CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // `it` counts k-blocks over all of this block's units: stage it % STAGES,
  // in its (it / STAGES)-th use
  if (wg == sm90::CONSUMERS) {
    if (threadIdx.x == sm90::CONSUMERS * 128) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_at(p, u);
        for (int o = t.o_begin; o < t.o_end; ++o) {
          for (int n0 = 0; n0 < p.in_ch; n0 += TILE) {
            const int bias_bytes = 2 * min(TILE, p.in_ch - n0);
            for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {
              const int st = it % STAGES;
              sm90::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
              unsigned char* a_s = smem + st * STAGE_BYTES;
              const bool last = k0 + BK >= p.c_dim;
              sm90::mbar_expect_tx(&full[st],
                                   STAGE_BYTES + (last ? bias_bytes : 0));
              sm90::tma_load(a_s, &t_hidden, &full[st], k0, 0, t.m0);
              sm90::tma_load(a_s + A_BYTES, &t_kw, &full[st], k0, n0, o);
              if (last)
                bulk_load(bias_s + st * BIAS_BYTES,
                          bias + size_t(o) * p.in_ch + n0, bias_bytes,
                          &full[st]);
            }
          }
        }
        for (int o0 = t.o_begin; o0 < t.o_end; o0 += TAIL_N) {
          for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {
            const int st = it % STAGES;
            sm90::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
            unsigned char* a_s = smem + st * STAGE_BYTES;
            sm90::mbar_expect_tx(&full[st], A_BYTES + TAIL_BYTES);
            sm90::tma_load(a_s, &t_hidden, &full[st], k0, 0, t.m0);
            sm90::tma_load(a_s + A_BYTES, &t_tail, &full[st], k0, o0, 0);
          }
        }
      }
    }
    return;
  }

  // consumers: the rows of d[0..1] and d[2..3] of thread (wg, thread)
  const int thread = threadIdx.x % 128, lane = thread % 32, q = lane % 4;
  const int row_in_tile = wg * 64 + (thread / 32) * 16 + lane / 4;
  // this thread's two rows of the unit's sums, 8 rows apart
  float* sum_row = sums + row_in_tile * SUM_LD;
  const size_t w_cols = size_t(p.out_ch) * p.in_ch;
  uint32_t xv[2][16] = {};   // x's pairs: rows r0, r1, columns 8 j + 2 q
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_at(p, u);
    const int r0 = t.m0 + row_in_tile, r1 = r0 + 8;
    const bool v0 = r0 < p.n_rows, v1 = r1 < p.n_rows;
    for (int o = t.o_begin; o < t.o_end; ++o) {
      // the warp's 16 x 16 products of its rows of P_o with its rows of x:
      // d0 holds rows r0 by x's rows 16 warp + (0..7), d1 rows r1 by 16
      // warp + 8 + (0..7); the row sums are on the diagonal
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n0 = 0; n0 < p.in_ch; n0 += TILE) {
        const int live = p.in_ch - n0;   // columns of this I tile in I
        if (o == t.o_begin || p.in_ch > TILE) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = n0 + j * 8 + 2 * q;
            const bool in = j * 8 < live;
            xv[0][j] = v0 && in ? *reinterpret_cast<const uint32_t*>(
                                      x + size_t(r0) * p.in_ch + col)
                                : 0u;
            xv[1][j] = v1 && in ? *reinterpret_cast<const uint32_t*>(
                                      x + size_t(r1) * p.in_ch + col)
                                : 0u;
          }
        }
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(&full[st], (it / STAGES) & 1);
          const uint32_t a_addr =
              sm90::smem_u32(smem + st * STAGE_BYTES) + wg * sm90::HALF;
          const uint32_t b_addr =
              sm90::smem_u32(smem + st * STAGE_BYTES + A_BYTES);
          sm90::fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            sm90::wgmma_m64n128k16<0, 0>(
                acc, sm90::smem_desc(a_addr + kk * 32, 16, 1024),
                sm90::smem_desc(b_addr + kk * 32, 16, 1024));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          sm90::fence_acc(acc);
          // keep this stage's products in flight; the previous one is done
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (k0 > 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        sm90::fence_acc(acc);
        // bf16(P_o + c_o), c_o from the last stage's bias slot (released
        // after), is in the register layout of mma's A: per 16 columns,
        // one fragment, multiplied by x's pairs at the thread's two rows
        // (mma's B fragments). Past I the slot holds stale bytes, so the
        // bias there is taken as zero (and x is zero).
        const int st = (it - 1) % STAGES;
        const __nv_bfloat162* c =
            reinterpret_cast<const __nv_bfloat162*>(bias_s + st * BIAS_BYTES);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          const int j = 2 * kk;     // the 8-column groups j and j + 1
          const bool in = kk * 16 < live;
          const float2 c0 = in ? __bfloat1622float2(c[j * 4 + q])
                               : make_float2(0.f, 0.f);
          const float2 c1 = in ? __bfloat1622float2(c[j * 4 + 4 + q])
                               : make_float2(0.f, 0.f);
          const uint32_t a[4] = {
              pack_rn(acc[j * 4] + c0.x, acc[j * 4 + 1] + c0.y),
              pack_rn(acc[j * 4 + 2] + c0.x, acc[j * 4 + 3] + c0.y),
              pack_rn(acc[j * 4 + 4] + c1.x, acc[j * 4 + 5] + c1.y),
              pack_rn(acc[j * 4 + 6] + c1.x, acc[j * 4 + 7] + c1.y)};
          mma_m16n8k16(d0, a, xv[0][j], xv[0][j + 1]);
          mma_m16n8k16(d1, a, xv[1][j], xv[1][j + 1]);
        }
        sm90::mbar_arrive(&empty[st]);
      }
      // row r0's sum is d0's entry at x's row r0: column lane / 4 of d0,
      // held by the thread with q = lane / 8; r1's likewise in d1
      if (q == lane / 8) {
        const bool odd = (lane / 4) & 1;
        sum_row[o - t.o_begin] = odd ? d0[1] : d0[0];
        sum_row[8 * SUM_LD + o - t.o_begin] = odd ? d1[3] : d1[2];
      }
    }
    __syncwarp();   // a row's sums are read by all of its quad
    for (int o0 = t.o_begin; o0 < t.o_end; o0 += TAIL_N) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(&full[st], (it / STAGES) & 1);
        const uint32_t a_addr =
            sm90::smem_u32(smem + st * STAGE_BYTES) + wg * sm90::HALF;
        const uint32_t b_addr =
            sm90::smem_u32(smem + st * STAGE_BYTES + A_BYTES);
        sm90::fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          sm90::wgmma_m64n8k16<0, 0>(
              acc, sm90::smem_desc(a_addr + kk * 32, 16, 1024),
              sm90::smem_desc(b_addr + kk * 32, 16, 1024));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        sm90::fence_acc(acc);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (k0 > 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      sm90::fence_acc(acc);
      sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
      // out = bf16(sum + bf16(P_tail + c_tail)) for outputs o0 + 2q (+ 1)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + 2 * q + e;
        if (o >= t.o_end) continue;
        const float c = __bfloat162float(bias[w_cols + o]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = h ? r1 : r0;
          const float tail =
              __bfloat162float(__float2bfloat16(acc[2 * h + e] + c));
          if (row < p.n_rows)
            out[size_t(row) * p.out_ch + o] = __float2bfloat16(
                sum_row[h * 8 * SUM_LD + o - t.o_begin] + tail);
        }
      }
    }
    __syncwarp();   // the next unit's sums overwrite these
  }
}

}  // namespace fwd

// ---- dh/dx: one persistent launch built from gemm_sm90.cuh's pieces ------
namespace dhdx {

using sm90::BK;
constexpr int TILE = 128;                   // rows and columns of a unit's tile
constexpr int STAGES = 6;
constexpr int A_BYTES = sm90::A_BYTES;      // 128 rows x 64 of hidden, x or g
constexpr int B_BYTES = BK * TILE * 2;      // a box of K, 64 x 128
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BIAS_BYTES = TILE * 2;        // c_o's columns of a dx tile
constexpr int SMEM =
    1024 + STAGES * (STAGE_BYTES + BIAS_BYTES) + 2 * STAGES * 8;

// The host's plan (bwd_plan in ops/kernels/hyper_apply.py): 128-row tiles
// of B, 128-column tiles of I (dx) and of C (dh), and the outputs o cut
// into `groups` groups of `per` outputs.
struct Plan {
  int n_rows, c_dim, in_ch, out_ch;
  int m_tiles, x_tiles, h_tiles;
  int groups, per;
  __host__ __device__ int x_units() const {
    return m_tiles * x_tiles * groups;
  }
  __host__ __device__ int units() const {
    return m_tiles * (x_tiles + h_tiles) * groups;
  }
};

struct Unit {
  bool dh;            // a dh unit, else a dx unit
  int m0, n0;         // first row; first column of I (dx) or of C (dh)
  int group, o_begin, o_end;
  bool tail;          // the last group's dh unit also adds g K_tail
};

// Unit u: the dx units first, then the dh units; within a kind the group
// runs fastest, then the column tile, then the row tile.
__device__ __forceinline__ Unit unit_at(const Plan& p, int u) {
  const bool dh = u >= p.x_units();
  if (dh) u -= p.x_units();
  const int cols = dh ? p.h_tiles : p.x_tiles;
  const int group = u % p.groups, rest = u / p.groups;
  const int o_begin = group * p.per;
  return Unit{dh, (rest / cols) * TILE, (rest % cols) * TILE, group, o_begin,
              min(p.out_ch, o_begin + p.per), dh && group == p.groups - 1};
}

// each bf16 of the pair v times s, rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float s) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const __nv_bfloat162 r = __floats2bfloat162_rn(f.x * s, f.y * s);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// a named barrier of the two consumer warpgroups: wait for the other's
// arrival, or arrive without waiting
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Persistent: block b walks units b, b + gridDim.x, ... A producer thread
// keeps up to STAGES k-blocks in flight through TMA. Per output o, a dx
// unit's k-blocks are 64 columns of C: a box of hidden's rows and one of
// K_o's (both K-major), and with the last k-block the tile's 128 values of
// the bias c_o (a bulk copy into the stage's bias slot). A dh unit's are
// 64 rows of K_o (two boxes of 64 columns of its C tile: an MN-major B)
// and the same 64 columns of x's rows (a box in the stage's A slot); after
// its last output the tail unit's k-blocks are 64 rows of K_tail and 64
// columns of g. The two consumer warpgroups each own 64 rows of the unit's
// 128-row tile and keep its f32 sum in registers:
// - dx: P_o's tile = hidden K_o^T on wgmma (shared-memory A and B), then
//   sum += bf16(g[:, o] * bf16(P_o + c_o)) in the registers it lies in.
//   Where a turn's k-blocks fit the ring (C <= STAGES * 64), the
//   warpgroups take turns (two named barriers): one's products run while
//   the other's epilogue does, so the tensor cores do not wait for the
//   epilogue. (A turn longer than the ring would wait for stages that only
//   the other warpgroup's turn frees.)
// - dh: sum += dP_o K_o with A from registers: each thread reads its pairs
//   of x from the stage and builds its fragment of dP_o = bf16(g[:, o] x)
//   with g's values at its two rows (loaded one output ahead); the tail's
//   A is g's box itself. Columns past I (or O) are zeros in both boxes
//   (TMA's fill), so every k-block issues all its products: a wgmma under
//   a branch would be serialised.
// The unit ends by storing its tile to its group's f32 partial plane.
__global__ void __launch_bounds__(sm90::THREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap t_hidden,
           const __grid_constant__ CUtensorMap t_kw,
           const __grid_constant__ CUtensorMap t_x,
           const __grid_constant__ CUtensorMap t_kmn,
           const __grid_constant__ CUtensorMap t_g,
           const __grid_constant__ CUtensorMap t_tail,
           const bf16* __restrict__ bias, const bf16* __restrict__ g,
           float* __restrict__ part_dx, float* __restrict__ part_dh,
           const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned stages
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* bias_s = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + STAGES * BIAS_BYTES);
  uint64_t* empty = full + STAGES;
  const int units = p.units();

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], sm90::CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // `it` counts k-blocks over all of this block's units: stage it % STAGES,
  // in its (it / STAGES)-th use
  if (wg == sm90::CONSUMERS) {
    if (threadIdx.x == sm90::CONSUMERS * 128) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_at(p, u);
        const int bias_bytes = 2 * min(TILE, p.in_ch - t.n0);
        for (int o = t.o_begin; o < t.o_end + (t.tail ? 1 : 0); ++o) {
          const bool tail = o == t.o_end;
          const int len = tail ? p.out_ch : t.dh ? p.in_ch : p.c_dim;
          for (int k0 = 0; k0 < len; k0 += BK, ++it) {
            const int st = it % STAGES;
            sm90::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
            unsigned char* a_s = smem + st * STAGE_BYTES;
            unsigned char* b_s = a_s + A_BYTES;
            if (!t.dh) {
              const bool last = k0 + BK >= len;
              sm90::mbar_expect_tx(&full[st],
                                   STAGE_BYTES + (last ? bias_bytes : 0));
              sm90::tma_load(a_s, &t_hidden, &full[st], k0, 0, t.m0);
              sm90::tma_load(b_s, &t_kw, &full[st], k0, t.n0, o);
              if (last)
                bulk_load(bias_s + st * BIAS_BYTES,
                          bias + size_t(o) * p.in_ch + t.n0, bias_bytes,
                          &full[st]);
            } else {
              const CUtensorMap* map = tail ? &t_tail : &t_kmn;
              const int z = tail ? 0 : o;
              sm90::mbar_expect_tx(&full[st], STAGE_BYTES);
              sm90::tma_load(a_s, tail ? &t_g : &t_x, &full[st], k0, 0, t.m0);
              sm90::tma_load(b_s, map, &full[st], t.n0, k0, z);
              sm90::tma_load(b_s + sm90::HALF, map, &full[st], t.n0 + 64, k0,
                             z);
            }
          }
        }
      }
    }
    return;
  }

  // consumers: the rows of d[0..1] and d[2..3] of thread (wg, thread)
  const int thread = threadIdx.x % 128, lane = thread % 32, q = lane % 4;
  const int row_in_tile = wg * 64 + (thread / 32) * 16 + lane / 4;
  // this thread's pairs of a 128-row A box (64 columns, 128-byte swizzle):
  // row row_in_tile (+ 8 for the second row), columns 16 kk + 2q (+ 8)
  const int a_off = row_in_tile * 128 + 4 * q;
  const int swz = lane / 4;                 // row_in_tile % 8
  // dx turns: warpgroup w waits on barrier 2 + w and arrives on the
  // other's; warpgroup 1's first arrival lets warpgroup 0 go first
  const bool turns = p.c_dim <= STAGES * BK;
  const int mine = 2 + wg, other = 3 - wg;
  if (turns && wg == 1) named_arrive(2);
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_at(p, u);
    const int r0 = t.m0 + row_in_tile, r1 = r0 + 8;
    const bool v0 = r0 < p.n_rows, v1 = r1 < p.n_rows;
    const bf16 zero = __float2bfloat16(0.f);
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    if (!t.dh) {
      for (int o = t.o_begin; o < t.o_end; ++o) {
        const bf16 g0 = v0 ? g[size_t(r0) * p.out_ch + o] : zero;
        const bf16 g1 = v1 ? g[size_t(r1) * p.out_ch + o] : zero;
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        if (turns) named_sync(mine);   // the other's products are done
        for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(&full[st], (it / STAGES) & 1);
          const uint32_t a_addr =
              sm90::smem_u32(smem + st * STAGE_BYTES) + wg * sm90::HALF;
          const uint32_t b_addr =
              sm90::smem_u32(smem + st * STAGE_BYTES + A_BYTES);
          sm90::fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            sm90::wgmma_m64n128k16<0, 0>(
                acc, sm90::smem_desc(a_addr + kk * 32, 16, 1024),
                sm90::smem_desc(b_addr + kk * 32, 16, 1024));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          sm90::fence_acc(acc);
          // keep this stage's products in flight; the previous one is done
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (k0 > 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        sm90::fence_acc(acc);
        if (turns) named_arrive(other);
        // dx += bf16(g[:, o] * bf16(P_o + c_o)), c_o from the last stage's
        // bias slot, which is released after; the slot's columns past I
        // hold stale values, but those columns are never stored
        const int st = (it - 1) % STAGES;
        const __nv_bfloat162* c =
            reinterpret_cast<const __nv_bfloat162*>(bias_s + st * BIAS_BYTES);
        const __nv_bfloat162 gg0 = __halves2bfloat162(g0, g0);
        const __nv_bfloat162 gg1 = __halves2bfloat162(g1, g1);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 cv = __bfloat1622float2(c[j * 4 + q]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = j * 4 + h * 2;
            const __nv_bfloat162 pv =
                __floats2bfloat162_rn(acc[i] + cv.x, acc[i + 1] + cv.y);
            const float2 tv = __bfloat1622float2(__hmul2(h ? gg1 : gg0, pv));
            sum[i] += tv.x;
            sum[i + 1] += tv.y;
          }
        }
        sm90::mbar_arrive(&empty[st]);
      }
    } else {
      // the scales of this output's rows: g[:, o], then 1 for the tail
      float s0 = v0 ? __bfloat162float(g[size_t(r0) * p.out_ch + t.o_begin])
                    : 0.f;
      float s1 = v1 ? __bfloat162float(g[size_t(r1) * p.out_ch + t.o_begin])
                    : 0.f;
      for (int o = t.o_begin; o < t.o_end + (t.tail ? 1 : 0); ++o) {
        const bool more = o + 1 < t.o_end;
        const bf16* g_next = g + o + 1;
        const float next0 =
            !more ? 1.f
            : v0  ? __bfloat162float(g_next[size_t(r0) * p.out_ch])
                  : 0.f;
        const float next1 =
            !more ? 1.f
            : v1  ? __bfloat162float(g_next[size_t(r1) * p.out_ch])
                  : 0.f;
        const int len = o == t.o_end ? p.out_ch : p.in_ch;
        for (int k0 = 0; k0 < len; k0 += BK, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(&full[st], (it / STAGES) & 1);
          const unsigned char* a_s = smem + st * STAGE_BYTES + a_off;
          uint32_t a[BK / 16][4];
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const int lo = ((2 * kk) ^ swz) * 16;
            const int hi = ((2 * kk + 1) ^ swz) * 16;
            auto pair = [&](int off) {
              return *reinterpret_cast<const uint32_t*>(a_s + off);
            };
            a[kk][0] = scale_pair(pair(lo), s0);
            a[kk][1] = scale_pair(pair(8 * 128 + lo), s1);
            a[kk][2] = scale_pair(pair(hi), s0);
            a[kk][3] = scale_pair(pair(8 * 128 + hi), s1);
          }
          const uint32_t b_addr =
              sm90::smem_u32(smem + st * STAGE_BYTES + A_BYTES);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) sm90::fence_frag(a[kk]);
          sm90::fence_acc(sum);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          // an MN-major B advances 16 lines of 128 bytes a step; LBO: the
          // box of the tile's next 64 columns
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            sm90::wgmma_m64n128k16_rs<1>(
                sum, a[kk],
                sm90::smem_desc(b_addr + kk * 2048, sm90::HALF, 1024));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the fragments are rebuilt for the next k-block: wait for all
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          sm90::fence_acc(sum);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) sm90::fence_frag(a[kk]);
          sm90::mbar_arrive(&empty[st]);
        }
        s0 = next0;
        s1 = next1;
      }
    }
    // the unit's tile into its group's f32 partial plane; rows past B and
    // columns past the width are not stored
    const int width = t.dh ? p.c_dim : p.in_ch;
    float* out = (t.dh ? part_dh : part_dx) +
                 size_t(t.group) * p.n_rows * width;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.n0 + j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? r1 : r0;
        if (row < p.n_rows && col < width)
          *reinterpret_cast<float2*>(out + size_t(row) * width + col) =
              make_float2(sum[j * 4 + h * 2], sum[j * 4 + h * 2 + 1]);
      }
    }
  }
  // warpgroup 1's last arrival
  if (turns && wg == 0) named_sync(2);
}

// dh = bf16(sum of part_dh's planes), dx likewise, the groups in order, in
// one launch: thread i < n_dh takes 4 columns of dh, the rest 4 of dx
// (n_dh, n_dx: element counts / 4)
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part_dh,
              const float* __restrict__ part_dx, int groups, int64_t n_dh,
              int64_t n_dx, bf16* __restrict__ dh, bf16* __restrict__ dx) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool first = i < n_dh;
  if (!first) i -= n_dh;
  const int64_t len = first ? n_dh : n_dx;
  if (i >= len) return;
  const float4* part =
      reinterpret_cast<const float4*>(first ? part_dh : part_dx);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int gi = 0; gi < groups; ++gi) {
    const float4 v = part[gi * len + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  *reinterpret_cast<uint2*>((first ? dh : dx) + i * 4) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

}  // namespace dhdx

// ---- dK: one persistent launch built from gemm_sm90.cuh's pieces --------
namespace dk {

using sm90::BK;
using sm90::HALF;
constexpr int TILE = 128;                    // rows (of I) and columns (of C)
constexpr int STAGES = 6;
constexpr int X_BYTES = BK * TILE * 2;       // 64 rows of x, 128 columns
constexpr int H_BYTES = BK * TILE * 2;       // 64 rows of hidden, 128 columns
constexpr int G_COLS = 8;                    // outputs in a 16-byte box line
constexpr int G_BYTES = BK * G_COLS * 2;     // 64 rows of g, 8 columns
constexpr int STAGE_BYTES = X_BYTES + H_BYTES + G_BYTES;  // 1024-multiple
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

struct Shape {
  int n_rows, c_dim, in_ch, out_ch;
  int x_tiles, c_tiles;     // 128-column tiles of I and of C
  __host__ __device__ int tiles() const { return out_ch * x_tiles * c_tiles; }
};

struct Tile {
  int o, i0, n0;            // the output; first column of I and of C
};

// Tile t: the C tile runs fastest, then the I tile, then the output.
__device__ __forceinline__ Tile tile_at(const Shape& s, int t) {
  const int rest = t / s.c_tiles;
  return Tile{rest / s.x_tiles, (rest % s.x_tiles) * TILE,
              (t % s.c_tiles) * TILE};
}

// four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8 (8 consecutive elements) and
// receives in r[j] the elements (2 (l % 4), l / 4) and (2 (l % 4) + 1,
// l / 4) of matrix j, the first in the low half
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the bf16 pair v times the pair s, each rounded once to bf16
__device__ __forceinline__ uint32_t mul_pair(uint32_t v, __nv_bfloat162 s) {
  const __nv_bfloat162 r =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&v), s);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the sum of a bf16 pair in f32 (a bf16 is the top half of its f32)
__device__ __forceinline__ float pair_sum(uint32_t v) {
  return __uint_as_float(v << 16) + __uint_as_float(v & 0xffff0000u);
}

// g[b, o] and g[b + 1, o] as a pair, from the shared address of g[b, o] in
// a stage's g box (rows 16 bytes apart)
__device__ __forceinline__ __nv_bfloat162 g_pair(uint32_t addr) {
  uint32_t v;
  asm volatile(
      "{\n.reg .b16 l, h;\nld.shared.b16 l, [%1];\n"
      "ld.shared.b16 h, [%1+16];\nmov.b32 %0, {l, h};\n}\n"
      : "=r"(v)
      : "r"(addr));
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// Persistent: block b walks tiles b, b + gridDim.x, ... A producer thread
// keeps up to STAGES k-blocks (64 batch rows each) in flight through TMA:
// x's rows at the tile's 128 columns of I (two 64-column boxes, MN-major),
// hidden's at its 128 columns of C (two boxes: wgmma's MN-major B), and a
// box of g's rows at the 8 outputs around o (16 bytes a row, unswizzled).
// Rows past B, columns past I or C, read zeros.
// The two consumer warpgroups each own 64 rows (i) of the tile. Once a
// stage has arrived, each thread loads its fragments of x^T for the stage's
// four 16-row steps (one ldmatrix.trans each: a register pair is x[b, i]
// and x[b + 1, i]) and the pairs (g[b, o], g[b + 1, o]) they take. Per
// step it multiplies them into dP^T = bf16(g x) and hands that to wgmma
// as its register A; every step is its own commit group and three stay
// in flight: a fragment is rebuilt once the product that read it, four
// groups back, is done. The thread adds its fragment values to its two
// rows' db in f32; a shuffle in the quad adds the row's four threads.
__global__ void __launch_bounds__(sm90::THREADS, 1)
kernel(const __grid_constant__ CUtensorMap t_x,
       const __grid_constant__ CUtensorMap t_hidden,
       const __grid_constant__ CUtensorMap t_g, bf16* __restrict__ dk_w,
       float* __restrict__ db_w, const Shape s) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned stages
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tiles = s.tiles();

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], sm90::CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // `it` counts k-blocks over all of this block's tiles: stage it % STAGES,
  // in its (it / STAGES)-th use
  if (wg == sm90::CONSUMERS) {
    if (threadIdx.x == sm90::CONSUMERS * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(s, t);
        for (int k0 = 0; k0 < s.n_rows; k0 += BK, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          unsigned char* x_s = smem + st * STAGE_BYTES;
          unsigned char* h_s = x_s + X_BYTES;
          sm90::mbar_expect_tx(&full[st], STAGE_BYTES);
          sm90::tma_load(x_s, &t_x, &full[st], tl.i0, k0, 0);
          sm90::tma_load(x_s + HALF, &t_x, &full[st], tl.i0 + 64, k0, 0);
          sm90::tma_load(h_s, &t_hidden, &full[st], tl.n0, k0, 0);
          sm90::tma_load(h_s + HALF, &t_hidden, &full[st], tl.n0 + 64, k0,
                         0);
          sm90::tma_load(h_s + H_BYTES, &t_g, &full[st],
                         tl.o / G_COLS * G_COLS, k0, 0);
        }
      }
    }
    return;
  }

  // consumers: rows r and r + 8 of the tile are those of d[0..1], d[2..3]
  const int thread = threadIdx.x % 128, warp = thread / 32, lane = thread % 32;
  const int q = lane % 4;
  const int r = wg * 64 + warp * 16 + lane / 4;
  // ldmatrix: lane l addresses matrix j = l / 8, row l % 8: batch row
  // 8 (j / 2) + l % 8 of the k-step, columns 16 warp + 8 (j % 2) + (0..7)
  // of the warpgroup's x box, in its 128-byte swizzle
  const int j = lane / 8, jr = lane % 8;
  const uint32_t x_lane = wg * HALF + (8 * (j / 2) + jr) * 128 +
                          (((2 * warp + j % 2) ^ jr) << 4);
  uint32_t a[BK / 16][4] = {};
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_at(s, t);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float db0 = 0.f, db1 = 0.f;
    sm90::fence_acc(acc);
    for (int k0 = 0; k0 < s.n_rows; k0 += BK, ++it) {
      const int st = it % STAGES;
      sm90::mbar_wait(&full[st], (it / STAGES) & 1);
      unsigned char* stage = smem + st * STAGE_BYTES;
      const uint32_t x_addr = sm90::smem_u32(stage) + x_lane;
      const uint32_t h_addr = sm90::smem_u32(stage + X_BYTES);
      // g[b, o] of the stage's first row; its 16-row step kk, rows
      // 16 kk + 2q (+ 1) and 16 kk + 8 + 2q (+ 1), lies (16 kk + 2q) * 16
      // and 128 bytes further
      const uint32_t g_addr = sm90::smem_u32(stage + X_BYTES + H_BYTES) +
                              (tl.o % G_COLS) * 2 + q * 32;
      uint32_t xs[BK / 16][4];
      __nv_bfloat162 gs[BK / 16][2];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // a 16-row step of a 64-row box advances 16 lines of 128 bytes
        ldmatrix_x4_trans(xs[kk], x_addr + kk * 2048);
        gs[kk][0] = g_pair(g_addr + kk * 256);
        gs[kk][1] = g_pair(g_addr + kk * 256 + 128);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // the product that read a[kk], four groups back, is done; at kk = 3
        // so are all of the previous k-block's: its stage is free
        asm volatile("wgmma.wait_group.sync.aligned 3;\n" ::: "memory");
        sm90::fence_frag(a[kk]);
        if (kk == BK / 16 - 1 && k0 > 0)
          sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
        a[kk][0] = mul_pair(xs[kk][0], gs[kk][0]);
        a[kk][1] = mul_pair(xs[kk][1], gs[kk][0]);
        a[kk][2] = mul_pair(xs[kk][2], gs[kk][1]);
        a[kk][3] = mul_pair(xs[kk][3], gs[kk][1]);
        db0 += pair_sum(a[kk][0]) + pair_sum(a[kk][2]);
        db1 += pair_sum(a[kk][1]) + pair_sum(a[kk][3]);
        sm90::fence_frag(a[kk]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        // LBO: the box of the tile's next 64 columns of C
        sm90::wgmma_m64n128k16_rs<1>(
            acc, a[kk], sm90::smem_desc(h_addr + kk * 2048, HALF, 1024));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    sm90::fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) sm90::fence_frag(a[kk]);
    sm90::mbar_arrive(&empty[(it - 1) % STAGES]);

    // db of rows r and r + 8: the quad's four partial sums, in a fixed order
    db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
    db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
    db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
    db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
    const int i_row = tl.i0 + r;
    const size_t f0 = static_cast<size_t>(tl.o) * s.in_ch;
    if (tl.n0 == 0 && q == 0) {
      if (i_row < s.in_ch) db_w[f0 + i_row] = db0;
      if (i_row + 8 < s.in_ch) db_w[f0 + i_row + 8] = db1;
    }
    // dK rows f0 + i_row (+ 8), bf16. The 4 lanes of a quad hold a row's
    // columns in pairs (8 columns apart from one fragment to the next); per
    // 4 fragments they transpose their 4 x 4 pairs by shuffles, so that
    // each lane stores 8 consecutive columns in one 16-byte store. Rows
    // past I and columns past C are not stored.
#pragma unroll
    for (int gq = 0; gq < 4; ++gq) {   // fragments 4 gq .. 4 gq + 3
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t w[4];   // w[jj]: columns (4 gq + jj) * 8 + 2q, + 1
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = 4 * gq + jj;
          const __nv_bfloat162 p = __floats2bfloat162_rn(
              acc[i * 4 + half * 2], acc[i * 4 + half * 2 + 1]);
          w[jj] = *reinterpret_cast<const uint32_t*>(&p);
        }
        // transpose in 2 x 2 blocks (lanes q, q ^ 1), then across them
        // (q, q ^ 2): w[jj] becomes columns (4 gq + q) * 8 + 2 jj, + 1
#pragma unroll
        for (int k = 0; k < 4; k += 2) {
          const uint32_t v =
              __shfl_xor_sync(0xffffffffu, (q & 1) ? w[k] : w[k + 1], 1);
          if (q & 1) w[k] = v; else w[k + 1] = v;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const uint32_t v =
              __shfl_xor_sync(0xffffffffu, (q & 2) ? w[k] : w[k + 2], 2);
          if (q & 2) w[k] = v; else w[k + 2] = v;
        }
        const int row = i_row + half * 8;
        const int col = tl.n0 + (4 * gq + q) * 8;
        if (row < s.in_ch && col < s.c_dim)
          *reinterpret_cast<uint4*>(dk_w + (f0 + row) * s.c_dim + col) =
              make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

}  // namespace dk

}  // namespace

// hidden: (n_rows, c_dim); k: (out_ch*in_ch + out_ch, c_dim) (torch Linear
// layout); bias: (out_ch*in_ch + out_ch,); x: (n_rows, in_ch);
// out: (n_rows, out_ch). All bf16, C-contiguous, 32-byte aligned; c_dim,
// in_ch and out_ch multiples of 16. The plan (fwd_plan in
// ops/kernels/hyper_apply.py) cuts the outputs into `groups` groups of
// `per` (at most fwd::PER_MAX); one whose groups do not cover the outputs
// exactly is refused. One launch.
CGAT_EXPORT int cgat_hyper_apply_fwd(const void* hidden, const void* k,
                                     const void* bias, const void* x,
                                     void* out, int n_rows, int c_dim,
                                     int in_ch, int out_ch, int groups,
                                     int per, void* stream) {
  if (n_rows <= 0) return 0;
  if (per < 1 || per > fwd::PER_MAX || groups != (out_ch + per - 1) / per)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t head = static_cast<uint64_t>(in_ch) * c_dim;  // K_o
  const bf16* k_tail = static_cast<const bf16*>(k) + out_ch * head;
  cudaError_t err;
  CUtensorMap t_hidden, t_kw, t_tail;
  if ((err = sm90::map_k_major(&t_hidden, hidden, c_dim, 1, n_rows, c_dim)) ||
      (err = sm90::map_k_major_b(&t_kw, k, c_dim, in_ch, c_dim, out_ch,
                                 head)) ||
      (err = sm90::make_map(&t_tail, k_tail, c_dim, out_ch, c_dim * 2, 1,
                            static_cast<uint64_t>(out_ch) * c_dim * 2,
                            fwd::TAIL_N, 1)))
    return static_cast<int>(err);
  static int per_device[sm90::MAX_DEVICES] = {};
  int sms = 0;
  if ((err = sm90::prepare(fwd::kernel, fwd::SMEM, per_device, &sms)))
    return static_cast<int>(err);
  const fwd::Plan p{n_rows, c_dim, in_ch, out_ch,
                    (n_rows + fwd::TILE - 1) / fwd::TILE, groups, per};
  const int units = p.units();
  fwd::kernel<<<units < sms ? units : sms, sm90::THREADS, fwd::SMEM,
                static_cast<cudaStream_t>(stream)>>>(
      t_hidden, t_kw, t_tail, static_cast<const bf16*>(bias),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// Same inputs as the forward plus g: (n_rows, out_ch). Outputs dh (n_rows,
// c_dim) and dx (n_rows, in_ch), bf16. The plan (bwd_plan in
// ops/kernels/hyper_apply.py) cuts the outputs into `groups` groups of
// `per`; one whose groups do not cover the outputs exactly is refused.
// Scratch: part_dx (groups, n_rows, in_ch) and part_dh (groups, n_rows,
// c_dim) f32. Two launches: the units, then the reduce. Takes every width
// the forward takes.
CGAT_EXPORT int cgat_hyper_apply_bwd_dhdx(
    const void* hidden, const void* k, const void* bias, const void* x,
    const void* g, int n_rows, int c_dim, int in_ch, int out_ch, int groups,
    int per, float* part_dx, float* part_dh, void* dh, void* dx,
    void* stream) {
  if (n_rows <= 0) return 0;
  if (per < 1 || groups != (out_ch + per - 1) / per)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t head = static_cast<uint64_t>(in_ch) * c_dim;  // K_o
  const bf16* k_tail = static_cast<const bf16*>(k) + out_ch * head;
  cudaError_t err;
  CUtensorMap t_hidden, t_kw, t_x, t_kmn, t_g, t_tail;
  if ((err = sm90::map_k_major(&t_hidden, hidden, c_dim, 1, n_rows, c_dim)) ||
      (err = sm90::map_k_major_b(&t_kw, k, c_dim, in_ch, c_dim, out_ch,
                                 head)) ||
      (err = sm90::map_k_major(&t_x, x, in_ch, 1, n_rows, in_ch)) ||
      (err = sm90::map_k_major(&t_g, g, out_ch, 1, n_rows, out_ch)) ||
      (err = sm90::map_mn_major(&t_kmn, k, c_dim, out_ch, in_ch, c_dim, head,
                                false)) ||
      (err = sm90::map_mn_major(&t_tail, k_tail, c_dim, 1, out_ch, c_dim,
                                static_cast<uint64_t>(out_ch) * c_dim,
                                false)))
    return static_cast<int>(err);
  static int per_device[sm90::MAX_DEVICES] = {};
  int sms = 0;
  if ((err = sm90::prepare(dhdx::bwd_kernel, dhdx::SMEM, per_device, &sms)))
    return static_cast<int>(err);
  const dhdx::Plan p{n_rows,
                     c_dim,
                     in_ch,
                     out_ch,
                     (n_rows + dhdx::TILE - 1) / dhdx::TILE,
                     (in_ch + dhdx::TILE - 1) / dhdx::TILE,
                     (c_dim + dhdx::TILE - 1) / dhdx::TILE,
                     groups,
                     per};
  const int units = p.units();
  dhdx::bwd_kernel<<<units < sms ? units : sms, sm90::THREADS, dhdx::SMEM,
                     st>>>(t_hidden, t_kw, t_x, t_kmn, t_g, t_tail,
                           static_cast<const bf16*>(bias),
                           static_cast<const bf16*>(g), part_dx, part_dh, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t n_dh = static_cast<int64_t>(n_rows) * c_dim / 4;
  const int64_t n_dx = static_cast<int64_t>(n_rows) * in_ch / 4;
  dhdx::reduce_kernel<<<static_cast<int>((n_dh + n_dx + 255) / 256), 256, 0,
                        st>>>(part_dh, part_dx, groups, n_dh, n_dx,
                              static_cast<bf16*>(dh),
                              static_cast<bf16*>(dx));
  return static_cast<int>(cudaGetLastError());
}

// hidden: (n_rows, c_dim); x: (n_rows, in_ch); g: (n_rows, out_ch), bf16.
// Outputs the weight rows of the last Linear's grads: dk_w (out_ch*in_ch,
// c_dim) bf16 and db_w (out_ch*in_ch,) f32. One persistent block per SM
// (at most one per tile) walks the out_ch x ceil(in_ch / 128) x
// ceil(c_dim / 128) tiles. One launch; takes every width the forward
// takes.
CGAT_EXPORT int cgat_hyper_apply_bwd_dk(const void* hidden, const void* x,
                                        const void* g, int n_rows, int c_dim,
                                        int in_ch, int out_ch, void* dk_w,
                                        float* db_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(out_ch) * in_ch;
  if (n_rows <= 0) {   // no batch row: both sums are empty
    const cudaError_t err = cudaMemsetAsync(dk_w, 0, rows * c_dim * 2, st);
    return static_cast<int>(err ? err
                                : cudaMemsetAsync(db_w, 0, rows * 4, st));
  }
  const dk::Shape s{n_rows, c_dim, in_ch, out_ch,
                    (in_ch + dk::TILE - 1) / dk::TILE,
                    (c_dim + dk::TILE - 1) / dk::TILE};
  const uint64_t n = n_rows;
  cudaError_t err;
  CUtensorMap t_x, t_hidden, t_g;
  if ((err = sm90::map_mn_major(&t_x, x, in_ch, 1, n, in_ch, n * in_ch,
                                false)) ||
      (err = sm90::map_mn_major(&t_hidden, hidden, c_dim, 1, n, c_dim,
                                n * c_dim, false)) ||
      (err = sm90::make_map(&t_g, g, out_ch, n, out_ch * 2, 1, n * out_ch * 2,
                            sm90::BK, 1, dk::G_COLS,
                            CU_TENSOR_MAP_SWIZZLE_NONE)))
    return static_cast<int>(err);
  static int per_device[sm90::MAX_DEVICES] = {};
  int sms = 0;
  if ((err = sm90::prepare(dk::kernel, dk::SMEM, per_device, &sms)))
    return static_cast<int>(err);
  const int tiles = s.tiles();
  dk::kernel<<<tiles < sms ? tiles : sms, sm90::THREADS, dk::SMEM, st>>>(
      t_x, t_hidden, t_g, static_cast<bf16*>(dk_w), db_w, s);
  return static_cast<int>(cudaGetLastError());
}
