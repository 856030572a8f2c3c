// Hopper GEMM mainloop shared by the port's kernels: TMA loads into a ring
// of shared-memory stages, one producer thread, two consumer warpgroups
// issuing wgmma (bf16 in, f32 accumulators in registers), and an epilogue
// functor that each consumer thread runs on its accumulator fragment.
//
// A block computes 128 x 128 output tiles, C[m0:m0+128, n0:n0+128] = sum
// over k of A[m, k] B[k, n] over the K range of the tile's split, one after
// another (one block per SM, persistent). Each consumer warpgroup owns 64
// rows (wgmma m64n128k16). A stage holds a
// 128 x 64 tile of A and a 64 x 128 tile of B (32 KB), both in the 128-byte
// swizzled layout that TMA writes and wgmma reads, so no thread copies or
// transposes anything:
//   - A is K-major (rows of A contiguous in K: one 64 x 128-row box) or
//     MN-major (A^T stored row-major: two 64-column boxes of 64 K rows);
//   - B is K-major (B^T stored row-major, as a Linear's weight is: one
//     64 x 128-row box, rows of one head) or MN-major (B stored as (K, N)
//     rows: two boxes of 64 N columns); wgmma takes an MN-major operand
//     through its transpose flag.
// Every operand is a rank-3 tensor map (line width, and two outer axes, one
// of them the head), so a box that runs past a head's edge, past E or past
// a width reads zeros (TMA's out-of-bounds fill): ragged M, N and K need no
// masked loads, and a head's K never reads the next head's columns.
//
// Tensor maps are encoded on the host per call (pointers change every
// step), through the driver's cuTensorMapEncodeTiled fetched with
// cudaGetDriverEntryPoint, so the library links no libcuda.
#pragma once

#include <cstdio>
#include <cuda.h>   // CUtensorMap and its enums; no driver library is linked

#include "common.cuh"

namespace sm90 {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int HALF = 64 * 128;               // one 64-line box of 128 bytes
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;
constexpr int TILE_BYTES = BM * BN * 2;      // a bf16 output tile
constexpr int TILE_BUFS = 2;                 // tile buffers (Epi::kTileIO)
constexpr int SCRATCH_FLOATS = 24 * 128;     // epilogue scratch

// shared memory of a block: the stages, two tile buffers if the epilogue
// reads and writes a bf16 tile through TMA (Epi::kTileIO), the barriers and
// the epilogue's scratch
template <class Epi>
constexpr int smem_bytes() {
  return 1024 + STAGES * STAGE_BYTES +
         (Epi::kTileIO ? TILE_BUFS * TILE_BYTES : 0) +
         (2 * STAGES + 2 * TILE_BUFS) * 8 + SCRATCH_FLOATS * 4;
}

// byte offset of element (r, c) of a 128 x 128 bf16 tile held as two boxes
// of 64 columns x 128 rows in TMA's 128-byte swizzle
__host__ __device__ constexpr int tile_offset(int r, int c) {
  return (c / 64) * (TILE_BYTES / 2) + r * 128 +
         (((c % 64) / 8) ^ (r % 8)) * 16 + (c % 8) * 2;
}

// what a consumer thread's epilogue needs to place its fragment: d[i] of
// thread (wg, thread) is row  m0 + wg*64 + (thread/32)*16 + (thread%32)/4
// + 8*((i%4)/2), column n0 + (i/4)*8 + (thread%4)*2 + i%2
struct Tile {
  int m0, n0, m_tile, z, split, wg, thread;
};

// per-launch shape: the output and K extent per head, the K range of a
// split, and where the head and K axes sit in the MN-major operands' maps
struct Shape {
  int m, n;             // output rows and columns (of one head)
  int k_len;            // K extent (of one head)
  int rows_per_split;   // K per split, a multiple of BK
  int heads, splits;
  int a_k_outer;        // MN-major A: K is axis 2 (head axis 1), else axis 1
  int b_k_outer;        // the same for B
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// shared memory box to coordinates (c0, c1, c2) of a rank-3 map (clipped
// at the tensor's edges), as one bulk group of the issuing thread
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// box at coordinates (c0, c1, c2) of a rank-3 map into shared memory,
// completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a 64-wide box of an MN-major operand: line offset mn, K row k, head z
__device__ __forceinline__ void tma_load_mn(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int mn, int k,
                                            int z, int k_outer) {
  if (k_outer)
    tma_load(dst, map, bar, mn, z, k);
  else
    tma_load(dst, map, bar, mn, k, z);
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16) B (16 x 128); TA: A is MN-major; TB: B is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A (64 x 16) B (16 x 8): a thread's d[0..1] and d[2..3] are rows
// 16 * (warp in the warpgroup) + lane / 4 and that + 8, columns 2 (lane % 4)
// and + 1; TA, TB as above
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A (64 x 16, from registers) B (16 x 128); TB: B is MN-major. A
// thread's a[0..3] hold A's bf16 pairs (row, col), (row + 8, col),
// (row, col + 8), (row + 8, col + 8), row = 16 * (warp in the warpgroup) +
// lane / 4 and col = 2 * (lane % 4): the rows of d[0..1] and d[2..3]. The
// registers are read while the product runs: keep them unchanged until
// wgmma.wait_group says it is done.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// keeps a register-A fragment where the in-flight product reads it
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

// a barrier of the two consumer warpgroups only (the producer has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// The output tiles, n fastest, then m, then head, then split: tile t has
// n tile t % n_tiles, m tile (t / n_tiles) % m_tiles, and so on.
__device__ __forceinline__ Tile tile_at(const Shape& s, int t, int wg,
                                        int thread) {
  const int n_tiles = (s.n + BN - 1) / BN, m_tiles = (s.m + BM - 1) / BM;
  const int rest = t / n_tiles;
  const int zz = rest / m_tiles;
  return Tile{(rest % m_tiles) * BM, (t % n_tiles) * BN, rest % m_tiles,
              zz % s.heads, zz / s.heads, wg, thread};
}

// Persistent: each block walks the tiles blockIdx.x, blockIdx.x + gridDim.x,
// ..., so the producer loads the next tile's stages while the consumers
// run this tile's epilogue. A tile of head z and split `split` sums K rows
// [split * rows_per_split, ...) and hands its accumulators to epi. With
// Epi::kTileIO the producer also loads the tile's box of tc (the epilogue's
// bf16 input, coordinates (n0, z, m0)) into one of two tile buffers after
// the tile's k-blocks; the epilogue overwrites it with its bf16 output,
// which one thread stores to the same box of td while the next tile's
// input arrives in the other buffer.
template <bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc,
            const __grid_constant__ CUtensorMap td, const Shape s,
            const Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned stages
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* tile_bufs = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      tile_bufs + (Epi::kTileIO ? TILE_BUFS * TILE_BYTES : 0));
  uint64_t* empty = full + STAGES;
  uint64_t* tile_full = empty + STAGES;
  uint64_t* tile_empty = tile_full + TILE_BUFS;
  float* scratch = reinterpret_cast<float*>(tile_empty + TILE_BUFS);
  const int tiles = ((s.n + BN - 1) / BN) * ((s.m + BM - 1) / BM) * s.heads *
                    s.splits;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS * 128);
    }
    for (int i = 0; i < TILE_BUFS; ++i) {
      mbar_init(&tile_full[i], 1);
      mbar_init(&tile_empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // `it` counts k-blocks over all of this block's tiles: stage it % STAGES,
  // in its (it / STAGES)-th use
  if (wg == CONSUMERS) {
    // producer: one thread keeps up to STAGES k-blocks in flight
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0, ti = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++ti) {
        const Tile tl = tile_at(s, t, 0, 0);
        const int k_begin = tl.split * s.rows_per_split;
        const int k_end = min(s.k_len, k_begin + s.rows_per_split);
        for (int k0 = k_begin; k0 < k_end; k0 += BK, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          unsigned char* a_s = smem + st * STAGE_BYTES;
          unsigned char* b_s = a_s + A_BYTES;
          mbar_expect_tx(&full[st], STAGE_BYTES);
          if constexpr (A_MN) {
            tma_load_mn(a_s, &ta, &full[st], tl.m0, k0, tl.z, s.a_k_outer);
            tma_load_mn(a_s + HALF, &ta, &full[st], tl.m0 + 64, k0, tl.z,
                        s.a_k_outer);
          } else {
            tma_load(a_s, &ta, &full[st], k0, tl.z, tl.m0);
          }
          if constexpr (B_MN) {
            tma_load_mn(b_s, &tb, &full[st], tl.n0, k0, tl.z, s.b_k_outer);
            tma_load_mn(b_s + HALF, &tb, &full[st], tl.n0 + 64, k0, tl.z,
                        s.b_k_outer);
          } else {
            tma_load(b_s, &tb, &full[st], k0, tl.n0, tl.z);
          }
        }
        if constexpr (Epi::kTileIO) {
          // after the k-blocks, so that waiting for the epilogue two tiles
          // back (the buffer's last user) holds back no mainloop load
          const int b = ti % TILE_BUFS;
          unsigned char* buf = tile_bufs + b * TILE_BYTES;
          mbar_wait(&tile_empty[b], ((ti / TILE_BUFS) & 1) ^ 1);
          mbar_expect_tx(&tile_full[b], TILE_BYTES);
          tma_load(buf, &tc, &tile_full[b], tl.n0, tl.z, tl.m0);
          tma_load(buf + TILE_BYTES / 2, &tc, &tile_full[b], tl.n0 + 64,
                   tl.z, tl.m0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies rows [wg*64, wg*64 + 64) of a tile
  int it = 0, ti = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++ti) {
    const Tile tl = tile_at(s, t, wg, threadIdx.x % 128);
    const int k_begin = tl.split * s.rows_per_split;
    const int k_end = min(s.k_len, k_begin + s.rows_per_split);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int k0 = k_begin; k0 < k_end; k0 += BK, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + st * STAGE_BYTES) + wg * HALF;
      const uint32_t b_addr = smem_u32(smem + st * STAGE_BYTES + A_BYTES);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major: 16 columns are 32 bytes along the swizzled line; an
        // MN-major operand advances 16 lines of 128 bytes. SBO: 8 lines.
        // LBO: the next 64-wide box (MN-major), unused for K-major.
        const uint64_t da = A_MN ? smem_desc(a_addr + kk * 2048, HALF, 1024)
                                 : smem_desc(a_addr + kk * 32, 16, 1024);
        const uint64_t db = B_MN ? smem_desc(b_addr + kk * 2048, HALF, 1024)
                                 : smem_desc(b_addr + kk * 32, 16, 1024);
        wgmma_m64n128k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      // keep this stage's products in flight; the previous stage is done
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (k0 > k_begin) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (k_end > k_begin) mbar_arrive(&empty[(it - 1) % STAGES]);
    const int b = ti % TILE_BUFS;
    unsigned char* buf = tile_bufs + b * TILE_BYTES;
    if constexpr (Epi::kTileIO)
      mbar_wait(&tile_full[b], (ti / TILE_BUFS) & 1);
    epi(acc, tl, scratch, buf);
    if constexpr (Epi::kTileIO) {
      // the epilogue's writes to the tile buffer, made visible to TMA
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync();
      if (threadIdx.x == 0) {
        tma_store(&td, buf, tl.n0, tl.z, tl.m0);
        tma_store(&td, buf + TILE_BYTES / 2, tl.n0 + 64, tl.z, tl.m0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the previous tile's store has read its buffer: it may be refilled
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        if (ti > 0) mbar_arrive(&tile_empty[(ti - 1) % TILE_BUFS]);
      }
    }
  }
  if constexpr (Epi::kTileIO) {
    // the last stores must finish before the block exits
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 tensor of lines of `width` contiguous elements, indexed by two
// outer axes of sizes d1, d2 and byte strides s1, s2; boxes of b0 x b1 x b2
// elements, zeros past every edge. By default a box line is 64 elements
// (128 bytes) in the 128-byte swizzle that wgmma reads.
inline cudaError_t make_map(
    CUtensorMap* map, const void* base, uint64_t width, uint64_t d1,
    uint64_t s1, uint64_t d2, uint64_t s2, uint32_t b1, uint32_t b2,
    uint32_t b0 = 64,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "gemm_sm90: cuTensorMapEncodeTiled not found\n");
    return cudaErrorNotSupported;
  }
  const cuuint64_t dims[3] = {width, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr,
            "gemm_sm90: cuTensorMapEncodeTiled error %d (width %llu, dims "
            "%llu x %llu, strides %llu %llu, box %u x %u x %u)\n",
            static_cast<int>(r), static_cast<unsigned long long>(width),
            static_cast<unsigned long long>(d1),
            static_cast<unsigned long long>(d2),
            static_cast<unsigned long long>(s1),
            static_cast<unsigned long long>(s2), b0, b1, b2);
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// K-major A: rows (axis 2) of `width` K columns (per head, axis 1);
// boxes of 64 K columns x 128 rows
inline cudaError_t map_k_major(CUtensorMap* map, const void* base,
                               uint64_t width, uint64_t heads, uint64_t rows,
                               uint64_t ld) {
  return make_map(map, base, width, heads, width * 2, rows, ld * 2, 1, BM);
}

// K-major B: `rows` N lines of `width` K columns per head (axis 1, row
// stride ld), heads on axis 2 (stride head_stride elements); boxes of 64 K
// columns x 128 rows of one head, so rows past a head's last read zeros
inline cudaError_t map_k_major_b(CUtensorMap* map, const void* base,
                                 uint64_t width, uint64_t rows, uint64_t ld,
                                 uint64_t heads, uint64_t head_stride) {
  return make_map(map, base, width, rows, ld * 2, heads, head_stride * 2, BN,
                  1);
}

// MN-major operand of 64 K lines a box. k_outer: lines (rows, K) on axis 2
// with heads on axis 1 (a head is `width` columns of a row of ld);
// otherwise K on axis 1 with stride ld and heads on axis 2 with stride
// head_stride (elements).
inline cudaError_t map_mn_major(CUtensorMap* map, const void* base,
                                uint64_t width, uint64_t heads, uint64_t k_len,
                                uint64_t ld, uint64_t head_stride,
                                bool k_outer) {
  if (k_outer)
    return make_map(map, base, width, heads, width * 2, k_len, ld * 2, 1, BK);
  return make_map(map, base, width, k_len, ld * 2, heads, head_stride * 2, BK,
                  1);
}

constexpr int MAX_DEVICES = 64;

// The current device's SM count, once `kernel`'s shared-memory limit is
// set on it. Both are per device: `sms` (one array per kernel, indexed by
// device ordinal, 0 until that device is prepared) keeps the count of each
// device on which the limit has been set.
template <class Kernel>
cudaError_t prepare(Kernel kernel, int smem, int (&sms)[MAX_DEVICES],
                    int* count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
    sms[dev] = n;
  }
  *count = sms[dev];
  return cudaSuccess;
}

// one block per SM (at most one per tile) of the current device. Each
// instance of the kernel sets its own shared-memory limit at its first
// launch on each device.
template <bool A_MN, bool B_MN = true, class Epi>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const Shape& s, const Epi& epi, cudaStream_t stream,
                   const CUtensorMap* tc = nullptr,
                   const CUtensorMap* td = nullptr) {
  static int per_device[MAX_DEVICES] = {};
  int sms = 0;
  const cudaError_t err = prepare(gemm_kernel<A_MN, B_MN, Epi>,
                                  smem_bytes<Epi>(), per_device, &sms);
  if (err != cudaSuccess) return err;
  const int tiles = ((s.n + BN - 1) / BN) * ((s.m + BM - 1) / BM) * s.heads *
                    s.splits;
  if (Epi::kTileIO && (tc == nullptr || td == nullptr))
    return cudaErrorInvalidValue;
  gemm_kernel<A_MN, B_MN, Epi><<<tiles < sms ? tiles : sms, THREADS,
                                 smem_bytes<Epi>(), stream>>>(
      ta, tb, tc ? *tc : ta, td ? *td : ta, s, epi);
  return cudaGetLastError();
}

}  // namespace sm90
