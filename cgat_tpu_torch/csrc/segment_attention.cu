// Segment softmax + weighted aggregation over destination-sorted edges.
//
// Replaces the TPU kernel cgat_tpu/ops/pallas/segment_attention.py:
// _fwd_kernel (launched by _fwd_impl). For every destination node n and
// column c of the flat (E, H*F) inputs:
//
//   out[n, c] = sum_{e -> n} exp(a[e,c] - max_n[c]) * m[e,c]
//               / (sum_{e -> n} exp(a[e,c] - max_n[c]) + 1e-16)
//
// where max_n is the exact per-node column max. Node n's in-edges are the
// contiguous run [offn[n], offn[n+1]) of the sorted edge arrays, clamped to
// the real-edge count, so padded edges (a suffix) never count and a node
// with no in-edge gets 0.
//
// Bound on the H100: bytes. At serving request 0's shape (19,968 edge slots,
// 18,528 of them real, H*F = 640, bf16) the kernel must read alpha and m on
// the real rows once (47 MB) and write out (1 MB): 14.5 us at 3.35 TB/s,
// against 71 M max/exp/add/fma operations, about 1 us at the card's f32
// rate.
//
// Design (the stream kernel, segment_attention_fwd_stream): a persistent
// grid of one block per SM. The real rows are cut into equal contiguous
// spans, one a block, from the real-row count read on the device (so a
// replayed CUDA graph stays right for every batch of its signature). A block
// owns the nodes whose clamped start lies in its span, and an equal share of
// those that start at n_real (no real row: the padded node slots, which one
// block alone would write after its rows), found by counting the node
// starts below each end of the span and below n_real (one round of loads at
// the main path's shapes, issued with n_real's;
// ops/kernels/segment_attention.py stream_spans is the same count in torch
// ops), and streams its nodes' rows to their end, past the span's end if
// its last node runs over it: every node is written by exactly one block,
// with no merge across blocks and no atomics, and the rows stay balanced
// by bytes whatever the degrees, to within a node a block.
// The rows reach shared memory as the TPU kernel's double-buffered chunks
// reach VMEM, but deeper: one producer thread issues 1-D bulk copies
// (cp.async.bulk, completion counted in bytes on an mbarrier) of tiles of
// whole rows of alpha and m, contiguous in device memory, into a ring of 2
// stages of 40 KB (16 rows of each array at H*F = 640 in bf16), so that up
// to 80 KB are in flight per SM where the one-block-a-node design kept ~7
// to 16 KB (a ring of 160 KB ran 5 to 7 % slower at request 0: with every
// SM's ring full the card holds 21 MB of copies in flight, and each waits
// the longer in device memory's queue); alpha is read from device memory
// once. Each consumer thread
// owns the fewest bytes of a row that keep the block within MAX_THREADS (4:
// 2 bf16 columns, 320 consumer threads at H*F = 640; 3 warps of 16-byte
// owners ran slower, chip_variants.py segment_attention) and keeps its
// columns' running max, exp-sum and weighted sum in f32 registers. For the
// rows of one node in one tile it first takes their max (exact, as the
// plain version's), rescales its sums by exp(old - new) once, then adds
// exp(a - max) (ex2 of a pre-scaled difference) and its product with m, in
// groups of 4 rows with no branch inside a group so that each warp keeps
// the group's loads and exps in flight; at the node's last row it writes
// out and, when asked, max and den. A warp releases a stage once all its
// lanes have read it (one arrival a warp). The order of rows is fixed, so
// two launches give the same bits. Rows whose width is no multiple of 16
// bytes, pointers not 16-byte aligned and rows wider than MAX_GROUPS * 16
// bytes go to the per-node kernel (segment_attention_fwd): one block per
// destination node, each thread owning 4 adjacent columns (1 where
// unaligned) and walking the node's rows twice, once for the exact max and
// once for the sums. A node with no real row gets out 0, max -1e30 and den
// 0 from both.
//
// Backward: replaces _bwd_kernel (launched by _bwd_call). Per real edge
// e -> n and column c, with q = g[n] / (den[n] + 1e-16):
//
//   dm[e, c] = exp(a[e,c] - max_n[c]) * q[n, c]
//   dalpha[e, c] = dm[e, c] * (m[e,c] - out[n, c])
//
// and 0 for padded edges (e >= n_real). It reads the f32 max and den the
// forward wrote, never a bf16-rounded max. Bound: bytes. At the flagship
// shape it reads alpha and m and writes dalpha and dm, four (E, 640) bf16
// arrays (102 MB), plus the node arrays g, out, max and den (6.4 MB):
// ~32 us at 3.35 TB/s. Design: edge-parallel, one thread per 4 adjacent
// columns of one edge row; each edge reads its destination's node rows
// directly through its dst id (the TPU kernel's one-hot gather matmul over
// a node window is not needed). The node rows are re-read by the ~24 edges
// of each node from L1/L2. q is formed in the kernel, so no (N, H*F) q
// array is written.
#include <climits>

#include "common.cuh"
#include "gemm_sm90.cuh"   // mbarrier helpers and the per-device prepare

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr float SOFTMAX_EPS = 1e-16f;

// ---- forward: the stream kernel ----
namespace bulk {

constexpr int MAX_THREADS = 512;            // the producer warp and consumers
constexpr int MAX_GROUPS = MAX_THREADS - 32; // consumer threads at most
constexpr int STAGE_BYTES = 40 * 1024;      // alpha's and m's rows a stage
constexpr int RING_BYTES = 80 * 1024;
constexpr int MAX_STAGES = 8;
constexpr int MAX_ROWS = 64;                // rows of a tile at most
constexpr int SCAN = 32;                    // starts a thread counts a round
constexpr int SMEM = RING_BYTES + 2 * MAX_STAGES * 8 + 3 * MAX_THREADS / 8;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// `bytes` contiguous bytes into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ __nv_bfloat162 as_pair(uint32_t w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

__device__ __forceinline__ uint32_t as_word(__nv_bfloat162 p) {
  return *reinterpret_cast<const uint32_t*>(&p);
}

// W 32-bit words at p, in one 4-, 8- or 16-byte access (two for 32 bytes)
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    static_assert(W == 4, "4, 8 or 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      reinterpret_cast<uint4*>(p)[i / 4] =
          make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
  uint32_t w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = __float_as_uint(v[i]);
  store_words<N>(p, w);
}

// A consumer thread's B bytes of a row: N columns of T as f32
template <typename T, int B>
struct Cols {
  static constexpr int W = B / 4;
  static constexpr int N = B / static_cast<int>(sizeof(T));

  static __device__ __forceinline__ void unpack(const uint32_t (&w)[W],
                                                float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (sizeof(T) == 2) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        v[i] = __uint_as_float(w[i]);
      }
    }
  }
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              float (&v)[N]) {
    uint32_t w[W];
    load_words<W>(p, w);
    unpack(w, v);
  }
  // the larger of two words' columns, bf16 in pairs: exact
  static __device__ __forceinline__ uint32_t max2(uint32_t x, uint32_t y) {
    if constexpr (sizeof(T) == 2)
      return as_word(__hmax2(as_pair(x), as_pair(y)));
    else
      return __float_as_uint(fmaxf(__uint_as_float(x), __uint_as_float(y)));
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[N]) {
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (sizeof(T) == 2)
        w[i] = as_word(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
      else
        w[i] = __float_as_uint(v[i]);
    }
    store_words<W>(p, w);
  }
};

// One node's running (max, exp-sum, weighted sum) of a thread's columns
template <typename T, int B>
struct Running {
  using C = Cols<T, B>;
  static constexpr int N = C::N;
  float mx[N], den[N], num[N];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mx[i] = NEG_BIG;
      den[i] = 0.f;
      num[i] = 0.f;
    }
  }

  // `rows` (>= 1) rows of the node, `stride` bytes apart in shared memory:
  // their max first, the sums rescaled once to it, then each row's terms.
  // Rows go in groups of G with no branch inside a group: every load of a
  // group is issued before its first use (a row past the last reads the
  // last again: the max does not move, and its terms are zeroed), so that
  // a warp keeps G rows' loads and exps in flight.
  static constexpr int G = 4;
  __device__ __forceinline__ void add(const unsigned char* a,
                                      const unsigned char* m, int rows,
                                      int stride) {
    constexpr int W = C::W;
    uint32_t top[W];
    load_words<W>(a, top);
    for (int r0 = 1; r0 < rows; r0 += G) {
      uint32_t u[G][W];
#pragma unroll
      for (int j = 0; j < G; ++j)
        load_words<W>(a + min(r0 + j, rows - 1) * stride, u[j]);
#pragma unroll
      for (int i = 0; i < W; ++i)
        top[i] = C::max2(top[i], C::max2(C::max2(u[0][i], u[1][i]),
                                         C::max2(u[2][i], u[3][i])));
    }
    float t[N];
    C::unpack(top, t);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      t[i] = fmaxf(mx[i], t[i]);
      const float scale = ex2((mx[i] - t[i]) * LOG2E);
      den[i] *= scale;
      num[i] *= scale;
      mx[i] = t[i];
    }
    for (int r0 = 0; r0 < rows; r0 += G) {
      uint32_t aw[G][W], mw[G][W];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int r = min(r0 + j, rows - 1) * stride;
        load_words<W>(a + r, aw[j]);
        load_words<W>(m + r, mw[j]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const bool real_row = r0 + j < rows;
        float av[N], mv[N];
        C::unpack(aw[j], av);
        C::unpack(mw[j], mv);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float p = real_row ? ex2((av[i] - mx[i]) * LOG2E) : 0.f;
          den[i] += p;
          num[i] = fmaf(p, mv[i], num[i]);
        }
      }
    }
  }

  // out by the approximate divide (2 ulp; IEEE division's check and slow
  // path cost a node's close more than its rows; a node with no real row
  // gets 0 / 1e-16 = 0)
  __device__ __forceinline__ void write(T* out, float* max_out,
                                        float* den_out, size_t at) const {
    float o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __fdividef(num[i], den[i] + SOFTMAX_EPS);
    C::store(out + at, o);
    if (max_out != nullptr) store_f32<N>(max_out + at, mx);
    if (den_out != nullptr) store_f32<N>(den_out + at, den);
  }
};

// Warp 0's first thread produces; consumer thread 32 + g takes the g-th B
// bytes of every row (g < groups; the consumer warps' other lanes follow
// the loop and compute nothing). A stage holds `tile_rows` rows of alpha,
// then as many of m.
template <typename T, int B>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    segment_attention_fwd_stream(const T* __restrict__ alpha,
                                 const T* __restrict__ m,
                                 const int* __restrict__ offn,
                                 const int* __restrict__ n_real,
                                 int num_nodes, int hf, int tile_rows,
                                 int stages, T* __restrict__ out,
                                 float* __restrict__ max_out,
                                 float* __restrict__ den_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  int* below = reinterpret_cast<int*>(empty + MAX_STAGES);
  const int row_bytes = hf * static_cast<int>(sizeof(T));
  const int groups = row_bytes / B;
  const int tile_bytes = tile_rows * row_bytes;   // one array's part a stage
  if (threadIdx.x == 0) {      // the barriers, visible after the counts' sync
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], blockDim.x / 32 - 1);   // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this block's span [lo, hi) of the real rows (the first real % blocks
  // spans one row longer); it owns the nodes whose clamped start lies in
  // it, and an equal share of the nodes that start at n_real (no real row:
  // the padded node slots, a block's skipped destinations). The starts
  // never fall, so those are the nodes from the count of starts below lo
  // to the count below hi, and the share of those from the count below
  // n_real on, counted SCAN starts a thread a round (one round at the main
  // path's shapes), the first round's loads issued with n_real's
  const int real = *n_real;
  const int per = real / gridDim.x, extra = real % gridDim.x;
  const int lo = blockIdx.x * per + min(blockIdx.x, extra);
  const int hi = lo + per + (blockIdx.x < extra);
  int c_lo = 0, c_hi = 0, c_real = 0;
  for (int base = 0; base < num_nodes; base += SCAN * blockDim.x) {
    int starts[SCAN];
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      const int n = base + threadIdx.x + j * blockDim.x;
      starts[j] = n < num_nodes ? __ldg(offn + n) : INT_MAX;
    }
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      const int s = min(starts[j], real);
      c_lo += s < lo;
      c_hi += s < hi;
      c_real += s < real;
    }
  }
  const int warps = blockDim.x / 32, w = threadIdx.x / 32;
  c_lo = __reduce_add_sync(0xffffffffu, c_lo);
  c_hi = __reduce_add_sync(0xffffffffu, c_hi);
  c_real = __reduce_add_sync(0xffffffffu, c_real);
  if (threadIdx.x % 32 == 0) {         // each warp's counts, then the sums
    below[w] = c_lo;
    below[warps + w] = c_hi;
    below[2 * warps + w] = c_real;
  }
  __syncthreads();
  int n_lo = 0, n_hi = 0, first_empty = 0;
  for (int i = 0; i < warps; ++i) {
    n_lo += below[i];
    n_hi += below[warps + i];
    first_empty += below[2 * warps + i];
  }
  const int empties = num_nodes - first_empty;
  const int e_lo = first_empty + blockIdx.x * (empties / gridDim.x) +
                   min(blockIdx.x, empties % gridDim.x);
  const int e_hi = e_lo + empties / gridDim.x +
                   (blockIdx.x < empties % gridDim.x);
  // the rows of nodes [n_lo, n_hi), which may run past hi
  const int r0 = n_lo < n_hi ? min(__ldg(offn + n_lo), real) : 0;
  const int r1 = n_lo < n_hi ? min(__ldg(offn + n_hi), real) : 0;
  const int tiles = (r1 - r0 + tile_rows - 1) / tile_rows;

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      const unsigned char* a = reinterpret_cast<const unsigned char*>(alpha) +
                               static_cast<size_t>(r0) * row_bytes;
      const unsigned char* mm = reinterpret_cast<const unsigned char*>(m) +
                                static_cast<size_t>(r0) * row_bytes;
      int s = 0, use = 0;
      for (int t = 0; t < tiles; ++t) {
        if (use > 0) sm90::mbar_wait(&empty[s], (use - 1) & 1);
        // the last tile stops at r1 <= n_real <= E: no read past the arrays
        const int rows = min(tile_rows, r1 - r0 - t * tile_rows);
        const uint32_t bytes = static_cast<uint32_t>(rows * row_bytes);
        unsigned char* dst = smem + s * 2 * tile_bytes;
        const size_t from = static_cast<size_t>(t) * tile_bytes;
        sm90::mbar_expect_tx(&full[s], 2 * bytes);
        bulk_load(dst, a + from, bytes, &full[s]);
        bulk_load(dst + tile_bytes, mm + from, bytes, &full[s]);
        if (++s == stages) { s = 0; ++use; }
      }
    }
    return;
  }
  const int g = threadIdx.x - 32;
  const bool mine = g < groups;
  const int col = g * Cols<T, B>::N;
  Running<T, B> run;
  run.reset();
  if (n_lo < n_hi) {
    // node's rows end at `end`; the next node's end is loaded a node ahead
    int node = n_lo;
    int end = min(__ldg(offn + node + 1), real);
    int next_end = node + 1 < n_hi ? min(__ldg(offn + node + 2), real)
                                    : INT_MAX;
    auto close = [&]() {
      if (mine)
        run.write(out, max_out, den_out,
                  static_cast<size_t>(node) * hf + col);
      run.reset();
      ++node;
      end = next_end;
      next_end = node + 1 < n_hi ? min(__ldg(offn + node + 2), real)
                                 : INT_MAX;
    };
    const unsigned char* ring = smem + g * B;
    int s = 0, use = 0;
    for (int t = 0; t < tiles; ++t) {
      sm90::mbar_wait(&full[s], use & 1);
      const unsigned char* a_t = ring + s * 2 * tile_bytes;
      const int row0 = r0 + t * tile_rows;
      const int row_end = min(row0 + tile_rows, r1);
      for (int r = row0; r < row_end;) {
        while (end <= r) close();          // nodes with no real row
        const int stop = min(end, row_end);
        const unsigned char* at = a_t + (r - row0) * row_bytes;
        if (mine) run.add(at, at + tile_bytes, stop - r, row_bytes);
        r = stop;
        if (r == end) close();
      }
      __syncwarp();                        // the warp's reads of the stage
      if (threadIdx.x % 32 == 0) sm90::mbar_arrive(&empty[s]);
      if (++s == stages) { s = 0; ++use; }
    }
    while (node < n_hi) close();           // empty nodes after the rows
  }
  for (int n = e_lo; n < e_hi; ++n)        // the share of those at n_real
    if (mine)
      run.write(out, max_out, den_out, static_cast<size_t>(n) * hf + col);
}

// one block per SM of the current device, which sets the kernel's
// shared-memory limit at its first launch there
template <typename T, int B>
cudaError_t launch_bytes(const void* alpha, const void* m, const int* offn,
                         const int* n_real, int num_nodes, int hf, void* out,
                         float* max_out, float* den_out,
                         cudaStream_t stream) {
  static int per_device[sm90::MAX_DEVICES] = {};
  int sms = 0;
  const cudaError_t err = sm90::prepare(segment_attention_fwd_stream<T, B>,
                                        SMEM, per_device, &sms);
  if (err != cudaSuccess) return err;
  const int row_bytes = hf * static_cast<int>(sizeof(T));
  int rows = STAGE_BYTES / (2 * row_bytes);
  rows = rows < 1 ? 1 : (rows > MAX_ROWS ? MAX_ROWS : rows);
  int stages = RING_BYTES / (2 * rows * row_bytes);
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  const int threads = 32 + (row_bytes / B + 31) / 32 * 32;
  segment_attention_fwd_stream<T, B><<<sms, threads, SMEM, stream>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(m), offn, n_real,
      num_nodes, hf, rows, stages, static_cast<T*>(out), max_out, den_out);
  return cudaGetLastError();
}

// the fewest bytes of a row a consumer thread can take within MAX_GROUPS
// threads: more warps to hide each row's latencies
template <typename T>
cudaError_t launch(const void* alpha, const void* m, const int* offn,
                   const int* n_real, int num_nodes, int hf, void* out,
                   float* max_out, float* den_out, cudaStream_t stream) {
  const int row_bytes = hf * static_cast<int>(sizeof(T));
  if (row_bytes / 4 <= MAX_GROUPS)
    return launch_bytes<T, 4>(alpha, m, offn, n_real, num_nodes, hf, out,
                              max_out, den_out, stream);
  if (row_bytes / 8 <= MAX_GROUPS)
    return launch_bytes<T, 8>(alpha, m, offn, n_real, num_nodes, hf, out,
                              max_out, den_out, stream);
  return launch_bytes<T, 16>(alpha, m, offn, n_real, num_nodes, hf, out,
                             max_out, den_out, stream);
}

}  // namespace bulk

// ---- forward: the per-node kernel, for the rows the stream does not take

template <typename T, int VEC>
__global__ void segment_attention_fwd(const T* __restrict__ alpha,
                                      const T* __restrict__ m,
                                      const int* __restrict__ offn,
                                      const int* __restrict__ n_real,
                                      int hf, T* __restrict__ out,
                                      float* __restrict__ max_out,
                                      float* __restrict__ den_out) {
  const int node = blockIdx.x;
  const int real = *n_real;
  const int start = min(offn[node], real);
  const int end = min(offn[node + 1], real);
  const int groups = hf / VEC;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int col = g * VEC;
    float mx[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) mx[v] = NEG_BIG;
    for (int e = start; e < end; ++e) {
      float a[VEC];
      load_vec<VEC>(alpha + static_cast<size_t>(e) * hf + col, a);
#pragma unroll
      for (int v = 0; v < VEC; ++v) mx[v] = fmaxf(mx[v], a[v]);
    }
    float den[VEC], num[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) { den[v] = 0.f; num[v] = 0.f; }
    for (int e = start; e < end; ++e) {
      float a[VEC], mv[VEC];
      load_vec<VEC>(alpha + static_cast<size_t>(e) * hf + col, a);
      load_vec<VEC>(m + static_cast<size_t>(e) * hf + col, mv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float ex = expf(a[v] - mx[v]);
        den[v] += ex;
        num[v] = fmaf(ex, mv[v], num[v]);
      }
    }
    float o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) o[v] = num[v] / (den[v] + SOFTMAX_EPS);
    const size_t at = static_cast<size_t>(node) * hf + col;
    store_vec<VEC>(out + at, o);
    if (max_out != nullptr) store_vec<VEC>(max_out + at, mx);
    if (den_out != nullptr) store_vec<VEC>(den_out + at, den);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* alpha, const void* m, const int* offn,
                   const int* n_real, int num_nodes, int hf, void* out,
                   float* max_out, float* den_out, cudaStream_t stream) {
  const int groups = hf / VEC;
  int threads = ((groups + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  segment_attention_fwd<T, VEC><<<num_nodes, threads, 0, stream>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(m), offn, n_real,
      hf, static_cast<T*>(out), max_out, den_out);
  return cudaGetLastError();
}

template <typename T, int VEC>
__global__ void segment_attention_bwd(
    const T* __restrict__ alpha, const T* __restrict__ m,
    const int* __restrict__ ids, const int* __restrict__ n_real,
    const T* __restrict__ g, const T* __restrict__ out,
    const float* __restrict__ max_in, const float* __restrict__ den_in,
    int n_rows, int hf, T* __restrict__ dalpha, T* __restrict__ dm) {
  const int groups = hf / VEC;
  const int64_t total = static_cast<int64_t>(n_rows) * groups;
  const int real = *n_real;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(t / groups);
    const int col = static_cast<int>(t % groups) * VEC;
    const size_t at = static_cast<size_t>(e) * hf + col;
    float da[VEC], dmv[VEC];
    if (e < real) {
      const size_t nat = static_cast<size_t>(ids[e]) * hf + col;
      float a[VEC], mv[VEC], gv[VEC], o[VEC], mx[VEC], den[VEC];
      load_vec<VEC>(alpha + at, a);
      load_vec<VEC>(m + at, mv);
      load_vec<VEC>(g + nat, gv);
      load_vec<VEC>(out + nat, o);
      load_vec<VEC>(max_in + nat, mx);
      load_vec<VEC>(den_in + nat, den);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float q = gv[v] / (den[v] + SOFTMAX_EPS);
        dmv[v] = expf(a[v] - mx[v]) * q;
        da[v] = dmv[v] * (mv[v] - o[v]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) { da[v] = 0.f; dmv[v] = 0.f; }
    }
    store_vec<VEC>(dalpha + at, da);
    store_vec<VEC>(dm + at, dmv);
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* alpha, const void* m, const int* ids,
                       const int* n_real, const void* g, const void* out,
                       const float* max_in, const float* den_in, int n_rows,
                       int hf, void* dalpha, void* dm, cudaStream_t stream) {
  constexpr int THREADS = 256;
  const int64_t total = static_cast<int64_t>(n_rows) * (hf / VEC);
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 65535 * 16 ? want : 65535 * 16);
  segment_attention_bwd<T, VEC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(m), ids, n_real,
      static_cast<const T*>(g), static_cast<const T*>(out), max_in, den_in,
      n_rows, hf, static_cast<T*>(dalpha), static_cast<T*>(dm));
  return cudaGetLastError();
}

}  // namespace

// alpha, m: (E, hf) of one dtype (bf16 if is_bf16 else f32), C-contiguous;
// offn: (>= num_nodes + 1,) int32 unclamped CSR pointers over the sorted
// destinations; n_real: device int32 scalar, the real-edge count; out:
// (num_nodes, hf) in the input dtype; max_out, den_out: optional
// (num_nodes, hf) f32 (null to skip).
CGAT_EXPORT int cgat_segment_attention_fwd(const void* alpha, const void* m,
                                           const int* offn, const int* n_real,
                                           int num_nodes, int hf, int is_bf16,
                                           void* out, float* max_out,
                                           float* den_out, void* stream) {
  if (num_nodes <= 0 || hf <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(alpha) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(max_out) |
                         reinterpret_cast<uintptr_t>(den_out);
  // the stream takes rows of whole 16-byte groups, up to MAX_GROUPS of
  // them, from and to 16-byte aligned arrays (ops/kernels/
  // segment_attention.py streams() is the same test)
  const int row_bytes = hf * (is_bf16 ? 2 : 4);
  if (row_bytes % 16 == 0 && row_bytes / 16 <= bulk::MAX_GROUPS &&
      addr % 16 == 0)
    return static_cast<int>(
        is_bf16 ? bulk::launch<bf16>(alpha, m, offn, n_real, num_nodes, hf,
                                       out, max_out, den_out, s)
                : bulk::launch<float>(alpha, m, offn, n_real, num_nodes,
                                        hf, out, max_out, den_out, s));
  const bool vec4 = (hf % 4 == 0) && (addr % 16 == 0);
  cudaError_t err;
  if (is_bf16) {
    err = vec4 ? launch<bf16, 4>(alpha, m, offn, n_real, num_nodes, hf, out,
                                 max_out, den_out, s)
               : launch<bf16, 1>(alpha, m, offn, n_real, num_nodes, hf, out,
                                 max_out, den_out, s);
  } else {
    err = vec4 ? launch<float, 4>(alpha, m, offn, n_real, num_nodes, hf, out,
                                  max_out, den_out, s)
               : launch<float, 1>(alpha, m, offn, n_real, num_nodes, hf, out,
                                  max_out, den_out, s);
  }
  return static_cast<int>(err);
}

// alpha, m, dalpha, dm: (n_rows, hf) of one dtype (bf16 if is_bf16 else
// f32), C-contiguous; ids: (n_rows,) int32 destination per row; n_real:
// device int32 scalar, the real-row count; g, out: (num_nodes, hf) in the
// input dtype; max_in, den_in: (num_nodes, hf) f32 from the forward.
CGAT_EXPORT int cgat_segment_attention_bwd(
    const void* alpha, const void* m, const int* ids, const int* n_real,
    const void* g, const void* out, const float* max_in, const float* den_in,
    int n_rows, int hf, int is_bf16, void* dalpha, void* dm, void* stream) {
  if (n_rows <= 0 || hf <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(alpha) | reinterpret_cast<uintptr_t>(m) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(max_in) |
      reinterpret_cast<uintptr_t>(den_in) |
      reinterpret_cast<uintptr_t>(dalpha) | reinterpret_cast<uintptr_t>(dm);
  const bool vec4 = (hf % 4 == 0) && (addr % 16 == 0);
  cudaError_t err;
  if (is_bf16) {
    err = vec4 ? launch_bwd<bf16, 4>(alpha, m, ids, n_real, g, out, max_in,
                                     den_in, n_rows, hf, dalpha, dm, s)
               : launch_bwd<bf16, 1>(alpha, m, ids, n_real, g, out, max_in,
                                     den_in, n_rows, hf, dalpha, dm, s);
  } else {
    err = vec4 ? launch_bwd<float, 4>(alpha, m, ids, n_real, g, out, max_in,
                                      den_in, n_rows, hf, dalpha, dm, s)
               : launch_bwd<float, 1>(alpha, m, ids, n_real, g, out, max_in,
                                      den_in, n_rows, hf, dalpha, dm, s);
  }
  return static_cast<int>(err);
}
