// Static-shape collate of crystal graphs: the native core of
// cgat_tpu_torch/data/batching.py `collate`.
//
// Every crystal's atoms take one contiguous, ascending range of node slots,
// and its edges point only inside it. So the stable sort of all edges by
// destination is each crystal's own stable sort by local destination,
// concatenated in crystal order, and the stable sort of that array by source
// is again each crystal's block sorted stably by local source, with the
// padding suffix (source N - 1) last. Each is a counting sort over the
// crystal's atoms: O(E) for the batch, with no comparison sort. The CSR row
// pointers come from the same counts. Output equals the numpy collate of the
// JAX package (cgat_tpu/data/batching.py) array for array.
//
// The crystals' arrays are read where they lie, through the buffer protocol:
// no per-field concatenation and no Python loop. Every field of the batch is
// written once. Every source and destination is checked against its own
// crystal's atom count before anything of that crystal is written.
//
// C ABI for ctypes: `cgat_graph_counts` and `cgat_collate` take a Python
// list and run with the interpreter lock held (ctypes.PyDLL); `cgat_collate`
// lets it go for all but reading the crystals' attributes. Build:
// cgat_tpu_torch/native/build.py, at first use.

#include <sched.h>
#include <sys/types.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// The few functions of CPython's stable ABI used here (the limited API holds
// the buffer protocol since 3.11), declared so that no Python headers are
// needed to build; they resolve against the interpreter that loads the
// library.
extern "C" {
struct _object;
typedef _object PyObject;
typedef ssize_t Py_ssize_t;
struct Py_buffer {
  void* buf;
  PyObject* obj;
  Py_ssize_t len;
  Py_ssize_t itemsize;
  int readonly;
  int ndim;
  char* format;
  Py_ssize_t* shape;
  Py_ssize_t* strides;
  Py_ssize_t* suboffsets;
  void* internal;
};
PyObject* PyUnicode_InternFromString(const char*);
PyObject* PyList_GetItem(PyObject*, Py_ssize_t);
PyObject* PyObject_GetAttr(PyObject*, PyObject*);
Py_ssize_t PyObject_Size(PyObject*);
int PyObject_GetBuffer(PyObject*, Py_buffer*, int);
void PyBuffer_Release(Py_buffer*);
double PyFloat_AsDouble(PyObject*);
PyObject* PyErr_Occurred();
void Py_DecRef(PyObject*);
void* PyEval_SaveThread();
void PyEval_RestoreThread(void*);
}

namespace {

constexpr int kBufRecords = 0x0004 | 0x0008 | 0x0010;  // PyBUF_RECORDS_RO

std::atomic<int64_t> g_batches{0};
std::atomic<int64_t> g_crystals{0};

// real edges a thread takes at least: below this a thread costs more to
// start than it saves
constexpr int64_t kEdgesPerThread = 1 << 14;

// a crystal's array fields, in the order the buffers are held
enum Field { kAtom, kSrc, kDst, kShell, kComp, kWeight, kFields };
const char* const kNames[kFields + 1] = {"atom_fea", "edge_src", "edge_dst",
                                         "edge_shell", "comp_fea",
                                         "comp_weight", "target"};

PyObject* name(int f) {
  static PyObject* names[kFields + 1] = {};
  if (!names[f]) names[f] = PyUnicode_InternFromString(kNames[f]);
  return names[f];
}

// the element type of a buffer: signed 32/64-bit integers, f32 or f64
enum Kind { kOther, kI32, kI64, kF32, kF64 };

Kind kind_of(const Py_buffer& v) {
  const char* f = v.format ? v.format : "B";
  if (*f == '@' || *f == '=' || *f == '<') ++f;
  if (f[0] == 0 || f[1] != 0) return kOther;
  switch (f[0]) {
    case 'i': case 'l': case 'q': case 'n':
      return v.itemsize == 4 ? kI32 : v.itemsize == 8 ? kI64 : kOther;
    case 'f':
      return v.itemsize == 4 ? kF32 : kOther;
    case 'd':
      return v.itemsize == 8 ? kF64 : kOther;
  }
  return kOther;
}

struct Crystal {
  Py_buffer v[kFields];
  Kind k[kFields];
  double target;
};

inline int64_t int_at(const Crystal& c, int f, Py_ssize_t i) {
  const char* p = static_cast<const char*>(c.v[f].buf) + i * c.v[f].strides[0];
  return c.k[f] == kI32 ? *reinterpret_cast<const int32_t*>(p)
                        : *reinterpret_cast<const int64_t*>(p);
}

inline float float_at(const Crystal& c, int f, Py_ssize_t off) {
  const char* p = static_cast<const char*>(c.v[f].buf) + off;
  return c.k[f] == kF32 ? *reinterpret_cast<const float*>(p)
                        : static_cast<float>(*reinterpret_cast<const double*>(p));
}

// rows x F of field f (2-D) into out, cast to f32
void copy_rows(const Crystal& c, int f, int64_t rows, int64_t F, float* out) {
  const Py_buffer& v = c.v[f];
  if (c.k[f] == kF32 && v.strides[1] == 4 && v.strides[0] == 4 * F) {
    std::memcpy(out, v.buf, sizeof(float) * rows * F);
    return;
  }
  for (int64_t r = 0; r < rows; ++r)
    for (int64_t j = 0; j < F; ++j)
      out[r * F + j] = float_at(c, f, r * v.strides[0] + j * v.strides[1]);
}

struct Batch {
  int64_t F, R;
  const Crystal* crystals;
  const int64_t *node0, *edge0;  // each crystal's first node and edge
  float *nodes, *target;
  uint8_t* node_mask;
  int32_t* node2graph;
  float *comp_fea, *comp_weight;
  uint8_t *comp_mask, *graph_mask;
  int32_t *edge_src, *edge_dst, *edge_shell;
  uint8_t* edge_mask;
  int32_t *src_perm, *src_sorted, *dst_offn, *src_offn;
};

// Crystals [g0, g1): a stable counting sort of each one's edges by local
// destination, then of that block by local source, and its node and
// composition rows. Returns the first crystal with an edge id outside its
// own atoms (nothing of it written), else -1.
int64_t fill_crystals(const Batch& b, int64_t g0, int64_t g1) {
  std::vector<int64_t> cnt, scnt;
  std::vector<int32_t> s_in, d_in;
  const int64_t F = b.F, R = b.R;
  for (int64_t i = g0; i < g1; ++i) {
    const Crystal& c = b.crystals[i];
    const int64_t base = b.node0[i], e0 = b.edge0[i];
    const int64_t n = b.node0[i + 1] - base, m = b.edge0[i + 1] - e0;
    s_in.resize(m);
    d_in.resize(m);
    cnt.assign(n + 1, 0);
    scnt.assign(n + 1, 0);
    for (int64_t k = 0; k < m; ++k) {
      const int64_t s = int_at(c, kSrc, k), d = int_at(c, kDst, k);
      if (s < 0 || s >= n || d < 0 || d >= n) return i;
      s_in[k] = static_cast<int32_t>(s);
      d_in[k] = static_cast<int32_t>(d);
      ++cnt[d + 1];
      ++scnt[s + 1];
    }
    for (int64_t a = 0; a < n; ++a) {
      cnt[a + 1] += cnt[a];
      scnt[a + 1] += scnt[a];
      b.dst_offn[base + a] = static_cast<int32_t>(e0 + cnt[a]);
      b.src_offn[base + a] = static_cast<int32_t>(e0 + scnt[a]);
      b.node_mask[base + a] = 1;
      b.node2graph[base + a] = static_cast<int32_t>(i);
    }
    const int32_t off = static_cast<int32_t>(base);
    for (int64_t k = 0; k < m; ++k) {
      const int64_t p = e0 + cnt[d_in[k]]++;
      b.edge_src[p] = s_in[k] + off;
      b.edge_dst[p] = d_in[k] + off;
      b.edge_shell[p] = static_cast<int32_t>(int_at(c, kShell, k));
      b.edge_mask[p] = 1;
    }
    for (int64_t p = e0; p < e0 + m; ++p) {
      const int32_t s = b.edge_src[p];
      const int64_t q = e0 + scnt[s - off]++;
      b.src_perm[q] = static_cast<int32_t>(p);
      b.src_sorted[q] = s;
    }

    copy_rows(c, kAtom, n, F, b.nodes + base * F);
    const int64_t r = c.v[kComp].shape[0];
    float* cf = b.comp_fea + i * R * F;
    copy_rows(c, kComp, r, F, cf);
    std::memset(cf + r * F, 0, sizeof(float) * (R - r) * F);
    for (int64_t j = 0; j < R; ++j) {
      b.comp_weight[i * R + j] =
          j < r ? float_at(c, kWeight, j * c.v[kWeight].strides[0]) : 0.0f;
      b.comp_mask[i * R + j] = j < r;
    }
    b.target[i] = static_cast<float>(c.target);
    b.graph_mask[i] = 1;
  }
  return -1;
}

// Threads for a batch of e_real real edges: one per kEdgesPerThread, at
// most half the CPUs this process may run on (on an H100's 8-core host, 4
// threads collated 512 and 5,000 crystals as fast as 8 did).
int thread_count(int64_t e_real) {
  cpu_set_t set;
  const int cpus =
      sched_getaffinity(0, sizeof(set), &set) == 0 ? CPU_COUNT(&set) : 1;
  return static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(e_real / kEdgesPerThread, cpus / 2)));
}

// Whether crystal c's buffers have the kinds and shapes a batch of width F
// and R composition slots takes.
bool fits(const Crystal& c, int64_t F, int64_t R) {
  for (int f = 0; f < kFields; ++f) {
    const bool ints = f == kSrc || f == kDst || f == kShell;
    const bool rows = f == kAtom || f == kComp;
    if (c.k[f] == kOther || ints != (c.k[f] == kI32 || c.k[f] == kI64) ||
        c.v[f].ndim != (rows ? 2 : 1) || (rows && c.v[f].shape[1] != F) ||
        c.v[f].suboffsets)
      return false;
  }
  const Py_ssize_t m = c.v[kSrc].shape[0], r = c.v[kComp].shape[0];
  return c.v[kDst].shape[0] == m && c.v[kShell].shape[0] == m &&
         c.v[kWeight].shape[0] == r && r <= R;
}

}  // namespace

extern "C" {

// Each crystal's atoms, edges and composition rows (the lengths of
// atom_fea, edge_src and comp_fea) of the list `graphs`. Returns 0, or -1
// with the Python error set.
int cgat_graph_counts(PyObject* graphs, int64_t G, int64_t* n_atoms,
                      int64_t* n_edges, int64_t* n_comp) {
  const int fields[3] = {kAtom, kSrc, kComp};
  int64_t* out[3] = {n_atoms, n_edges, n_comp};
  for (int64_t i = 0; i < G; ++i) {
    PyObject* g = PyList_GetItem(graphs, i);
    if (!g) return -1;
    for (int j = 0; j < 3; ++j) {
      PyObject* nm = name(fields[j]);
      PyObject* a = nm ? PyObject_GetAttr(g, nm) : nullptr;
      if (!a) return -1;
      out[j][i] = PyObject_Size(a);
      Py_DecRef(a);
      if (out[j][i] < 0) return -1;
    }
  }
  return 0;
}

// Every field of a batch of the G crystals of the list `graphs` in N node,
// E edge, C crystal and R composition slots of width F: nodes (N x F),
// target (C), node_mask, node2graph (N), node2graph_offn (C + margin + 1),
// comp_fea (C x R x F), comp_weight, comp_mask (C x R), graph_mask (C), the
// edge fields (E) and edge_dst_offn, edge_src_offn (N + margin + 1). Masks
// are one byte each (numpy bool). The crystals' arrays may be int32 or
// int64 (edges) and f32 or f64 (rows and weights), of any strides. Large
// batches split their crystals over threads by real edges.
//
// Returns 0; 1 if some edge id lies outside its crystal (*bad = the first
// such crystal; nothing written out of bounds); 2 if the crystals do not
// fit N, E or C; 3 if crystal *bad's arrays are not of the kinds and shapes
// above; -1 with the Python error set if reading an attribute failed.
int cgat_collate(PyObject* graphs, int64_t G, int64_t N, int64_t E,
                 int64_t C, int64_t R, int64_t F, int64_t margin,
                 float* nodes, float* target, uint8_t* node_mask,
                 int32_t* node2graph, int32_t* node2graph_offn,
                 float* comp_fea, float* comp_weight, uint8_t* comp_mask,
                 uint8_t* graph_mask, int32_t* edge_src, int32_t* edge_dst,
                 int32_t* edge_shell, uint8_t* edge_mask, int32_t* src_perm,
                 int32_t* src_sorted, int32_t* dst_offn, int32_t* src_offn,
                 int64_t* bad) {
  // with the lock: every crystal's buffers, held until the end
  std::vector<Crystal> crystals(G);
  std::vector<int64_t> node0(G + 1), edge0(G + 1);
  int64_t held = 0;  // crystals whose buffers are all held
  int rc = 0;
  for (; held < G; ++held) {
    Crystal& c = crystals[held];
    PyObject* g = PyList_GetItem(graphs, held);
    int got = 0;
    for (; g && got < kFields; ++got) {
      PyObject* nm = name(got);
      PyObject* a = nm ? PyObject_GetAttr(g, nm) : nullptr;
      const int err = a ? PyObject_GetBuffer(a, &c.v[got], kBufRecords) : -1;
      if (a) Py_DecRef(a);
      if (err) break;
      c.k[got] = kind_of(c.v[got]);
    }
    PyObject* nm = got == kFields ? name(kFields) : nullptr;
    PyObject* t = nm ? PyObject_GetAttr(g, nm) : nullptr;
    if (t) {
      c.target = PyFloat_AsDouble(t);
      Py_DecRef(t);
    }
    if (!t || PyErr_Occurred()) {
      for (int f = 0; f < got; ++f) PyBuffer_Release(&c.v[f]);
      rc = -1;
      break;
    }
    if (!fits(c, F, R)) {
      *bad = held++;
      rc = 3;
      break;
    }
    node0[held + 1] = node0[held] + c.v[kAtom].shape[0];
    edge0[held + 1] = edge0[held] + c.v[kSrc].shape[0];
  }
  if (rc == 0 && (G > C || node0[G] > N || edge0[G] > E)) rc = 2;

  if (rc == 0) {
    void* state = PyEval_SaveThread();
    const Batch b{F, R, crystals.data(), node0.data(), edge0.data(), nodes,
                  target, node_mask, node2graph, comp_fea, comp_weight,
                  comp_mask, graph_mask, edge_src, edge_dst, edge_shell,
                  edge_mask, src_perm, src_sorted, dst_offn, src_offn};
    const int64_t n_real = node0[G], e_real = edge0[G];
    // thread t takes the crystals whose edges start in its equal share
    const int T = thread_count(e_real);
    std::vector<int64_t> first(T + 1, G), found(T, -1);
    first[0] = 0;
    for (int t = 1; t < T; ++t)
      first[t] = std::lower_bound(edge0.begin(), edge0.begin() + G,
                                  e_real * t / T) - edge0.begin();
    std::vector<std::thread> pool;
    for (int t = 1; t < T; ++t)
      pool.emplace_back(
          [&, t] { found[t] = fill_crystals(b, first[t], first[t + 1]); });
    found[0] = fill_crystals(b, first[0], first[1]);
    for (auto& th : pool) th.join();
    for (int t = 0; t < T && rc == 0; ++t) {
      if (found[t] >= 0) {
        *bad = found[t];
        rc = 1;
      }
    }

    // padding: crystal slots, node slots (graph C - 1) and the False edge
    // suffix (N - 1 at both ends, shell 0, its own place in the source
    // order)
    std::memset(nodes + n_real * F, 0, sizeof(float) * (N - n_real) * F);
    std::memset(target + G, 0, sizeof(float) * (C - G));
    std::memset(comp_fea + G * R * F, 0, sizeof(float) * (C - G) * R * F);
    std::memset(comp_weight + G * R, 0, sizeof(float) * (C - G) * R);
    std::memset(comp_mask + G * R, 0, (C - G) * R);
    std::memset(graph_mask + G, 0, C - G);
    std::memset(node_mask + n_real, 0, N - n_real);
    for (int64_t a = n_real; a < N; ++a)
      node2graph[a] = static_cast<int32_t>(C - 1);
    const int32_t last = static_cast<int32_t>(N - 1);
    for (int64_t p = e_real; p < E; ++p) {
      edge_src[p] = last;
      edge_dst[p] = last;
      src_perm[p] = static_cast<int32_t>(p);
      src_sorted[p] = last;
    }
    std::memset(edge_shell + e_real, 0, sizeof(int32_t) * (E - e_real));
    std::memset(edge_mask + e_real, 0, E - e_real);

    // CSR row pointers, as a searchsorted of the sorted ids gives them:
    // off[0] = 0 and off[k] = #ids < k. Past the real nodes only the
    // padding counts: none below N, all of it from N on.
    for (int64_t k = n_real; k <= N + margin; ++k) {
      const int32_t v = static_cast<int32_t>(k < N ? e_real : E);
      dst_offn[k] = v;
      src_offn[k] = v;
    }
    dst_offn[0] = 0;
    src_offn[0] = 0;
    // graph g's nodes precede graph g + 1's; padding nodes are graph C - 1
    for (int64_t k = 0; k <= C + margin; ++k) {
      const int64_t real = node0[std::min(k, G)];
      node2graph_offn[k] = static_cast<int32_t>(
          k == 0 ? 0 : real + (k >= C ? N - n_real : 0));
    }
    PyEval_RestoreThread(state);
  }

  for (int64_t i = 0; i < held; ++i)
    for (int f = 0; f < kFields; ++f) PyBuffer_Release(&crystals[i].v[f]);
  if (rc == 0) {
    g_batches.fetch_add(1, std::memory_order_relaxed);
    g_crystals.fetch_add(G, std::memory_order_relaxed);
  }
  return rc;
}

// Batches and crystals collated since the library was loaded.
void cgat_collate_stats(int64_t* out) {
  out[0] = g_batches.load(std::memory_order_relaxed);
  out[1] = g_crystals.load(std::memory_order_relaxed);
}

}  // extern "C"
