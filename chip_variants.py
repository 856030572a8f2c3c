#!/usr/bin/env python3
"""Time variants of one of the port's kernels on one CUDA card.

    python3 chip_variants.py [mh_network | hyper_apply_bwd_dk |
                              mh_network_bwd | hyper_apply |
                              segment_attention | hyper_apply_timeline |
                              profiler_window]

Builds the kernel's source as it is and variants of it, each from a
patched copy under ``build/variants/<study>/``, then times each in turns
(each variant twice, in mirrored order), by its device time per kernel
(profiler) and CUDA events. Needs nvcc and a Hopper card; prints one line
per run and the card's name and power limit.

``mh_network`` (the default; ``cgat_tpu_torch/csrc/mh_network.cu``): the
forward at the serving shape of the reference-default model (E = 19,968
edge rows, cat 384, hid 256, 5 heads, F 128; seeded random bf16 inputs).
Every variant that stores is first held against the plain version on
ragged shapes and at that one, forward and backward. The variants:

- ``committed``: the source as it is (16-byte stores from quad shuffles);
- ``pairs``: one 4-byte store per bf16 pair, as fragments lie in registers;
- ``no_store``: no output stored: the mainloop and epilogue arithmetic
  alone, a floor for what the stores cost (its outputs are garbage);
- ``tma_store``: the epilogue writes a swizzled tile buffer that TMA
  stores while the next tile runs (the mainloop's tile buffers, made
  store-only).

``mh_network_bwd`` (``cgat_tpu_torch/csrc/mh_network.cu``): the backward
at the training step's shape (E = 18,432 rows, cat 384, hid 256, 5 heads,
F 128; seeded random inputs, h from the forward as a step saves it), each
launch's device time a row of its own. The variants that compute the
gradients are first held against the plain version (ragged shapes and
that one); the others take a part out (their outputs are garbage):

- ``committed``: the source as it is (pass A, pass B, reduce);
- ``five_launches``: dpre and dWout as two products (the path of
  F > 128), dx and dWin as two more, then the reduce: the structure of
  the design before pass A and pass B;
- ``no_store``: no dpre and no dx stored;
- ``no_mma``: no ``wgmma`` at all;
- ``loads_only``: no products and no epilogues: the consumers wait for
  each stage and release it (the range's partials are still written).

``hyper_apply_bwd_dk`` (``cgat_tpu_torch/csrc/hyper_apply.cu``, namespace
``dk``): dK at the training step's shape (B = 768 rows, C = I = O = 128;
seeded random bf16 inputs), and at B = 64 (one k-block: launch, first
loads and stores). The variants that still compute dK and db are held
against the plain version (ragged shapes and that one); the others take a
part out and time what is left (their outputs are garbage):

- ``committed``: the source as it is;
- ``first_design``: each 16-row step loads its x fragment and g's values
  (generic loads) only after the wait, and db converts pairs through
  bf16x2 to float2;
- ``wait0``: every step waits for all earlier products (none in flight);
- ``drain``: each k-block waits for its products and releases its stage
  at once, not one k-block later;
- ``stages4``: a ring of 4 stages, not 6;
- ``no_db``: no db sums;
- ``no_scale``: the fragments are x as ldmatrix loads it: no g multiply,
  no db sums;
- ``no_mma``: no ``wgmma`` at all: the loads, the fragments of dP and db
  and the stores;
- ``loads_only``: the consumers wait for each stage and release it: the
  TMA loads alone (52 MB from L2 at that shape) and the stores;
- ``no_store``: no dK stored.

``hyper_apply`` (``cgat_tpu_torch/csrc/hyper_apply.cu``, namespace
``fwd``): the forward at request 0's shape of the serving forward (B = 832
rows, C = I = O = 128) and at the training step's (B = 768); seeded random
bf16 inputs. The variants that still compute the function are held
against the plain version (ragged shapes and those two); the others take a
part out (their outputs are garbage):

- ``committed``: the source as it is;
- ``first_design``: the design first landed: the epilogue multiplies
  bf16(P_o + c_o) by x in f32 FMAs, each thread into its two rows' sums,
  which the quad adds by shuffles (no ``mma.sync``); the warpgroups take
  turns; a ring of 6 stages;
- ``turns``: the two warpgroups take turns (two named barriers), as the
  dh/dx kernel's do: each issues its products only once the other's are
  done;
- ``stages6``: a ring of 6 stages, not 4;
- ``no_epilogue``: the products of P only: no bias, rounding, x loads, x
  product or row sums (the tail and the stores stay);
- ``no_mma``: no ``wgmma`` at all;
- ``loads_only``: no products and no epilogue: the consumers wait for each
  stage and release it (the tail's stores stay).

``segment_attention`` (``cgat_tpu_torch/csrc/segment_attention.cu``): the
forward (#1) at the three shapes ``utils.roofline.measure_kernels`` times
it at (serving request 0's, the first training step's with the f32 max and
exp-sum written, a GP batch's; seeded random bf16 rows at H*F = 640), each
by its device time cold in HBM (``roofline._device_time``: 20 calls in a
CUDA graph over input copies twice the L2) beside its bound. The variants
that compute the function are held against the plain version (the main
path's three shapes and ``segment_layout``'s layouts):

- ``committed``: the source as it is (the stream kernel);
- ``per_node``: every width to the per-node kernel (one block a node, two
  passes over its rows): the kernel before the stream, unchanged;
- ``cols16``: 16 bytes of a row a consumer thread (8 bf16 columns: 80
  threads, 3 warps at H*F = 640), not the fewest bytes within 480 threads
  (4: 320 threads, 10 warps);
- ``ring_160k``: a ring of 160 KB (4 stages), not 80 (2);
- ``stage_20k``: stages of 20 KB (8 rows of each array), not 40 (16);
- ``loads_only``: the consumers wait for each tile and release it: the
  bulk copies, the partition and the nodes' stores alone (the outputs are
  garbage).

``hyper_apply_timeline``: one launch of the forward at the same two shapes,
built with clock64() stamps (SM clocks from the block's start) at each
pass of each consumer warpgroup: its start, its first k-block's data, its
products done and its epilogue done (the tail pass last, without the data
stamp), and at each k-block the producer issues. Prints a few blocks' stamps
and the mean of each interval by pass.

``profiler_window``: not a kernel variant but ``chip_smoke.device_ms``'s.
The reference-default bf16 model's eager forward on request 0's batch of
64 crystals, profiled three forwards at a time, ``WINDOW_PROFILES`` times
bare (no primer kernels, no pause at the ends of the profiler's window)
and as many times with ``device_ms``'s window (its primer and its
``PROFILE_PAD_S`` pause), in turns. A profile whose device events
by kernel name (``chip_smoke.kernel_events``) differ from three times
one windowed forward's has lost events; prints how many of each kind
did, and the device events each counted.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from cgat_tpu_torch.ops.kernels import build
from cgat_tpu_torch.ops.kernels import hyper_apply as hk
from cgat_tpu_torch.ops.kernels import mh_network as mk
from cgat_tpu_torch.ops.kernels import segment_attention as sk
from cgat_tpu_torch.utils import roofline

OUT = Path(__file__).resolve().parent / "build" / "variants"
SHAPE = (19968, 384, 256, 128, 5)      # E, cat, hid, F, heads
WINDOW_PROFILES = 100                  # profiles of each kind
CASES = [(37, 48, 32, 16, 2), (300, 384, 80, 128, 5), (500, 64, 128, 16, 2),
         (1000, 384, 256, 128, 5)]

EPI_HEAD = """    const int lane = t.thread % 32, warp = t.thread / 32, q = lane % 4;
    const int row0 = t.m0 + t.wg * 64 + warp * 16 + lane / 4;
    const bf16* b = bias + static_cast<size_t>(t.z) * n;
    bf16* o = out + static_cast<size_t>(t.z) * n;
"""
PAIRS_BODY = EPI_HEAD + """#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = t.n0 + i * 8 + q * 2;
      if (col >= n) continue;
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b + col));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        float v0 = acc[i * 4 + half * 2] + bv.x;
        float v1 = acc[i * 4 + half * 2 + 1] + bv.y;
        if (LEAKY) {
          v0 = v0 > 0.f ? v0 : LEAKY_SLOPE * v0;
          v1 = v1 > 0.f ? v1 : LEAKY_SLOPE * v1;
        }
        if (row < m)
          *reinterpret_cast<__nv_bfloat162*>(
              o + static_cast<size_t>(row) * ld + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
};
"""
TILE_EPI = """template <bool LEAKY>
struct TileBiasEpi {
  static constexpr bool kTileIO = true;
  static constexpr bool kTileLoad = false;
  const bf16* bias;
  int n;

  __device__ void operator()(float (&acc)[64], const sm90::Tile& t, float*,
                             unsigned char* tile) const {
    const int lane = t.thread % 32, warp = t.thread / 32;
    const bf16* b = bias + static_cast<size_t>(t.z) * n;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = i * 8 + (lane % 4) * 2;
      const float2 bv = t.n0 + c < n
          ? __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(b + t.n0 + c))
          : make_float2(0.f, 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = t.wg * 64 + warp * 16 + lane / 4 + half * 8;
        float v0 = acc[i * 4 + half * 2] + bv.x;
        float v1 = acc[i * 4 + half * 2 + 1] + bv.y;
        if (LEAKY) {
          v0 = v0 > 0.f ? v0 : LEAKY_SLOPE * v0;
          v1 = v1 > 0.f ? v1 : LEAKY_SLOPE * v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(tile + sm90::tile_offset(r, c)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
};

"""
TMA_LAUNCHES = """      (err = sm90::map_k_major(&h_st, h, hh, 1, n_rows, hh)) ||
      (err = sm90::map_k_major(&out_st, out, f, heads, n_rows, heads * f)))
    return static_cast<int>(err);
  if ((err = sm90::launch<false, false>(
           x_k, win_k, sm90::Shape{n_rows, hh, cat, cat, 1, 1, 0, 0},
           TileBiasEpi<true>{static_cast<const bf16*>(b_in), hh}, st, &h_st,
           &h_st)))
    return static_cast<int>(err);
  return static_cast<int>(sm90::launch<false, false>(
      h_k, wout_k, sm90::Shape{n_rows, f, hid, hid, heads, 1, 0, 0},
      TileBiasEpi<false>{static_cast<const bf16*>(b_out), f}, st, &out_st,
      &out_st));
}
"""


def patch(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"chip_variants: the source no longer holds {old!r}")
    return text.replace(old, new, 1)


def mh_sources() -> dict[str, dict[str, str]]:
    """Each mh_network variant's csrc files that differ from the committed
    ones."""
    cu = (build.CSRC / "mh_network.cu").read_text()
    gemm = (build.CSRC / "gemm_sm90.cuh").read_text()
    start = cu.index(EPI_HEAD)
    end = cu.index("};\n", start) + 3
    pairs = cu[:start] + PAIRS_BODY + cu[end:]
    no_store = patch(cu, "if (row < m && col < n)",
                     "if (row < m && col < n && ld < 0)")
    tma = patch(cu, "struct DpreEpi {\n  static constexpr bool kTileIO = true;",
                "struct DpreEpi {\n  static constexpr bool kTileIO = true;\n"
                "  static constexpr bool kTileLoad = true;")
    tma = patch(tma, "// Epilogue of dpre where F > 128",
                TILE_EPI + "// Epilogue of dpre where F > 128")
    tma = patch(tma, "CUtensorMap x_k, win_k, h_k, wout_k;",
                "CUtensorMap x_k, win_k, h_k, wout_k, h_st, out_st;")
    a = tma.index("static_cast<uint64_t>(f) * hid)))\n    return")
    b = tma.index("// x: (n_rows, cat); h: (n_rows, heads*hid) from the forward;")
    tma = (tma[:a] + "static_cast<uint64_t>(f) * hid)) ||\n" + TMA_LAUNCHES
           + "\n" + tma[b:])
    gemm_tma = patch(gemm, """          mbar_expect_tx(&tile_full[b], TILE_BYTES);
          tma_load(buf, &tc, &tile_full[b], tl.n0, tl.z, tl.m0);
          tma_load(buf + TILE_BYTES / 2, &tc, &tile_full[b], tl.n0 + 64,
                   tl.z, tl.m0);""", """          if constexpr (Epi::kTileLoad) {
            mbar_expect_tx(&tile_full[b], TILE_BYTES);
            tma_load(buf, &tc, &tile_full[b], tl.n0, tl.z, tl.m0);
            tma_load(buf + TILE_BYTES / 2, &tc, &tile_full[b], tl.n0 + 64,
                     tl.z, tl.m0);
          } else {
            mbar_arrive(&tile_full[b]);
          }""")
    return {"committed": {}, "pairs": {"mh_network.cu": pairs},
            "no_store": {"mh_network.cu": no_store},
            "tma_store": {"mh_network.cu": tma, "gemm_sm90.cuh": gemm_tma}}


def build_all(variants, source: str) -> dict[str, Path]:
    """One nvcc per variant of csrc/<source>.cu, all started together."""
    procs = {}
    for name, files in variants.items():
        d = OUT / source / name
        d.mkdir(parents=True, exist_ok=True)
        for src in build.CSRC.iterdir():
            if src.suffix in (".cu", ".cuh"):
                (d / src.name).write_text(files.get(src.name,
                                                    src.read_text()))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / f"{source}.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"chip_variants: {name} did not build\n{log}")
        libs[name] = lib
    return libs


PLAN = mk.bwd_plan


def use(lib: Path, source: str, name: str = "committed") -> None:
    """Make the wrappers of csrc/<source>.cu launch the kernels of library
    ``lib``; the ``five_launches`` variant of the backward plans dpre and
    dWout as two products (the path of F > 128) at every width."""
    mk.bwd_plan = PLAN if name != "five_launches" else (
        lambda *shape: mk._plan(*shape, False, mk.TILE, mk.K_STEP))
    cdll = ctypes.CDLL(str(lib))
    cdll.cgat_error_string.argtypes = [ctypes.c_int]
    cdll.cgat_error_string.restype = ctypes.c_char_p
    build._loaded[source] = cdll
    if source == "mh_network":
        mk._fwd.cache_clear()
        mk._bwd.cache_clear()
    elif source == "segment_attention":
        sk._fwd.cache_clear()
        sk._bwd.cache_clear()
    else:
        hk._entry.cache_clear()


def inputs(gen, rows, cat, hid, f, heads):
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * scale).bfloat16()
    return (r(rows, cat), r(heads * hid, cat, scale=cat ** -0.5),
            r(heads * hid, scale=0.1), r(heads * f, hid, scale=hid ** -0.5),
            r(heads * f, scale=0.1), heads)


def mh_check(name, gen) -> None:
    """Forward (both outputs) and backward against the plain versions."""
    for shape in CASES + [SHAPE]:
        args = inputs(gen, *shape)
        x, win, _, wout, _, heads = args
        out, h = mk.mh_network(*args, return_hidden=True)
        p_out, p_h = mk.mh_network_plain(*args, return_hidden=True)
        cs.compare(name, out, p_out)
        cs.compare(name, h, p_h)
        cot = torch.randn(out.shape, generator=gen, device="cuda").bfloat16()
        for a, b in zip(mk.mh_network_bwd(x, h, cot, win, wout, heads),
                        mk.mh_network_bwd_plain(x, h, cot, win, wout, heads)):
            cs.compare(f"{name} backward", a, b)


DK_SHAPE = (768, 128, 128, 128)        # B, C, I, O
DK_CASES = [(100, 48, 16, 16), (200, 256, 48, 32), (129, 128, 128, 128)]
DK_MMA = """        sm90::wgmma_m64n128k16_rs<1>(
            acc, a[kk], sm90::smem_desc(h_addr + kk * 2048, HALF, 1024));
"""
DK_SCALE = """        a[kk][0] = mul_pair(xs[kk][0], gs[kk][0]);
        a[kk][1] = mul_pair(xs[kk][1], gs[kk][0]);
        a[kk][2] = mul_pair(xs[kk][2], gs[kk][1]);
        a[kk][3] = mul_pair(xs[kk][3], gs[kk][1]);
"""
DK_DB = """        db0 += pair_sum(a[kk][0]) + pair_sum(a[kk][2]);
        db1 += pair_sum(a[kk][1]) + pair_sum(a[kk][3]);
"""
DK_LOADS = """        ldmatrix_x4_trans(xs[kk], x_addr + kk * 2048);
        gs[kk][0] = g_pair(g_addr + kk * 256);
        gs[kk][1] = g_pair(g_addr + kk * 256 + 128);
"""
# the first design: each 16-row step loads its fragment and g's values
# (generic loads) after the wait, and sums pairs through bf16x2 -> float2
DK_FIRST_SUM = """  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return f.x + f.y;"""
DK_FIRST_BUILD = """        ldmatrix_x4_trans(a[kk], x_addr + kk * 2048);
        const bf16* g_s = reinterpret_cast<const bf16*>(
                              stage + X_BYTES + H_BYTES) + tl.o % G_COLS;
        const int b = 16 * kk + 2 * q;
        const __nv_bfloat162 g0 =
            __halves2bfloat162(g_s[b * G_COLS], g_s[(b + 1) * G_COLS]);
        const __nv_bfloat162 g1 =
            __halves2bfloat162(g_s[(b + 8) * G_COLS], g_s[(b + 9) * G_COLS]);
        a[kk][0] = mul_pair(a[kk][0], g0);
        a[kk][1] = mul_pair(a[kk][1], g0);
        a[kk][2] = mul_pair(a[kk][2], g1);
        a[kk][3] = mul_pair(a[kk][3], g1);
"""
DK_RELEASE = """        if (kk == BK / 16 - 1 && k0 > 0)
          sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
"""
DK_COMMIT = """        asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
      }
    }"""
DK_RIGHT = ("committed", "first_design", "wait0", "drain", "stages4")


def dk_sources() -> dict[str, dict[str, str]]:
    """Each dK variant's hyper_apply.cu."""
    cu = (build.CSRC / "hyper_apply.cu").read_text()
    raw = "".join(f"        a[kk][{j}] = xs[kk][{j}];\n" for j in range(4))
    no_scale = patch(patch(cu, DK_SCALE, raw), DK_DB, "")
    first = patch(patch(cu, DK_LOADS, ""), DK_SCALE, DK_FIRST_BUILD)
    first = patch(first, "  return __uint_as_float(v << 16) + "
                  "__uint_as_float(v & 0xffff0000u);", DK_FIRST_SUM)
    drain = patch(patch(cu, DK_RELEASE, ""), DK_COMMIT, DK_COMMIT[:-6] + """
      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
      sm90::mbar_arrive(&empty[st]);
    }""")
    drain = patch(drain, "    sm90::mbar_arrive(&empty[(it - 1) % STAGES]);\n"
                  "\n    // db of rows", "\n    // db of rows")
    variants = {
        "first_design": first,
        "wait0": patch(cu, "wgmma.wait_group.sync.aligned 3;",
                       "wgmma.wait_group.sync.aligned 0;"),
        "drain": drain,
        "stages4": patch(cu, "constexpr int STAGES = 6;\nconstexpr int X_BYTES",
                         "constexpr int STAGES = 4;\nconstexpr int X_BYTES"),
        "no_db": patch(cu, DK_DB, ""),
        "no_scale": no_scale,
        "no_mma": patch(cu, DK_MMA, ""),
        "loads_only": patch(patch(no_scale, DK_MMA, ""), DK_LOADS, ""),
        "no_store": patch(cu, "if (row < s.in_ch && col < s.c_dim)",
                          "if (row < s.in_ch && col < s.c_dim && "
                          "s.n_rows < 0)")}
    return {"committed": {}, **{k: {"hyper_apply.cu": v}
                                for k, v in variants.items()}}


def dk_inputs(gen, rows, c, i, o):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").bfloat16()
    return r(rows, c).tanh(), r(rows, i), r(rows, o), o


def dk_check(name, gen) -> None:
    for shape in DK_CASES + [DK_SHAPE]:
        args = dk_inputs(gen, *shape)
        got, want = hk.hyper_apply_bwd_dk(*args), \
            hk.hyper_apply_bwd_dk_plain(*args)
        cs.compare(name, got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)


BWD_SHAPE = (18432, 384, 256, 128, 5)   # E, cat, hid, F, heads
BWD_RIGHT = ("committed", "five_launches")
DPRE_STORE = "if (row < p.n_rows && t.j0 + col < p.hid)"
DX_STORE = "if (row < m && col < n)\n          *reinterpret_cast<uint4*>(out +"
WGMMA = re.compile(r"sm90::wgmma_m64n\w+<[^>]*>\([^;]*\);")
PASS_B_LAUNCH = """    pass_b::kernel<<<pb.blocks, sm90::THREADS, pass_b::SMEM, st>>>(
        dpre_mn, x_mn, dpre_k, win_mn, static_cast<bf16*>(dx), part_win, pb);
    if ((err = cudaGetLastError())) return static_cast<int>(err);"""
TWO_LAUNCHES = """    if ((err = sm90::launch<false>(
             dpre_k, win_mn, sm90::Shape{n_rows, cat, hh, hh, 1, 1, 0, 0},
             StoreEpi{static_cast<bf16*>(dx), n_rows, cat, cat}, st)) ||
        (err = sm90::launch<true>(
             dpre_mn, x_mn,
             sm90::Shape{hh, cat, n_rows, r_win, 1, s_win, 1, 1},
             PartEpi{part_win, hh, cat, 1}, st)))
      return static_cast<int>(err);"""
EPI_A = ("          const int rr = half * 64 + r;\n",
         "        sm90::mbar_arrive(&empty[st]);\n      }\n      "
         "sm90::mbar_arrive(w_empty);")


def bwd_sources() -> dict[str, dict[str, str]]:
    """Each mh_network_bwd variant's mh_network.cu."""
    cu = (build.CSRC / "mh_network.cu").read_text()
    no_store = patch(patch(cu, DPRE_STORE,
                           DPRE_STORE[:-1] + " && p.n_rows < 0)"),
                     DX_STORE, DX_STORE.replace("col < n)",
                                                "col < n && ld < 0)"))
    no_mma = WGMMA.sub("", cu)
    # no products, no epilogues: pass A's dpre epilogue and pass B's
    # stores go; the consumers wait for each stage and release it
    a = no_mma.index(EPI_A[0])
    b = no_mma.index(EPI_A[1], a)
    loads_only = no_mma[:a] + "        }\n" + no_mma[b:]
    for epi in ("      StoreEpi{dx, p.n_rows, p.cat, p.cat}(acc, tl, nullptr, "
                "nullptr);\n",
                "      PartEpi{part_win, p.hh, p.cat, 1}(acc, tl, nullptr, "
                "nullptr);\n"):
        loads_only = patch(loads_only, epi, "")
    return {"committed": {}, "no_store": {"mh_network.cu": no_store},
            "no_mma": {"mh_network.cu": no_mma},
            "loads_only": {"mh_network.cu": loads_only},
            "five_launches": {"mh_network.cu": patch(
                patch(cu, PASS_B_LAUNCH, TWO_LAUNCHES), "struct StoreEpi {\n",
                "struct StoreEpi {\n  static constexpr bool kTileIO = false;\n")}}


def bwd_args(gen, rows, cat, hid, f, heads):
    """Seeded inputs and the saved h of the forward, as a step saves it."""
    x, win, b_in, wout, b_out, _ = inputs(gen, rows, cat, hid, f, heads)
    _, h = mk.mh_network(x, win, b_in, wout, b_out, heads, return_hidden=True)
    cot = torch.randn(rows, heads * f, generator=gen, device="cuda").bfloat16()
    return x, h, cot, win, wout, heads


def bwd_check(name, gen) -> None:
    for shape in CASES + [BWD_SHAPE]:
        args = bwd_args(gen, *shape)
        for a, b in zip(mk.mh_network_bwd(*args),
                        mk.mh_network_bwd_plain(*args)):
            cs.compare(name, a, b)


def bwd_timed(gen):
    args = bwd_args(gen, *BWD_SHAPE)
    return {"": lambda: mk.mh_network_bwd(*args)}


def mh_timed(gen):
    args = inputs(gen, *SHAPE)
    return {"": lambda: mk.mh_network(*args)}


def dk_timed(gen):
    """At the training shape, and at B = 64 (one k-block: the launch, the
    first loads and the stores, a floor no B goes under)."""
    args = dk_inputs(gen, *DK_SHAPE)
    one = dk_inputs(gen, 64, *DK_SHAPE[1:])
    return {"": lambda: hk.hyper_apply_bwd_dk(*args),
            " at B = 64": lambda: hk.hyper_apply_bwd_dk(*one)}


FWD_SHAPES = ((832, 128, 128, 128), (768, 128, 128, 128))   # B, C, I, O
FWD_CASES = [(100, 128, 128, 128), (7, 64, 32, 48), (300, 128, 384, 48),
             (129, 64, 48, 32)]
FWD_RIGHT = ("committed", "first_design", "turns", "stages6")
FWD_X = """        if (o == t.o_begin || p.in_ch > TILE) {"""
FWD_SUMS = ("      float d0[4] = {0.f, 0.f, 0.f, 0.f}, "
            "d1[4] = {0.f, 0.f, 0.f, 0.f};")
FWD_EPI = re.compile(r"#pragma unroll\n        for \(int kk = 0; "
                     r"kk < TILE / 16; \+\+kk\) \{\n.*?\n        \}\n", re.S)
FWD_DIAG = re.compile(r"      if \(q == lane / 8\) \{\n.*?\n      \}\n", re.S)
# the first design's epilogue: each thread multiplies bf16(P_o + c_o) by x
# in f32 FMAs into two row sums, which the quad adds by shuffles
FWD_FIRST_EPI = """#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 cv = j * 8 < live ? __bfloat1622float2(c[j * 4 + q])
                                         : make_float2(0.f, 0.f);
          const float2 p0 = __bfloat1622float2(__floats2bfloat162_rn(
              acc[j * 4] + cv.x, acc[j * 4 + 1] + cv.y));
          const float2 p1 = __bfloat1622float2(__floats2bfloat162_rn(
              acc[j * 4 + 2] + cv.x, acc[j * 4 + 3] + cv.y));
          const float2 x0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xv[0][j]));
          const float2 x1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xv[1][j]));
          s0 = fmaf(p0.y, x0.y, fmaf(p0.x, x0.x, s0));
          s1 = fmaf(p1.y, x1.y, fmaf(p1.x, x1.x, s1));
        }
"""
FWD_FIRST_SUM = """      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (q == 0) {
        sum_row[o - t.o_begin] = s0;
        sum_row[8 * SUM_LD + o - t.o_begin] = s1;
      }
"""


# the two warpgroups taking turns, as the dh/dx kernel's do: each waits
# for the other's products before issuing its own
FWD_TURNS = (
    ("namespace fwd {\n", """namespace fwd {
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");
}
"""),
    ("  float* sum_row = sums + row_in_tile * SUM_LD;\n",
     """  float* sum_row = sums + row_in_tile * SUM_LD;
  const bool turns = p.c_dim <= STAGES * BK;
  const int mine = 2 + wg, other = 3 - wg;
  if (turns && wg == 1) named_arrive(2);
"""),
    ("\n        for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {",
     "\n        if (turns) named_sync(mine);"
     "\n        for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {"),
    ("\n      for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {",
     "\n      if (turns) named_sync(mine);"
     "\n      for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {"),
    ("        sm90::fence_acc(acc);\n        // bf16(P_o",
     "        sm90::fence_acc(acc);\n        if (turns) named_arrive(other);"
     "\n        // bf16(P_o"),
    ("      sm90::fence_acc(acc);\n      sm90::mbar_arrive(",
     "      sm90::fence_acc(acc);\n      if (turns) named_arrive(other);"
     "\n      sm90::mbar_arrive("),
    ("    __syncwarp();   // the next unit's sums overwrite these\n  }\n",
     "    __syncwarp();   // the next unit's sums overwrite these\n  }\n"
     "  if (turns && wg == 0) named_sync(2);\n"))
FWD_STAGES = "constexpr int STAGES = 4;"


def fwd_sources() -> dict[str, dict[str, str]]:
    """Each forward variant's hyper_apply.cu: namespace fwd patched, the
    backward kernels as they are."""
    cu = (build.CSRC / "hyper_apply.cu").read_text()
    a = cu.index("namespace fwd {")
    b = cu.index("}  // namespace fwd")
    body = cu[a:b]
    if len(FWD_EPI.findall(body)) != 1 or len(FWD_DIAG.findall(body)) != 1:
        raise SystemExit("chip_variants: the forward's epilogue has moved")
    turns = body
    for old, new in FWD_TURNS:
        turns = patch(turns, old, new)
    stages6 = patch(body, FWD_STAGES, "constexpr int STAGES = 6;")
    first = FWD_DIAG.sub(lambda m: FWD_FIRST_SUM, FWD_EPI.sub(
        lambda m: FWD_FIRST_EPI,
        patch(patch(turns, FWD_SUMS, "      float s0 = 0.f, s1 = 0.f;"),
              FWD_STAGES, "constexpr int STAGES = 6;")))
    no_epi = FWD_EPI.sub("", patch(body, FWD_X, FWD_X.replace(
        "if (", "if (p.n_rows < 0 && (").replace(") {", ")) {")))
    no_mma = WGMMA.sub("", body)
    loads_only = WGMMA.sub("", no_epi)
    return {"committed": {}, **{
        k: {"hyper_apply.cu": cu[:a] + v + cu[b:]}
        for k, v in (("first_design", first), ("turns", turns),
                     ("stages6", stages6), ("no_epilogue", no_epi),
                     ("no_mma", no_mma), ("loads_only", loads_only))}}


# the timeline's stamps: per block, consumer warpgroup and pass, its start,
# its first k-block's data, its products done and its epilogue done
TL_PASSES = 16
TL_STAMP = ("if (threadIdx.x % 128 == 0 && pi < {n}) "
            "g_t[((blockIdx.x * 2 + wg) * {n} + pi) * 4 + {e}] = "
            "clock64() - t0;")
TL_EXPORT = """
CGAT_EXPORT int cgat_timeline(void* t, void* p, int clear) {
  static long long zero[1024 * 256] = {};   // the larger of the two
  static_assert(sizeof(zero) >= sizeof(fwd::g_t), "");
  cudaError_t e = clear ? cudaMemcpyToSymbol(fwd::g_t, zero, sizeof(fwd::g_t))
                        : cudaMemcpyFromSymbol(t, fwd::g_t, sizeof(fwd::g_t));
  if (e) return e;
  return clear ? cudaMemcpyToSymbol(fwd::g_p, zero, sizeof(fwd::g_p))
               : cudaMemcpyFromSymbol(p, fwd::g_p, sizeof(fwd::g_p));
}
"""


PRODUCER_WAIT = ("              sm90::mbar_wait(&empty[st], "
                 "((it / STAGES) & 1) ^ 1);")


def timeline_source() -> str:
    """hyper_apply.cu with the forward's clock64() stamps."""
    cu = (build.CSRC / "hyper_apply.cu").read_text()
    a = cu.index("namespace fwd {")
    b = cu.index("}  // namespace fwd")
    stamp = lambda e: TL_STAMP.format(n=TL_PASSES, e=e)
    body = cu[a:b]
    for old, new in (
            ("namespace fwd {\n", "namespace fwd {\nconstexpr int TL_PASSES = "
             f"{TL_PASSES};\n"
             "__device__ long long g_t[1024 * 2 * TL_PASSES * 4];\n"
             "__device__ long long g_p[1024 * 256];\n"),
            ("  const int wg = threadIdx.x / 128;\n",
             "  const int wg = threadIdx.x / 128;\n"
             "  const long long t0 = clock64();\n  int pi = 0;\n"),
            (PRODUCER_WAIT + "\n              unsigned char* a_s",
             PRODUCER_WAIT + "\n              if (it < 256) "
             "g_p[blockIdx.x * 256 + it] = clock64() - t0;"
             "\n              unsigned char* a_s"),
            ("\n        for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {"
             "\n          const int st = it % STAGES;"
             "\n          sm90::mbar_wait(&full[st], (it / STAGES) & 1);\n",
             f"\n        {stamp(0)}"
             "\n        for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {"
             "\n          const int st = it % STAGES;"
             "\n          sm90::mbar_wait(&full[st], (it / STAGES) & 1);\n"
             f"          if (k0 == 0) {{ {stamp(1)} }}\n"),
            ("        sm90::fence_acc(acc);\n        // bf16(P_o",
             f"        sm90::fence_acc(acc);\n        {stamp(2)}\n"
             "        // bf16(P_o"),
            ("        sm90::mbar_arrive(&empty[st]);\n      }\n",
             f"        {stamp(3)}\n        ++pi;\n"
             "        sm90::mbar_arrive(&empty[st]);\n      }\n"),
            ("\n      for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {",
             f"\n      {stamp(0)}"
             "\n      for (int k0 = 0; k0 < p.c_dim; k0 += BK, ++it) {"),
            ("      sm90::fence_acc(acc);\n      sm90::mbar_arrive(",
             f"      sm90::fence_acc(acc);\n      {stamp(2)}\n"
             "      sm90::mbar_arrive("),
            ("    __syncwarp();   // the next unit's sums overwrite these\n",
             f"    {stamp(3)}\n    ++pi;\n"
             "    __syncwarp();   // the next unit's sums overwrite these\n")):
        body = patch(body, old, new)
    return cu[:a] + body + cu[b:] + TL_EXPORT


def fwd_timeline() -> None:
    """One launch at each of FWD_SHAPES with the stamps; prints them."""
    import numpy as np
    lib = build_all({"timeline": {"hyper_apply.cu": timeline_source()}},
                    "hyper_apply")["timeline"]
    use(lib, "hyper_apply")
    cdll = build._loaded["hyper_apply"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = build.sm_count(torch.cuda.current_device())
    for shape in FWD_SHAPES:
        args = fwd_inputs(gen, *shape)
        cs.compare("hyper_apply timeline", hk.hyper_apply(*args),
                   hk.hyper_apply_plain(*args))
        t = np.zeros((1024, 2, TL_PASSES, 4), np.int64)
        prod = np.zeros((1024, 256), np.int64)
        ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
        torch.cuda.synchronize()
        if cdll.cgat_timeline(None, None, 1):
            raise SystemExit("chip_variants: timeline clear failed")
        hk.hyper_apply(*args)
        torch.cuda.synchronize()
        if cdll.cgat_timeline(ptr(t), ptr(prod), 0):
            raise SystemExit("chip_variants: timeline read failed")
        plan = hk.fwd_plan(shape[0], *shape[1:], sms)
        groups, per = plan["groups"]
        blocks = min(plan["m_tiles"] * groups, sms)
        n = per * plan["x_tiles"] + -(-per // 8)
        t, prod = t[:blocks, :, :n], prod[:blocks, :2 * n]
        print(f"[timeline] B = {shape[0]}: {blocks} blocks, {n} passes "
              f"each (the tail last); SM clocks from the block's start")
        for blk in (0, blocks // 2, blocks - 1):
            for wg in range(2):
                print(f"[timeline] block {blk} warpgroup {wg} (start, data, "
                      f"products, epilogue): " + " | ".join(
                          " ".join(map(str, r)) for r in t[blk, wg]))
            print(f"[timeline] block {blk} producer issues: "
                  f"{' '.join(map(str, prod[blk]))}")
        d = t.astype(float)
        for name, (lo, hi) in (("data wait", (0, 1)), ("products", (1, 2)),
                               ("epilogue", (2, 3))):
            for wg in range(2):
                v = (d[:, wg, :-1, hi] - d[:, wg, :-1, lo]).mean(0)
                print(f"[timeline] mean {name}, warpgroup {wg}, by pass: "
                      f"{' '.join(f'{x:.0f}' for x in v)}")
        gap = (d[:, :, 1:, 0] - d[:, :, :-1, 3]).mean((0, 1))
        print(f"[timeline] mean gap from a pass's end to the next's start: "
              f"{' '.join(f'{x:.0f}' for x in gap)}")
        print(f"[timeline] mean first data {d[:, :, 0, 1].mean():.0f}, mean "
              f"end {d[:, :, -1, 3].mean():.0f}, last end "
              f"{d[:, :, -1, 3].max():.0f} clocks")


def fwd_inputs(gen, rows, c, i, o):
    hidden = torch.randn(rows, c, generator=gen, device="cuda").tanh()
    k = torch.randn(o * i + o, c, generator=gen, device="cuda") \
        * (0.1 * (2 / c) ** 0.5)
    bias = torch.rand(o * i + o, generator=gen, device="cuda") * 0.1
    x = torch.randn(rows, i, generator=gen, device="cuda")
    return (hidden.bfloat16(), k.bfloat16(), bias.bfloat16(), x.bfloat16(),
            o)


def fwd_check(name, gen) -> None:
    for shape in FWD_CASES + list(FWD_SHAPES):
        args = fwd_inputs(gen, *shape)
        cs.compare(name, hk.hyper_apply(*args), hk.hyper_apply_plain(*args))


def fwd_timed(gen):
    calls = {}
    for shape in FWD_SHAPES:
        args = fwd_inputs(gen, *shape)
        calls[f" at B = {shape[0]}"] = lambda args=args: hk.hyper_apply(*args)
    return calls


SA_GATE = "  if (row_bytes % 16 == 0 && row_bytes / 16 <= bulk::MAX_GROUPS &&"
SA_ADD = "        if (mine) run.add(at, at + tile_bytes, stop - r, row_bytes);\n"
SA_BYTES = "  if (row_bytes / 4 <= MAX_GROUPS)\n"
SA_RIGHT = ("committed", "per_node", "cols16", "ring_160k", "stage_20k")


def sa_sources() -> dict[str, dict[str, str]]:
    cu = (build.CSRC / "segment_attention.cu").read_text()
    return {"committed": {},
            "per_node": {"segment_attention.cu": patch(
                cu, SA_GATE, "  if (false && row_bytes / 16 <= "
                             "bulk::MAX_GROUPS &&")},
            "cols16": {"segment_attention.cu": patch(
                patch(cu, SA_BYTES, "  if (false)\n"),
                "  if (row_bytes / 8 <= MAX_GROUPS)\n", "  if (false)\n")},
            "ring_160k": {"segment_attention.cu": patch(
                cu, "constexpr int RING_BYTES = 80 * 1024;",
                "constexpr int RING_BYTES = 160 * 1024;")},
            "stage_20k": {"segment_attention.cu": patch(
                cu, "constexpr int STAGE_BYTES = 40 * 1024;",
                "constexpr int STAGE_BYTES = 20 * 1024;")},
            "loads_only": {"segment_attention.cu": patch(
                cu, SA_ADD, "        (void)at;\n")}}


def sa_shapes(gen) -> dict[str, tuple]:
    """#1's shapes in ``measure_kernels``: per label the arguments (seeded
    random bf16 rows at H*F = 640), whether it writes the stats, and its
    work."""
    dev = torch.device("cuda")
    shapes = {}
    for label, batch, stats in (
            (" at request 0", roofline.request_batch(dev), False),
            (" at the training step, stats", roofline.training_batch(dev),
             True),
            (" at a GP batch", roofline.gp_batch(dev), False)):
        n, e = int(batch.num_node_slots), int(batch.num_edge_slots)
        real = batch.edge_mask.sum(dtype=torch.int32)
        args = ((torch.randn(e, 640, generator=gen, device=dev)
                 * 3).bfloat16(),
                torch.randn(e, 640, generator=gen, device=dev).bfloat16(),
                batch.edge_dst_offn, real, n)
        shapes[label] = (args, stats, roofline.segment_attention_work(
            int(real), 640, n, stats))
    return shapes


def sa_check(name, gen) -> None:
    """Out, the exact max and den against the plain version at the three
    shapes and on ``segment_layout``'s layouts."""
    from cgat_tpu_torch.data.synthetic import SEGMENT_LAYOUTS, segment_layout
    cases = [args for args, _, _ in sa_shapes(gen).values()]
    for kind in SEGMENT_LAYOUTS:
        offn, n_real, n = segment_layout(kind)
        e = int(offn[-1])
        cases.append((
            (torch.randn(e, 640, generator=gen, device="cuda")
             * 3).bfloat16(),
            torch.randn(e, 640, generator=gen, device="cuda").bfloat16(),
            torch.from_numpy(offn).cuda(),
            torch.tensor(n_real, dtype=torch.int32, device="cuda"), n))
    for args in cases:
        out, mx, den = sk.segment_attention(*args, return_stats=True)
        p_out, p_mx, p_den = sk.segment_attention_plain(*args)
        cs.compare(name, out, p_out)
        if not (torch.equal(mx, p_mx)
                and torch.allclose(den, p_den, rtol=1e-4, atol=1e-6)):
            raise SystemExit(f"chip_variants: {name}: max or den differs "
                             f"from the plain version's")


def sa_study() -> None:
    """Check the variants that compute #1, then time each at the three
    shapes cold in HBM, in mirrored turns, beside the bound."""
    libs = build_all(sa_sources(), "segment_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        if name in SA_RIGHT:
            use(lib, "segment_attention", name)
            sa_check(name, gen)
    shapes = sa_shapes(gen)
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name], "segment_attention", name)
        for label, (args, stats, work) in shapes.items():
            ms, events = roofline._device_time(
                lambda a, m, rest=args[2:], stats=stats: sk.segment_attention(
                    a, m, *rest, return_stats=stats), args[:2], 20)
            b_ms, b_by = roofline.bound(*work, roofline.F32_FLOPS)
            print(f"[variants] segment_attention {name}{label}: device "
                  f"{ms:.4f} ms cold ({events:.2f} events a call), bound "
                  f"{b_ms:.4f} ms ({b_by}), share {b_ms / ms:.3f}",
                  flush=True)


# per study: its source, its variants, which of them are held against the
# plain version, how, and the calls to time (by label)
STUDIES = {
    "mh_network": ("mh_network", mh_sources, lambda v: v != "no_store",
                   mh_check, mh_timed),
    "hyper_apply_bwd_dk": ("hyper_apply", dk_sources,
                           lambda v: v in DK_RIGHT, dk_check, dk_timed),
    "mh_network_bwd": ("mh_network", bwd_sources, lambda v: v in BWD_RIGHT,
                       bwd_check, bwd_timed),
    "hyper_apply": ("hyper_apply", fwd_sources, lambda v: v in FWD_RIGHT,
                    fwd_check, fwd_timed),
}


def profiler_window() -> None:
    """How many profiles of three eager forwards lose device events, with
    and without the pause at the window's ends."""
    from cgat_tpu_torch.data import collate, pad_to_bucket
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.models import CGATConfig, CGAtNet, init_state_dict

    cs.build_kernels()
    model = CGAtNet(CGATConfig(compute_dtype="bfloat16"))
    model.load_state_dict(init_state_dict(model, seed=0), strict=True)
    model = model.to_compute_dtype().to("cuda").eval()
    graphs = random_graphs(0, cs.N_GRAPHS, n_atoms_range=(8, 16),
                           max_nbr=24, full_degree=True)
    n = pad_to_bucket(sum(g.n_atoms for g in graphs), 64)
    batch = collate(graphs, num_graphs=cs.N_GRAPHS, num_node_slots=n,
                    num_edge_slots=n * 24, num_comp_slots=8, max_nbr=24,
                    orig_fea=200).to(torch.device("cuda"))

    def forward():
        with torch.inference_mode():
            model(batch)

    forward()
    want = {k: round(3 * v) for k, v in
            cs.kernel_events(cs.device_ms(forward, 1)).items()}
    lost = {"bare": 0, "primer and pause": 0}
    events = {k: set() for k in lost}
    for _ in range(WINDOW_PROFILES):
        for kind, window in zip(lost, ({"pad_s": 0.0, "primer": 0}, {})):
            prof = cs.device_ms(forward, 3, **window)
            got = {k: round(3 * v) for k, v in cs.kernel_events(prof).items()}
            lost[kind] += got != want
            events[kind].add(round(3 * sum(v[1] for v in prof.values())))
    for kind in lost:
        print(f"[variants] profiler_window {kind}: {lost[kind]} of "
              f"{WINDOW_PROFILES} profiles of 3 eager forwards lost kernel "
              f"events (want { {k: v for k, v in want.items() if v} }); "
              f"device events a profile "
              f"{sorted(events[kind])}", flush=True)


def run_study(study: str) -> None:
    """Check each variant that computes the function, then time all in
    mirrored turns."""
    source, variants, checked, check, timed = STUDIES[study]
    libs = build_all(variants(), source)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        if checked(name):
            use(lib, source, name)
            check(name, gen)
    fns = timed(gen)
    order = list(libs) + list(libs)[::-1]
    for name in order:
        use(libs[name], source, name)
        for label, fn in fns.items():
            ms = cs.time_ms(fn)
            split = cs.kernel_device_ms(fn, split=True)
            parts = ", ".join(
                f"{v:.4f} ms {k.split('(')[0].replace('void ', '')[:64]}"
                for k, v in split.items())
            print(f"[variants] {study} {name}{label}: device "
                  f"{sum(split.values()):.4f} ms ({parts}); events "
                  f"{ms:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 1
    study = sys.argv[1] if len(sys.argv) > 1 else "mh_network"
    if study == "hyper_apply_timeline":
        fwd_timeline()
    elif study == "profiler_window":
        profiler_window()
    elif study == "segment_attention":
        sa_study()
    elif study in STUDIES:
        run_study(study)
    else:
        print(f"chip_variants: no study {study!r}; one of "
              f"{[*STUDIES, 'segment_attention', 'hyper_apply_timeline',
                   'profiler_window']}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
