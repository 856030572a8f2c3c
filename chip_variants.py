#!/usr/bin/env python3
"""Time variants of one of the port's kernels on one CUDA card.

    python3 chip_variants.py [mh_network | hyper_apply_bwd_dk |
                              mh_network_bwd]

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

OUT = Path(__file__).resolve().parent / "build" / "variants"
SHAPE = (19968, 384, 256, 128, 5)      # E, cat, hid, F, heads
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


# per study: its source, its variants, which of them are held against the
# plain version, how, and the calls to time (by label)
STUDIES = {
    "mh_network": ("mh_network", mh_sources, lambda v: v != "no_store",
                   mh_check, mh_timed),
    "hyper_apply_bwd_dk": ("hyper_apply", dk_sources,
                           lambda v: v in DK_RIGHT, dk_check, dk_timed),
    "mh_network_bwd": ("mh_network", bwd_sources, lambda v: v in BWD_RIGHT,
                       bwd_check, bwd_timed),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 1
    study = sys.argv[1] if len(sys.argv) > 1 else "mh_network"
    if study not in STUDIES:
        print(f"chip_variants: no study {study!r}; one of {list(STUDIES)}",
              file=sys.stderr)
        return 2
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
