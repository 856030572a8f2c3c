#!/usr/bin/env python3
"""Time variants of the ``mh_network`` forward kernel on one CUDA card.

    python3 chip_variants.py

Builds the forward's source (``cgat_tpu_torch/csrc/mh_network.cu``) as it
is and three variants of its epilogue, each from a patched copy under
``build/variants/``, then times each at the serving shape of the
reference-default model (E = 19,968 edge rows, cat 384, hid 256, 5 heads,
F 128; seeded random bf16 inputs), in turns (each variant twice, in
mirrored order), by its device time per kernel (profiler) and CUDA events.
Every variant that stores is first held against the plain version on
ragged shapes and at that one, forward and backward. The variants:

- ``committed``: the source as it is (16-byte stores from quad shuffles);
- ``pairs``: one 4-byte store per bf16 pair, as fragments lie in registers;
- ``no_store``: no output stored: the mainloop and epilogue arithmetic
  alone, a floor for what the stores cost (its outputs are garbage);
- ``tma_store``: the epilogue writes a swizzled tile buffer that TMA
  stores while the next tile runs (the mainloop's tile buffers, made
  store-only).

Needs nvcc and a Hopper card; prints one line per run and the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from cgat_tpu_torch.ops.kernels import build
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


def sources() -> dict[str, dict[str, str]]:
    """Each variant's csrc files that differ from the committed ones."""
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
    tma = patch(tma, "// Epilogue of step 1 (dpre of head z)",
                TILE_EPI + "// Epilogue of step 1 (dpre of head z)")
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


def build_all(variants) -> dict[str, Path]:
    """One nvcc per variant, all started together."""
    procs = {}
    for name, files in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for src in build.CSRC.iterdir():
            if src.suffix in (".cu", ".cuh"):
                (d / src.name).write_text(files.get(src.name,
                                                    src.read_text()))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "mh_network.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"chip_variants: {name} did not build\n{log}")
        libs[name] = lib
    return libs


def use(lib: Path) -> None:
    """Make the wrappers launch the kernels of library ``lib``."""
    cdll = ctypes.CDLL(str(lib))
    cdll.cgat_error_string.argtypes = [ctypes.c_int]
    cdll.cgat_error_string.restype = ctypes.c_char_p
    build._loaded["mh_network"] = cdll
    mk._fwd.cache_clear()
    mk._bwd.cache_clear()


def inputs(gen, rows, cat, hid, f, heads):
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * scale).bfloat16()
    return (r(rows, cat), r(heads * hid, cat, scale=cat ** -0.5),
            r(heads * hid, scale=0.1), r(heads * f, hid, scale=hid ** -0.5),
            r(heads * f, scale=0.1), heads)


def check(name, gen) -> None:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 1
    libs = build_all(sources())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        if name != "no_store":
            use(lib)
            check(name, gen)
    args = inputs(gen, *SHAPE)
    order = list(libs) + list(libs)[::-1]
    for name in order:
        use(libs[name])
        ms = cs.time_ms(lambda: mk.mh_network(*args))
        split = cs.kernel_device_ms(lambda: mk.mh_network(*args), split=True)
        parts = ", ".join(f"{v:.4f} ms {k.split('(')[0][22:]}"
                          for k, v in split.items())
        print(f"[variants] {name}: device {sum(split.values()):.4f} ms "
              f"({parts}); events {ms:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
