"""Head-parallel MLP (MultiHeadNetwork flat path): CUDA kernel wrapper and
its plain PyTorch version.

Counterpart of the forward of ``cgat_tpu/ops/pallas/mh_network.py``. For
x (E, cat) and each head k::

    h_k = bf16(leaky_relu(x @ Win_k^T + b_in_k, 0.01))
    out[:, k*F:(k+1)*F] = bf16(h_k @ Wout_k^T + b_out_k)

with ``win`` (H*hid, cat) and ``wout`` (H*F, hid) in the reference's grouped
Conv1d layout (a ``(H*out, in, 1)`` weight viewed as 2-D). The kernel is
``cgat_tpu_torch/csrc/mh_network.cu``. CPU tensors go through
:func:`mh_network_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

LEAKY_SLOPE = 0.01
SMEM_LIMIT = 232448  # shared memory one H100 block may use


def smem_bytes(cat: int, hid: int) -> int:
    """Shared memory of one block (mirrors ``smem_bytes`` in the .cu):
    per-warp scratch + 64-row x and hidden tiles, rows padded by 8."""
    return 8 * 16 * 20 * 4 + 64 * (cat + 8) * 2 + 64 * (hid + 8) * 2


def supported(cat: int, hid: int, out: int, heads: int, dtype) -> bool:
    """Whether the kernel takes these widths: bf16, 16-multiple widths (the
    tensor-core fragment), and tiles that fit one block's shared memory."""
    return (dtype == torch.bfloat16 and heads > 0 and cat % 16 == 0
            and hid % 16 == 0 and out % 16 == 0
            and smem_bytes(cat, hid) <= SMEM_LIMIT)


@functools.cache
def _fwd():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("mh_network", "cgat_mh_network_fwd",
                       [p, p, p, p, p, p, i, i, i, i, i, p])


def mh_network_plain(x, win, b_in, wout, b_out, heads):
    """The kernel's function in plain torch ops (f32 products, bf16-rounded
    hidden activation, output in the input dtype)."""
    n, _ = x.shape
    hid = win.shape[0] // heads
    f = wout.shape[0] // heads
    p = x.float() @ win.float().T + b_in.float()
    h = torch.where(p > 0, p, LEAKY_SLOPE * p).to(x.dtype).float()
    o = torch.einsum("ehj,hfj->ehf", h.view(n, heads, hid),
                     wout.float().view(heads, f, hid))
    o = o + b_out.float().view(heads, f)
    return o.reshape(n, heads * f).to(x.dtype)


def mh_network(x, win, b_in, wout, b_out, heads):
    """x (E, cat); win (H*hid, cat); b_in (H*hid,); wout (H*F, hid);
    b_out (H*F,). Returns (E, H*F), head-major."""
    if x.device.type == "cpu":
        return mh_network_plain(x, win, b_in, wout, b_out, heads)
    n, cat = x.shape
    hid = win.shape[0] // heads
    f = wout.shape[0] // heads
    if not supported(cat, hid, f, heads, x.dtype):
        raise ValueError(f"mh_network kernel does not take cat={cat} "
                         f"hid={hid} F={f} heads={heads} {x.dtype}")
    shapes = {"win": (heads * hid, cat), "b_in": (heads * hid,),
              "wout": (heads * f, hid), "b_out": (heads * f,)}
    for name, t in (("x", x), ("win", win), ("b_in", b_in), ("wout", wout),
                    ("b_out", b_out)):
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte aligned")
    out = torch.empty((n, heads * f), dtype=x.dtype, device=x.device)
    code = _fwd()(x.data_ptr(), win.data_ptr(), b_in.data_ptr(),
                  wout.data_ptr(), b_out.data_ptr(), out.data_ptr(), n, cat,
                  hid, f, heads, torch.cuda.current_stream(x.device).cuda_stream)
    build.check("mh_network", code)
    mh_network.launches += 1
    return out


mh_network.launches = 0
