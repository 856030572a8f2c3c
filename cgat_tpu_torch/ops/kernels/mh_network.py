"""Head-parallel MLP (MultiHeadNetwork flat path): CUDA kernel wrappers,
their plain PyTorch versions and the autograd Function that joins them.

Counterpart of ``cgat_tpu/ops/pallas/mh_network.py``. For x (E, cat) and
each head k::

    h_k = bf16(leaky_relu(x @ Win_k^T + b_in_k, 0.01))
    out[:, k*F:(k+1)*F] = bf16(h_k @ Wout_k^T + b_out_k)

with ``win`` (H*hid, cat) and ``wout`` (H*F, hid) in the reference's grouped
Conv1d layout (a ``(H*out, in, 1)`` weight viewed as 2-D). The backward
takes the saved flat ``h`` (the leaky-ReLU mask is its sign) and the
cotangent ``g`` (E, H*F)::

    dpre = where(h > 0, g_k @ Wout_k, 0.01 * g_k @ Wout_k)      (E, H*hid)
    dx = bf16(bf16(dpre) @ Win)        dWin = bf16(dpre)^T @ x
    dWout_k = g_k^T @ h_k              db_in = sum(dpre)    db_out = sum(g)

with f32 products and sums, as ``_bwd_kernel`` computes them. The kernels
are in ``cgat_tpu_torch/csrc/mh_network.cu``. CPU tensors go through the
plain versions; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

LEAKY_SLOPE = 0.01
# The widest cat + hid the kernels take: the limit the port has always
# taken, from its first forward design (64-row tiles of x and h and a
# scratch in one block's 232,448 bytes of shared memory). The GEMM kernels
# take a fixed amount whatever the widths (``sm90::smem_bytes`` in
# ``csrc/gemm_sm90.cuh``: 144,480 bytes, 210,016 for the backward's dpre
# GEMM), so wider layers would fit them; the gate is unchanged until a
# test holds the kernels at those widths.
MAX_CAT_PLUS_HID = 1720
# The GEMM tiling, sm90::BM and sm90::BK of csrc/gemm_sm90.cuh:
# the library refuses a plan (bwd_plan) made with other values.
TILE = 128      # output tile (rows and columns) of the backward's GEMMs
K_STEP = 64     # rows a backward GEMM stage loads; splits are multiples
MIN_SPLIT = 1024  # rows of a weight-grad split, at least


def supported(cat: int, hid: int, out: int, heads: int, dtype) -> bool:
    """Whether the kernels take these widths: bf16, 16-multiple widths (the
    tensor-core step), and cat + hid within ``MAX_CAT_PLUS_HID``. The
    backward kernels take every width the forward takes."""
    return (dtype == torch.bfloat16 and heads > 0 and cat % 16 == 0
            and hid % 16 == 0 and out % 16 == 0
            and cat + hid <= MAX_CAT_PLUS_HID)


@functools.cache
def _fwd():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("mh_network", "cgat_mh_network_fwd",
                       [p, p, p, p, p, p, p, i, i, i, i, i, p])


@functools.cache
def _bwd():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("mh_network", "cgat_mh_network_bwd",
                       [p, p, p, p, p, i, i, i, i, i,
                        p, p, i, p, p, i, i, p, i, i, p, p, p, p, p, p])


def mh_network_plain(x, win, b_in, wout, b_out, heads, *,
                     return_hidden=False):
    """The kernel's function in plain torch ops (f32 products, bf16-rounded
    hidden activation, output in the input dtype). ``return_hidden`` also
    returns the flat hidden activation ``h`` (E, H*hid) the backward needs."""
    n, _ = x.shape
    hid = win.shape[0] // heads
    f = wout.shape[0] // heads
    p = x.float() @ win.float().T + b_in.float()
    h = torch.where(p > 0, p, LEAKY_SLOPE * p).to(x.dtype)
    o = torch.einsum("ehj,hfj->ehf", h.float().view(n, heads, hid),
                     wout.float().view(heads, f, hid))
    o = (o + b_out.float().view(heads, f)).reshape(n, heads * f).to(x.dtype)
    return (o, h) if return_hidden else o


def _check(x, win, wout, heads, **others):
    """Validate the kernels' inputs; ``others`` maps further input names to
    ``(tensor, expected shape)``. Returns (E, cat, hid, F)."""
    n, cat = x.shape
    hid = win.shape[0] // heads
    f = wout.shape[0] // heads
    if not supported(cat, hid, f, heads, x.dtype):
        raise ValueError(f"mh_network kernel does not take cat={cat} "
                         f"hid={hid} F={f} heads={heads} {x.dtype}")
    want = {"x": (x, (n, cat)), "win": (win, (heads * hid, cat)),
            "wout": (wout, (heads * f, hid)), **others}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte aligned")
    return n, cat, hid, f


def mh_network(x, win, b_in, wout, b_out, heads, *, return_hidden=False):
    """x (E, cat); win (H*hid, cat); b_in (H*hid,); wout (H*F, hid);
    b_out (H*F,). Returns (E, H*F), head-major; with ``return_hidden`` also
    the flat bf16 hidden activation (E, H*hid). The kernel writes h between
    its two products either way; without ``return_hidden`` it is scratch."""
    if x.device.type == "cpu":
        return mh_network_plain(x, win, b_in, wout, b_out, heads,
                                return_hidden=return_hidden)
    n, cat, hid, f = _check(x, win, wout, heads,
                            b_in=(b_in, (win.shape[0],)),
                            b_out=(b_out, (wout.shape[0],)))
    out = torch.empty((n, heads * f), dtype=x.dtype, device=x.device)
    h = torch.empty((n, heads * hid), dtype=x.dtype, device=x.device)
    code = build.run(_fwd(), x.device, x.data_ptr(), win.data_ptr(),
                     b_in.data_ptr(), wout.data_ptr(), b_out.data_ptr(),
                     out.data_ptr(), h.data_ptr(), n, cat, hid, f, heads)
    build.check("mh_network", code)
    mh_network.launches += 1
    return (out, h) if return_hidden else out


mh_network.launches = 0


def mh_network_bwd_plain(x, h, g, win, wout, heads):
    """The backward kernel's function in plain torch ops, in the style of
    ``_xla_bwd``: returns (dx, dwin, db_in, dwout, db_out), the weight grads
    rounded from f32 to the weights' dtype."""
    n = x.shape[0]
    hid = win.shape[0] // heads
    f = wout.shape[0] // heads
    g3 = g.float().view(n, heads, f)
    h3 = h.float().view(n, heads, hid)
    dh = torch.einsum("ehf,hfj->ehj", g3,
                      wout.float().view(heads, f, hid)).reshape(n, -1)
    dpre = torch.where(h.float() > 0, dh, LEAKY_SLOPE * dh)
    dpre_b = dpre.to(x.dtype).float()
    dx = (dpre_b @ win.float()).to(x.dtype)
    dwin = dpre_b.T @ x.float()
    dwout = torch.einsum("ehf,ehj->hfj", g3, h3).reshape(heads * f, hid)
    return (dx, dwin.to(win.dtype), dpre.sum(0).to(win.dtype),
            dwout.to(wout.dtype), g3.sum(0).reshape(-1).to(wout.dtype))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_plan(n_rows: int, cat: int, hid: int, f: int, heads: int,
             sms: int) -> dict:
    """How the backward kernel cuts its work, planned on the host: the
    128-row tiles of the row products (dpre, dx), whose bias partials the
    reduce adds, and the E-row splits of the two weight-grad products. A
    split is a multiple of 64 rows and, where E allows, at least 1024;
    there are about enough of them for one wave of ``sms`` SMs, and none is
    empty. ``win`` and ``wout`` are (splits, rows per split)."""
    def split(out_tiles):
        want = max(1, min(sms // out_tiles, n_rows // MIN_SPLIT))
        rows = _cdiv(_cdiv(max(n_rows, 1), want), K_STEP) * K_STEP
        return _cdiv(max(n_rows, 1), rows), rows
    return {"tiles": _cdiv(n_rows, TILE),
            "win": split(_cdiv(heads * hid, TILE) * _cdiv(cat, TILE)),
            "wout": split(heads * _cdiv(f, TILE) * _cdiv(hid, TILE))}


def mh_network_bwd(x, h, g, win, wout, heads):
    """Gradients of :func:`mh_network`: (dx, dwin, db_in, dwout, db_out)
    from x (E, cat), the saved h (E, H*hid) and the cotangent g (E, H*F)."""
    if x.device.type == "cpu":
        return mh_network_bwd_plain(x, h, g, win, wout, heads)
    n, cat, hid, f = _check(x, win, wout, heads,
                            h=(h, (x.shape[0], win.shape[0])),
                            g=(g, (x.shape[0], wout.shape[0])))
    dev, dt = x.device, x.dtype
    plan = bwd_plan(n, cat, hid, f, heads, build.sm_count(dev.index))
    (s_win, r_win), (s_wout, r_wout) = plan["win"], plan["wout"]
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((n, cat), dtype=dt, device=dev)
    dpre = torch.empty((n, heads * hid), dtype=dt, device=dev)
    part_bin = torch.empty((plan["tiles"], heads * hid), **f32)
    part_bout = torch.empty((plan["tiles"], heads * f), **f32)
    part_win = torch.empty((s_win, heads * hid, cat), **f32)
    part_wout = torch.empty((s_wout, heads * f, hid), **f32)
    dwin = torch.empty_like(win)
    dbin = torch.empty((heads * hid,), dtype=dt, device=dev)
    dwout = torch.empty_like(wout)
    dbout = torch.empty((heads * f,), dtype=dt, device=dev)
    code = build.run(_bwd(), dev, x.data_ptr(), h.data_ptr(), g.data_ptr(),
                     win.data_ptr(), wout.data_ptr(), n, cat, hid, f, heads,
                     dx.data_ptr(), dpre.data_ptr(), plan["tiles"],
                     part_bin.data_ptr(), part_bout.data_ptr(),
                     s_win, r_win, part_win.data_ptr(), s_wout, r_wout,
                     part_wout.data_ptr(), dwin.data_ptr(), dbin.data_ptr(),
                     dwout.data_ptr(), dbout.data_ptr())
    build.check("mh_network", code)
    mh_network_bwd.launches += 1
    return dx, dwin, dbin, dwout, dbout


mh_network_bwd.launches = 0


class MHNetwork(torch.autograd.Function):
    """:func:`mh_network` with :func:`mh_network_bwd` as its backward; the
    forward writes the hidden activation for it."""

    @staticmethod
    def forward(ctx, x, win, b_in, wout, b_out, heads):
        out, h = mh_network(x, win, b_in, wout, b_out, heads,
                            return_hidden=True)
        ctx.save_for_backward(x, h, win, wout)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, g):
        x, h, win, wout = ctx.saved_tensors
        grads = mh_network_bwd(x, h, g.contiguous(), win, wout, ctx.heads)
        return (*grads, None)


def mh_network_op(x, win, b_in, wout, b_out, heads):
    """:func:`mh_network` through the autograd Function when a gradient is
    wanted, else the plain launch (no hidden activation written)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, win, b_in, wout, b_out)):
        return MHNetwork.apply(x, win, b_in, wout, b_out, heads)
    return mh_network(x, win, b_in, wout, b_out, heads)
