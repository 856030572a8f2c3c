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
# scratch in one block's 232,448 bytes of shared memory). The kernels take a
# fixed amount whatever the widths (``csrc/mh_network.cu``: the forward's
# GEMMs 144,480 bytes, the backward's pass A 167,984 and pass B 197,728, and
# 210,016 for the dpre GEMM that takes F > 128), so wider layers would fit
# them; the gate is unchanged until a test holds the kernels at those
# widths.
MAX_CAT_PLUS_HID = 1720
# The backward's tiling, sm90::BM and sm90::BK of csrc/gemm_sm90.cuh: the
# library refuses a plan (bwd_plan) made with other values.
TILE = 128      # output tile (rows and columns), and pass A's E tile
K_STEP = 64     # rows a GEMM stage loads; splits are multiples
MIN_SPLIT = 1024  # rows of a dWout split where F > 128, at least


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
                       [p, p, p, p, p, i, i, i, i, i, p,
                        p, p, p, p, p, p, p, p, p, p, p])


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
    return (out, h) if return_hidden else out


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


def _spread(n_w: int, w_len: int, x_tiles: int, x_len: int,
            blocks: int) -> tuple[int, tuple[int, int, int, int]]:
    """Pass B's dx tiles over ``blocks`` blocks: block b runs dWin units
    b, b + blocks, ... (``n_w`` of them, ``w_len`` k-blocks long), so the
    first ``n_w % blocks`` blocks run one more; of the dx tiles (``x_len``
    k-blocks) each of those takes ``a`` (+1 for the first ``ra``) and each
    other block ``c`` (+1 for the first ``rc``), dealt out in rounds.
    Returns the longest block's k-blocks and (a, ra, c, rc), the split
    between the two classes that makes it least."""
    q, n_a = divmod(n_w, blocks)
    n_b = blocks - n_a
    best = None
    for c_a in range(x_tiles + 1) if n_a else (0,):
        c_b = x_tiles - c_a
        if n_b == 0 and c_b:
            continue
        load = max((q + 1) * w_len + _cdiv(c_a, n_a) * x_len if n_a else 0,
                   q * w_len + _cdiv(c_b, n_b) * x_len if n_b else 0)
        if best is None or load < best[0]:
            a, ra = divmod(c_a, n_a) if n_a else (0, 0)
            c, rc = divmod(c_b, n_b) if n_b else (0, 0)
            best = (load, (a, ra, c, rc))
    return best


def bwd_plan(n_rows: int, cat: int, hid: int, f: int, heads: int,
             sms: int) -> dict:
    """How the backward kernel cuts its work, planned on the host for a
    card of ``sms`` SMs with the tiling ``TILE`` and ``K_STEP`` (read it, do
    not change it: it is cached).

    Pass A (``fused``, where F <= 128 fits its stages): units of (E range,
    head, 128 hid columns), the E tiles cut into ``wout`` = (ranges, rows
    a range) so that the units fill about one wave; each range writes one
    partial of dWout and of both bias sums (``bias_parts`` = ranges).
    Otherwise dpre's bias partials are per 128-row tile and dWout is split
    into ``wout`` = (splits, rows a split), multiples of 64 rows of at least
    ``MIN_SPLIT`` where E allows, about one wave.

    Pass B: dWin's 128 x 128 tiles, E cut into ``win`` = (splits, rows a
    split), and dx's 128 x 128 tiles on ``blocks`` blocks; ``dx`` = (a, ra,
    c, rc) deals the dx tiles out (:func:`_spread`). The split count is the
    one whose longest block (in 64-row k-blocks) is least, the fewest
    splits among equals. No range or split is empty."""
    return _plan(n_rows, cat, hid, f, heads, sms, f <= TILE, TILE, K_STEP)


@functools.cache
def _plan(n_rows, cat, hid, f, heads, sms, fused, tile, k_step):
    m_tiles = _cdiv(n_rows, tile)
    tiles, rows = max(m_tiles, 1), max(n_rows, 1)
    hh = heads * hid
    if fused:
        pairs = heads * _cdiv(hid, tile)
        per = _cdiv(tiles, max(1, min(tiles, sms // pairs)))
        wout = (_cdiv(tiles, per), per * tile)
        bias_parts = wout[0]
    else:
        out_tiles = heads * _cdiv(f, tile) * _cdiv(hid, tile)
        want = max(1, min(sms // out_tiles, n_rows // MIN_SPLIT))
        per = _cdiv(_cdiv(rows, want), k_step) * k_step
        wout = (_cdiv(rows, per), per)
        bias_parts = m_tiles
    w_tiles = _cdiv(hh, tile) * _cdiv(cat, tile)
    x_tiles = m_tiles * _cdiv(cat, tile)
    k_blocks, x_len = _cdiv(rows, k_step), _cdiv(hh, k_step)
    best = None
    for want in range(1, max(1, sms // w_tiles) + 1):
        per = _cdiv(k_blocks, want)
        splits = _cdiv(k_blocks, per)
        n_w = w_tiles * splits
        blocks = min(sms, n_w + x_tiles)
        longest, dx = _spread(n_w, per, x_tiles, x_len, blocks)
        if best is None or longest < best[0]:
            best = (longest, {"win": (splits, per * k_step),
                              "blocks": blocks, "dx": dx})
    return {"fused": fused, "bias_parts": bias_parts, "wout": wout,
            **best[1]}


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
    parts = plan["bias_parts"]
    # the order of the C entry's plan ints
    ints = (ctypes.c_int * 11)(int(plan["fused"]), parts, s_wout, r_wout,
                               s_win, r_win, plan["blocks"], *plan["dx"])
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((n, cat), dtype=dt, device=dev)
    dpre = torch.empty((n, heads * hid), dtype=dt, device=dev)
    part_bin = torch.empty((parts, heads * hid), **f32)
    part_bout = torch.empty((parts, heads * f), **f32)
    part_wout = torch.empty((s_wout, heads * f, hid), **f32)
    part_win = torch.empty((s_win, heads * hid, cat), **f32)
    dwin = torch.empty_like(win)
    dbin = torch.empty((heads * hid,), dtype=dt, device=dev)
    dwout = torch.empty_like(wout)
    dbout = torch.empty((heads * f,), dtype=dt, device=dev)
    code = build.run(_bwd(), dev, x.data_ptr(), h.data_ptr(), g.data_ptr(),
                     win.data_ptr(), wout.data_ptr(), n, cat, hid, f, heads,
                     ints, dx.data_ptr(), dpre.data_ptr(),
                     part_bin.data_ptr(), part_bout.data_ptr(),
                     part_wout.data_ptr(), part_win.data_ptr(),
                     dwin.data_ptr(), dbin.data_ptr(), dwout.data_ptr(),
                     dbout.data_ptr())
    build.check("mh_network", code)
    return dx, dwin, dbin, dwout, dbout


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
