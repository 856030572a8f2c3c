"""Fused hypernetwork predict + apply: CUDA kernel wrappers, their plain
PyTorch versions and the autograd Function that joins them.

Counterpart of ``cgat_tpu/ops/pallas/hyper_apply.py``. With ``k`` the last
hypernetwork Linear's weight (O*I + O, C) and ``bias`` its bias::

    P = bf16(hidden @ k^T + bias)                       (B, O*I + O)
    out[b, o] = bf16(sum_i P[b, o*I + i] * x[b, i] + P[b, O*I + o])

with f32 products and sums. The backward, for the cotangent g (B, O), has
``dP[b, o*I + i] = g[b, o] * x[b, i]`` (rounded to the io dtype) and
``dP[b, O*I + o] = g[b, o]``::

    dh = bf16(dP @ k)        dx[b, i] = bf16(sum_o bf16(g[b, o] * P[b, o*I + i]))
    dk = dP^T @ hidden       dbias = sum_b dP

The kernels are in ``cgat_tpu_torch/csrc/hyper_apply.cu``; none writes P or
dP to device memory (the backward recomputes P from k and builds dP from g
and x in registers). The forward and the dh/dx kernel each run units that
:func:`fwd_plan` and :func:`bwd_plan` make on the host, in one persistent
launch on the same mainloop; the dK kernel is one persistent GEMM
dP^T @ hidden. The bias-tail rows of dk and dbias are plain torch sums, as
the JAX package computes them outside Pallas. CPU tensors go through the
plain versions; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SMEM_LIMIT = 232448  # shared memory one H100 block may use
TILE = 128           # rows and columns of a unit's or a dK tile
PER_MAX = 32         # outputs of a forward unit at most (fwd::PER_MAX)


def gate_bytes(c_dim: int, in_ch: int) -> int:
    """The gate's width limit, kept from the first forward design, whose
    blocks staged 64 rows of hidden and x in shared memory: C + I at most
    1,432. No kernel needs it any more (each takes a fixed amount: 150,080
    bytes the forward, 199,264 dh/dx, 203,872 dK, all of any width), but
    the gate keeps these widths so that the widths all three kernels take
    and are tested at stay as they were."""
    return (8 * 16 * 20 * 4 + 8 * 64 * 16 * 4 + 64 * 16 * 4
            + 64 * (c_dim + 8) * 2 + 64 * (in_ch + 8) * 2)


def supported(hidden_dim: int, in_ch: int, out_ch: int, dtype) -> bool:
    """Whether the kernels take these widths: bf16, 16-multiple widths (the
    tensor-core fragment), and C + I within :func:`gate_bytes`' limit. The
    three kernels take the same widths."""
    return (dtype == torch.bfloat16 and hidden_dim % 16 == 0
            and in_ch % 16 == 0 and out_ch % 16 == 0 and out_ch > 0
            and gate_bytes(hidden_dim, in_ch) <= SMEM_LIMIT)


@functools.cache
def _entry(symbol, n_ptr_in, n_int, n_ptr_out):
    p = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("hyper_apply", symbol,
                       [p] * n_ptr_in + [i] * n_int + [p] * n_ptr_out + [p])


def hyper_apply_plain(hidden, k, bias, x, out_ch):
    """The kernel's function in plain torch ops (f32 products and sums,
    bf16-rounded predicted parameters, output in ``hidden``'s dtype)."""
    b, in_ch = x.shape
    w = out_ch * in_ch
    p = (hidden.float() @ k.float().T + bias.float()).to(hidden.dtype).float()
    y = torch.einsum("boi,bi->bo", p[:, :w].reshape(b, out_ch, in_ch),
                     x.float())
    return (y + p[:, w:]).to(hidden.dtype)


def _check(hidden, x, out_ch, **others):
    """Validate the kernels' inputs; ``others`` maps further input names to
    ``(tensor, expected shape)``. Returns (B, C, I)."""
    n, c_dim = hidden.shape
    in_ch = x.shape[1]
    if not supported(c_dim, in_ch, out_ch, hidden.dtype):
        raise ValueError(f"hyper_apply kernel does not take C={c_dim} "
                         f"I={in_ch} O={out_ch} {hidden.dtype}")
    want = {"hidden": (hidden, (n, c_dim)), "x": (x, (n, in_ch)), **others}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != hidden.device or t.dtype != hidden.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; hidden is "
                             f"{hidden.dtype} on {hidden.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte aligned")
    return n, c_dim, in_ch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_plan(n_rows: int, c_dim: int, in_ch: int, out_ch: int,
             sms: int) -> dict:
    """How the forward kernel cuts its work, planned on the host: 128-row
    tiles of B, and the O outputs cut into groups of consecutive outputs,
    at most ``PER_MAX`` a group, about enough units (row tile, group) for
    one wave of ``sms`` SMs and no group empty: ``groups`` is (groups,
    outputs per group). A unit runs each of its outputs over every
    128-column tile of I (``x_tiles``)."""
    m_tiles = _cdiv(n_rows, TILE)
    want = max(1, min(out_ch, sms // max(1, m_tiles)))
    per = min(PER_MAX, _cdiv(out_ch, want))
    return {"m_tiles": m_tiles, "x_tiles": _cdiv(in_ch, TILE),
            "groups": (_cdiv(out_ch, per), per)}


def hyper_apply(hidden, k, bias, x, out_ch):
    """hidden (B, C); k (O*I + O, C); bias (O*I + O,); x (B, I).
    Returns (B, O) in ``hidden``'s dtype."""
    if hidden.device.type == "cpu":
        return hyper_apply_plain(hidden, k, bias, x, out_ch)
    f = out_ch * x.shape[1] + out_ch
    n, c_dim, in_ch = _check(hidden, x, out_ch, k=(k, (f, hidden.shape[1])),
                             bias=(bias, (f,)))
    dev = hidden.device
    groups, per = fwd_plan(n, c_dim, in_ch, out_ch,
                           build.sm_count(dev.index))["groups"]
    out = torch.empty((n, out_ch), dtype=hidden.dtype, device=dev)
    code = build.run(_entry("cgat_hyper_apply_fwd", 5, 6, 0), dev,
                     hidden.data_ptr(), k.data_ptr(), bias.data_ptr(),
                     x.data_ptr(), out.data_ptr(), n, c_dim, in_ch, out_ch,
                     groups, per, rows=n)
    build.check("hyper_apply", code)
    hyper_apply.launches += 1
    return out


hyper_apply.launches = 0


def _dp_w(g, x):
    """dP's weight columns: dP[b, o*I + i] = g[b, o] * x[b, i], rounded to
    the io dtype as the TPU kernels' bf16 products are."""
    b, in_ch = x.shape
    return (g[:, :, None] * x[:, None, :]).reshape(b, -1)


def hyper_apply_bwd_dhdx_plain(hidden, k, bias, x, g, out_ch):
    """The dh/dx kernel's function in plain torch ops: (dh, dx) in the io
    dtype, P recomputed from k."""
    b, in_ch = x.shape
    w = out_ch * in_ch
    p = (hidden.float() @ k.float().T + bias.float()).to(hidden.dtype)
    dp = torch.cat([_dp_w(g, x), g], dim=1)
    dh = (dp.float() @ k.float()).to(hidden.dtype)
    t = g[:, :, None] * p[:, :w].reshape(b, out_ch, in_ch)
    return dh, t.float().sum(1).to(x.dtype)


def bwd_plan(n_rows: int, c_dim: int, in_ch: int, out_ch: int,
             sms: int) -> dict:
    """How the dh/dx kernel cuts its work, planned on the host: 128-row
    tiles of B, 128-column tiles of I (dx units) and of C (dh units), and
    the O outputs cut into groups of consecutive outputs, about enough
    units for one wave of ``sms`` SMs and no group empty: ``groups`` is
    (groups, outputs per group). Each group's units write one f32 partial
    plane of dx, (groups, B, I), and one of dh, (groups, B, C)."""
    m_tiles = _cdiv(n_rows, TILE)
    x_tiles, h_tiles = _cdiv(in_ch, TILE), _cdiv(c_dim, TILE)
    want = max(1, min(out_ch, sms // max(1, m_tiles * (x_tiles + h_tiles))))
    per = _cdiv(out_ch, want)
    return {"m_tiles": m_tiles, "x_tiles": x_tiles, "h_tiles": h_tiles,
            "groups": (_cdiv(out_ch, per), per)}


def hyper_apply_bwd_dhdx(hidden, k, bias, x, g, out_ch):
    """dh (B, C) and dx (B, I) of :func:`hyper_apply` for the cotangent
    g (B, O)."""
    if hidden.device.type == "cpu":
        return hyper_apply_bwd_dhdx_plain(hidden, k, bias, x, g, out_ch)
    f = out_ch * x.shape[1] + out_ch
    n, c_dim, in_ch = _check(hidden, x, out_ch, k=(k, (f, hidden.shape[1])),
                             bias=(bias, (f,)), g=(g, (hidden.shape[0], out_ch)))
    dev = hidden.device
    plan = bwd_plan(n, c_dim, in_ch, out_ch, build.sm_count(dev.index))
    groups, per = plan["groups"]
    part_dx = torch.empty((groups, n, in_ch), dtype=torch.float32,
                          device=dev)
    part_dh = torch.empty((groups, n, c_dim), dtype=torch.float32,
                          device=dev)
    dh = torch.empty_like(hidden)
    dx = torch.empty_like(x)
    code = build.run(_entry("cgat_hyper_apply_bwd_dhdx", 5, 6, 4), dev,
                     hidden.data_ptr(), k.data_ptr(), bias.data_ptr(),
                     x.data_ptr(), g.data_ptr(), n, c_dim, in_ch, out_ch,
                     groups, per, part_dx.data_ptr(),
                     part_dh.data_ptr(), dh.data_ptr(), dx.data_ptr(),
                     rows=n)
    build.check("hyper_apply", code)
    hyper_apply_bwd_dhdx.launches += 1
    return dh, dx


hyper_apply_bwd_dhdx.launches = 0


def hyper_apply_bwd_dk_plain(hidden, x, g, out_ch):
    """The dK kernel's function in plain torch ops: the weight rows of dk
    (O*I, C) in the io dtype and of dbias (O*I,) in f32."""
    dp = _dp_w(g, x).float()
    return (dp.T @ hidden.float()).to(hidden.dtype), dp.sum(0)


def hyper_apply_bwd_dk(hidden, x, g, out_ch):
    """dk's and dbias' weight rows of :func:`hyper_apply` for the cotangent
    g (B, O): (O*I, C) in the io dtype and (O*I,) f32."""
    if hidden.device.type == "cpu":
        return hyper_apply_bwd_dk_plain(hidden, x, g, out_ch)
    n, c_dim, in_ch = _check(hidden, x, out_ch,
                             g=(g, (hidden.shape[0], out_ch)))
    dk = torch.empty((out_ch * in_ch, c_dim), dtype=hidden.dtype,
                     device=hidden.device)
    db = torch.empty((out_ch * in_ch,), dtype=torch.float32,
                     device=hidden.device)
    code = build.run(_entry("cgat_hyper_apply_bwd_dk", 3, 4, 2),
                     hidden.device, hidden.data_ptr(), x.data_ptr(),
                     g.data_ptr(), n, c_dim, in_ch, out_ch, dk.data_ptr(),
                     db.data_ptr(), rows=n)
    build.check("hyper_apply", code)
    hyper_apply_bwd_dk.launches += 1
    return dk, db


hyper_apply_bwd_dk.launches = 0


class HyperApply(torch.autograd.Function):
    """:func:`hyper_apply` with the dh/dx and dK kernels as its backward."""

    @staticmethod
    def forward(ctx, hidden, k, bias, x, out_ch):
        ctx.save_for_backward(hidden, k, bias, x)
        ctx.out_ch = out_ch
        return hyper_apply(hidden, k, bias, x, out_ch)

    @staticmethod
    def backward(ctx, g):
        hidden, k, bias, x = ctx.saved_tensors
        g = g.contiguous()
        dh, dx = hyper_apply_bwd_dhdx(hidden, k, bias, x, g, ctx.out_ch)
        dk_w, db_w = hyper_apply_bwd_dk(hidden, x, g, ctx.out_ch)
        # the predicted-bias tail: dP[:, O*I:] is g itself
        dk_b = (g.float().T @ hidden.float()).to(k.dtype)
        db = torch.cat([db_w, g.float().sum(0)]).to(bias.dtype)
        return dh, torch.cat([dk_w, dk_b]), db, dx, None


def hyper_apply_op(hidden, k, bias, x, out_ch):
    """:func:`hyper_apply` through the autograd Function when a gradient is
    wanted, else the plain launch."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (hidden, k, bias, x)):
        return HyperApply.apply(hidden, k, bias, x, out_ch)
    return hyper_apply(hidden, k, bias, x, out_ch)
