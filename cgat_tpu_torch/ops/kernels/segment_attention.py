"""Segment softmax + weighted aggregation: CUDA kernel wrappers, their plain
PyTorch versions and the autograd Function that joins them.

Counterpart of ``cgat_tpu/ops/pallas/segment_attention.py``. For
destination-sorted edges with CSR pointers ``offn`` (clamped to the
real-edge count ``n_real``), per node ``n`` and column ``c``::

    out[n, c] = sum_{e -> n} exp(a[e,c] - max_n[c]) * m[e,c]
                / (sum_{e -> n} exp(a[e,c] - max_n[c]) + 1e-16)

and its backward, per real edge ``e -> n`` with ``q = g / (den + 1e-16)``::

    dm[e] = exp(a[e] - max_n) * q[n]      dalpha[e] = dm[e] * (m[e] - out[n])

(padded edges get 0), from the f32 per-node max and exp-sum the forward
returns. The kernels are in ``cgat_tpu_torch/csrc/segment_attention.cu``.
CPU tensors go through the plain versions; CUDA tensors launch the kernels
or raise. The forward has two kernels behind one entry point: the stream
kernel (a persistent grid, each block streaming the rows of the nodes that
start in its equal span of the real rows and writing its share of the
nodes with none, :func:`stream_spans`) for rows of
whole 16-byte groups on 16-byte aligned arrays (:func:`streams`), and the
per-node kernel for the rest. Both count under the entry point's name
(``build.launch_counts``); ``streams`` tells which one a call takes.

The pair path (:class:`SegmentAttentionPair`, the JAX package's
``_pair_fwd_impl`` / ``_pair_vjp_bwd``) is the same softmax over the union
of an edge-sharded batch's local and halo blocks with no kernel of its own:
the forward kernel on each block, an f32 flash merge of their (out, max,
den), and the backward kernel on each block against the merged node
arrays (exact: the backward holds for whatever shift the denominator
used). Either block may skip destinations; both kernels read each node's
rows through its own pointers or id, so a node without rows in a block
gets nothing from it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..segment import (NEG_BIG, SOFTMAX_EPS, segment_max,
                       segment_softmax_pair, segment_sum)
from . import build

_P = ctypes.c_void_p
# 16-byte column groups of a row the stream kernel takes at most
# (bulk::MAX_GROUPS in the source)
STREAM_MAX_GROUPS = 480


@functools.cache
def _fwd():
    return build.entry("segment_attention", "cgat_segment_attention_fwd",
                       [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _P, _P, _P, _P])


@functools.cache
def _bwd():
    return build.entry("segment_attention", "cgat_segment_attention_bwd",
                       [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P, _P, _P])


def _segments(offn, n_real, num_nodes, n_rows):
    """Per-row segment ids and validity from clamped CSR pointers."""
    off = torch.clamp(offn[:num_nodes + 1].long(), max=int(n_real))
    counts = off[1:] - off[:-1]
    ids = torch.full((n_rows,), num_nodes - 1, dtype=torch.long,
                     device=offn.device)
    covered = int(off[-1] - off[0])
    ids[int(off[0]):int(off[-1])] = torch.repeat_interleave(
        torch.arange(num_nodes, device=offn.device), counts,
        output_size=covered)
    rows = torch.arange(n_rows, device=offn.device)
    valid = (rows >= off[0]) & (rows < off[-1])
    return ids, valid


def streams(hf: int, element_size: int, *tensors) -> bool:
    """Whether the forward's entry point takes the stream kernel for rows
    of ``hf`` elements of ``element_size`` bytes and these arrays (None
    for an output not asked for): rows of whole 16-byte groups, at most
    ``STREAM_MAX_GROUPS`` of them, every array 16-byte aligned."""
    row = hf * element_size
    addr = 0
    for t in tensors:
        if t is not None:
            addr |= t.data_ptr()
    return row % 16 == 0 and row // 16 <= STREAM_MAX_GROUPS \
        and addr % 16 == 0


def stream_spans(offn, n_real, num_nodes: int, blocks: int):
    """The stream kernel's partition in torch ops: block ``b`` of
    ``blocks`` spans ``n_real // blocks`` real rows, the first ``n_real %
    blocks`` blocks one more, in order, and owns the nodes whose clamped
    start ``min(offn[n], n_real)`` lies in its span, ``[n_lo, n_hi)`` (the
    counts of starts below each end of its span), with their rows ``[r0,
    r1)``, which may run past the span's end; and an equal share, ``[e_lo,
    e_hi)``, of the nodes that start at ``n_real`` (no real row), split as
    the rows are. Returns ``(n_lo, n_hi, r0, r1, e_lo, e_hi)``, each
    ``(blocks,)`` int64."""
    def split(total):
        per, extra = divmod(total, blocks)
        return torch.tensor([b * per + min(b, extra)
                             for b in range(blocks + 1)])

    real = int(n_real)
    off = torch.clamp(offn[:num_nodes + 1].long().cpu(), max=real)
    below = (off[None, :num_nodes] < split(real)[:, None]).sum(1)
    n_lo, n_hi = below[:-1], below[1:]
    empties = below[-1] + split(num_nodes - int(below[-1]))
    return n_lo, n_hi, off[n_lo], off[n_hi], empties[:-1], empties[1:]


def segment_attention_plain(alpha, m, offn, n_real, num_nodes):
    """The kernel's function in plain torch ops: f32 arithmetic, output in
    the input dtype. Returns ``(out, max, den)``, the last two f32."""
    n_rows, hf = alpha.shape
    ids, valid = _segments(offn, n_real, num_nodes, n_rows)
    a = torch.where(valid[:, None], alpha.float(),
                    torch.full((), NEG_BIG, device=alpha.device))
    mx = segment_max(a, ids, num_nodes)
    ex = torch.where(valid[:, None], torch.exp(a - mx[ids]),
                     torch.zeros((), device=alpha.device))
    den = segment_sum(ex, ids, num_nodes)
    num = segment_sum(ex * m.float(), ids, num_nodes)
    return (num / (den + SOFTMAX_EPS)).to(alpha.dtype), mx, den


def _check(alpha, m, offn, n_real, num_nodes):
    if alpha.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"segment_attention takes bf16 or f32, not "
                        f"{alpha.dtype}")
    if m.dtype != alpha.dtype or m.shape != alpha.shape or alpha.dim() != 2:
        raise ValueError(f"alpha {tuple(alpha.shape)} {alpha.dtype} and m "
                         f"{tuple(m.shape)} {m.dtype} must be one (E, H*F) "
                         f"shape and dtype")
    if offn.dtype != torch.int32 or offn.dim() != 1 \
            or offn.numel() < num_nodes + 1:
        raise ValueError(f"offn must be int32 with >= {num_nodes + 1} "
                         f"entries, got {tuple(offn.shape)} {offn.dtype}")
    if n_real.dtype != torch.int32 or n_real.numel() != 1:
        raise ValueError("n_real must be a one-element int32 tensor")
    for name, t in (("alpha", alpha), ("m", m), ("offn", offn),
                    ("n_real", n_real)):
        if t.device != alpha.device:
            raise ValueError(f"{name} is on {t.device}, alpha on "
                             f"{alpha.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def segment_attention(alpha, m, offn, n_real, num_nodes, *,
                      return_stats=False):
    """Softmax-weighted aggregation of ``m`` into ``num_nodes`` segments.

    alpha, m: (E, H*F) bf16 or f32, rows sorted by destination.
    offn:     (>= num_nodes + 1,) int32 unclamped CSR pointers.
    n_real:   one-element int32 tensor, the real-row count (rows at or past
              it never count).
    Returns (num_nodes, H*F) in the input dtype; with ``return_stats`` also
    the f32 per-node column max and exp-sum.
    """
    if alpha.device.type == "cpu":
        out, mx, den = segment_attention_plain(alpha, m, offn, n_real,
                                               num_nodes)
        return (out, mx, den) if return_stats else out
    _check(alpha, m, offn, n_real, num_nodes)
    hf = alpha.shape[1]
    out = torch.empty((num_nodes, hf), dtype=alpha.dtype, device=alpha.device)
    mx = den = None
    if return_stats:
        mx = torch.empty((num_nodes, hf), dtype=torch.float32,
                         device=alpha.device)
        den = torch.empty_like(mx)
    code = build.run(_fwd(), alpha.device, alpha.data_ptr(), m.data_ptr(),
                     offn.data_ptr(), n_real.data_ptr(), num_nodes, hf,
                     int(alpha.dtype == torch.bfloat16), out.data_ptr(),
                     None if mx is None else mx.data_ptr(),
                     None if den is None else den.data_ptr())
    build.check("segment_attention", code)
    return (out, mx, den) if return_stats else out


def segment_attention_bwd_plain(alpha, m, ids, n_real, g, out, mx, den):
    """The backward kernel's function in plain torch ops: f32 arithmetic,
    ``(dalpha, dm)`` in the input dtype."""
    rows = torch.arange(alpha.shape[0], device=alpha.device)
    valid = (rows < n_real.to(rows.dtype))[:, None]
    ids = ids.long()
    q = g.float() / (den + SOFTMAX_EPS)
    zero = torch.zeros((), device=alpha.device)
    dm = torch.where(valid, torch.exp(alpha.float() - mx[ids]) * q[ids], zero)
    dalpha = dm * (m.float() - out.float()[ids])
    return dalpha.to(alpha.dtype), dm.to(alpha.dtype)


def segment_attention_bwd(alpha, m, ids, n_real, g, out, mx, den):
    """Gradients of :func:`segment_attention` with respect to ``alpha`` and
    ``m``. ids: (E,) int32 destination per row (sorted); g, out: (N, H*F)
    in the input dtype; mx, den: (N, H*F) f32 from ``return_stats``."""
    if alpha.device.type == "cpu":
        return segment_attention_bwd_plain(alpha, m, ids, n_real, g, out,
                                           mx, den)
    n_rows, hf = alpha.shape
    num_nodes = out.shape[0]
    if alpha.dtype not in (torch.bfloat16, torch.float32) \
            or m.dtype != alpha.dtype or m.shape != alpha.shape:
        raise TypeError(f"alpha {tuple(alpha.shape)} {alpha.dtype} and m "
                        f"{tuple(m.shape)} {m.dtype} must be one bf16 or f32 "
                        f"(E, H*F) shape and dtype")
    node = (num_nodes, hf)
    want = {"alpha": (alpha.shape, alpha.dtype), "m": (alpha.shape, alpha.dtype),
            "ids": ((n_rows,), torch.int32), "n_real": ((1,), torch.int32),
            "g": (node, alpha.dtype), "out": (node, alpha.dtype),
            "mx": (node, torch.float32), "den": (node, torch.float32)}
    for name, t in (("alpha", alpha), ("m", m), ("ids", ids),
                    ("n_real", n_real.reshape(1)), ("g", g), ("out", out),
                    ("mx", mx), ("den", den)):
        shape, dtype = want[name]
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(shape)} {dtype}")
        if t.device != alpha.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {alpha.device}")
    dalpha = torch.empty_like(alpha)
    dm = torch.empty_like(alpha)
    code = build.run(_bwd(), alpha.device, alpha.data_ptr(), m.data_ptr(),
                     ids.data_ptr(), n_real.data_ptr(), g.data_ptr(),
                     out.data_ptr(), mx.data_ptr(), den.data_ptr(), n_rows,
                     hf, int(alpha.dtype == torch.bfloat16),
                     dalpha.data_ptr(), dm.data_ptr())
    build.check("segment_attention", code)
    return dalpha, dm


class SegmentAttention(torch.autograd.Function):
    """:func:`segment_attention` with :func:`segment_attention_bwd` as its
    backward; the forward keeps the f32 max and exp-sum for it."""

    @staticmethod
    def forward(ctx, alpha, m, ids, offn, n_real, num_nodes):
        out, mx, den = segment_attention(alpha, m, offn, n_real, num_nodes,
                                         return_stats=True)
        ctx.save_for_backward(alpha, m, ids, n_real, out, mx, den)
        return out

    @staticmethod
    def backward(ctx, g):
        alpha, m, ids, n_real, out, mx, den = ctx.saved_tensors
        dalpha, dm = segment_attention_bwd(alpha, m, ids, n_real,
                                           g.contiguous(), out, mx, den)
        return dalpha, dm, None, None, None, None


def segment_attention_pair_plain(alpha_l, m_l, ids_l, mask_l, alpha_h, m_h,
                                 ids_h, mask_h, num_nodes):
    """The pair op's function in plain torch ops: the union softmax of the
    local block ``*_l`` and the halo block ``*_h`` (rows with a False mask
    count in neither) weighting their messages, summed per destination;
    f32 arithmetic, output in the input dtype, differentiable by autograd.
    Masks may interleave padding (a whole sharded layout in one process)."""
    w_l, w_h = segment_softmax_pair(alpha_l.float(), ids_l, mask_l,
                                    alpha_h.float(), ids_h, mask_h, num_nodes)
    zero = torch.zeros((), device=alpha_l.device)
    out = (segment_sum(torch.where(mask_l[:, None], w_l * m_l.float(), zero),
                       ids_l, num_nodes)
           + segment_sum(torch.where(mask_h[:, None], w_h * m_h.float(),
                                     zero), ids_h, num_nodes))
    return out.to(alpha_l.dtype)


def merge_pair(out_l, max_l, den_l, out_h, max_h, den_h):
    """The flash merge of two blocks' forward results into the union's
    ``(out, max, den)``, in f32: both numerators ``out (den + EPS)``
    rescaled to the common shift ``max(max_l, max_h)``."""
    out_l, out_h = out_l.float(), out_h.float()
    gmax = torch.maximum(max_l, max_h)
    s_l = torch.exp(max_l - gmax)
    s_h = torch.exp(max_h - gmax)
    den = den_l * s_l + den_h * s_h
    num = (out_l * (den_l + SOFTMAX_EPS) * s_l
           + out_h * (den_h + SOFTMAX_EPS) * s_h)
    return num / (den + SOFTMAX_EPS), gmax, den


class SegmentAttentionPair(torch.autograd.Function):
    """The union softmax-aggregate of a local and a halo edge block, each
    dst-sorted with a False-suffix padding: :func:`segment_attention` on
    each block, :func:`merge_pair`, and :func:`segment_attention_bwd` on
    each block against the merged arrays: two launches of each kernel a
    call."""

    @staticmethod
    def forward(ctx, alpha_l, m_l, ids_l, offn_l, n_l, alpha_h, m_h, ids_h,
                offn_h, n_h, num_nodes):
        out_l, max_l, den_l = segment_attention(alpha_l, m_l, offn_l, n_l,
                                                num_nodes, return_stats=True)
        out_h, max_h, den_h = segment_attention(alpha_h, m_h, offn_h, n_h,
                                                num_nodes, return_stats=True)
        out, gmax, den = merge_pair(out_l, max_l, den_l, out_h, max_h, den_h)
        out = out.to(alpha_l.dtype)
        ctx.save_for_backward(alpha_l, m_l, ids_l, n_l, alpha_h, m_h, ids_h,
                              n_h, out, gmax, den)
        return out

    @staticmethod
    def backward(ctx, g):
        alpha_l, m_l, ids_l, n_l, alpha_h, m_h, ids_h, n_h, out, gmax, den = \
            ctx.saved_tensors
        g = g.contiguous()
        da_l, dm_l = segment_attention_bwd(alpha_l, m_l, ids_l, n_l, g, out,
                                           gmax, den)
        da_h, dm_h = segment_attention_bwd(alpha_h, m_h, ids_h, n_h, g, out,
                                           gmax, den)
        return (da_l, dm_l, None, None, None, da_h, dm_h, None, None, None,
                None)
