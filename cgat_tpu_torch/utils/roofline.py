"""The port's kernels against the H100's rooflines, counterpart of
``cgat_tpu/utils/roofline.py``.

Each kernel's work is what its inputs need, whatever implements it: the
bytes of each input read once and each output written once, and the
operations these inputs need (for the segment kernels, on the real rows of
the batch: the work depends on the data). A kernel's bound is the larger
of its bytes over the card's memory rate and its operations over the
card's peak for their type; ``summarize`` places a measured time against
both. ``measure_kernels``, ``measure_mh_kernels`` and
``measure_hyper_kernels`` time each kernel's device time
(``utils.profiling.device_ms`` over a CUDA graph of back-to-back calls on
inputs the L2 cache does not hold) at the main path's shapes: the
forward kernels at serving request 0's (64 crystals, 832 node and 19,968
edge slots), the backward kernels at the first training step's (768 node
and 18,432 edge slots); #5 to #7 at C = I = O = 128; #1 also at the
training step's, writing the max and exp-sum its backward reads, and at a
GP batch of 512 crystals (5,952 node and 142,848 edge slots). They need
the card::

    python -m cgat_tpu_torch.utils.roofline

prints them as one JSON object, with the card's name and power limit.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 3.35 TB/s of HBM,
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them, all at
the full 700 W power limit.

Not carried over from the JAX package, by choice: the TPU v5e's peaks and
``F32_HIGHEST_FRACTION`` (the MXU's multi-pass f32 rate), the DMA-chunk
accounting of ``fwd_kernel_accounting`` and ``bwd_block_edges`` (the Pallas
kernels' VMEM windows and block policy, which the CUDA kernels do not
have), and the parsers of the TPU trace's lanes (``_device_kernel_times``,
``_device_kernel_starts``; the card's device time comes from
``torch.profiler``). The MXU FLOPs of ``mh_fwd_accounting`` and
``mh_bwd_accounting`` are the operations of ``mh_network_work`` and
``mh_network_bwd_work``.
"""
from __future__ import annotations

import json
import math

import torch

from . import counters

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache

# the peak each kernel's operations run at: the GEMM kernels on the tensor
# cores in bf16, the segment kernels and dropout in f32 arithmetic
PEAKS = {"segment_attention": F32_FLOPS, "segment_attention_bwd": F32_FLOPS,
         "mh_network": BF16_TENSOR_FLOPS, "mh_network_bwd": BF16_TENSOR_FLOPS,
         "hyper_apply": BF16_TENSOR_FLOPS,
         "hyper_apply_bwd_dhdx": BF16_TENSOR_FLOPS,
         "hyper_apply_bwd_dk": BF16_TENSOR_FLOPS, "segment_sum": F32_FLOPS,
         "dropout": F32_FLOPS, "pair": F32_FLOPS, "pair_bwd": F32_FLOPS,
         "adamw": F32_FLOPS}


def bound(n_bytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least ms the card could take for ``n_bytes`` and ``ops`` at
    ``peak`` operations a second, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segment_attention_work(real_edges: int, hf: int, num_nodes: int,
                           stats: bool = False) -> tuple[float, float]:
    """#1 on ``real_edges`` real rows of width ``hf`` into ``num_nodes``
    segments: alpha and m read, the CSR pointers read, out written (bf16),
    and with ``stats`` the f32 max and exp-sum written (a training step's
    calls and the pair path's); max, subtract, exp, add and a multiply-add
    a row element."""
    return (2.0 * 2 * real_edges * hf + 4.0 * (num_nodes + 1)
            + 2.0 * num_nodes * hf + (8.0 * num_nodes * hf if stats else 0),
            6.0 * real_edges * hf)


def segment_attention_bwd_work(edge_rows: int, real_edges: int, hf: int,
                               num_nodes: int) -> tuple[float, float]:
    """#2: alpha and m read on the real rows, dalpha and dm written on all
    ``edge_rows``, the ids read, g and out (bf16) and max and den (f32)
    read a node."""
    return (2.0 * 2 * real_edges * hf + 2.0 * 2 * edge_rows * hf
            + 4.0 * real_edges + (2.0 + 2.0 + 4.0 + 4.0) * num_nodes * hf,
            7.0 * real_edges * hf)


def mh_network_work(edge_rows: int, cat: int, heads: int, hid: int,
                    f: int) -> tuple[float, float]:
    """#3 (bf16): x, both weights and biases read, the (E, H*f) output
    written; the two products of each head."""
    return (2.0 * (edge_rows * cat + heads * hid * cat + heads * hid
                   + heads * f * hid + heads * f + edge_rows * heads * f),
            2.0 * edge_rows * (cat * heads * hid + heads * hid * f))


def mh_network_bwd_work(edge_rows: int, cat: int, heads: int, hid: int,
                        f: int) -> tuple[float, float]:
    """#4 (bf16): x, h and g read, dx written, both weights read and their
    gradients and the biases' written; the four products (dh, dx, dWin,
    dWout)."""
    hh, hf = heads * hid, heads * f
    return (2.0 * (edge_rows * cat + edge_rows * hh + edge_rows * hf
                   + edge_rows * cat + 2 * (hh * cat + hh + hf * hid + hf)),
            4.0 * edge_rows * hh * (f + cat))


def hyper_work(b: int, c: int, i: int, o: int) -> dict[str, tuple]:
    """(bytes, operations) of one call of #5, #6 and #7 on ``b`` rows
    (hidden width C, I inputs, O outputs): each input read once, each
    output written once."""
    f = o * i + o
    return {"hyper_apply": (2.0 * (b * c + f * c + f + b * i + b * o),
                            2.0 * b * c * f + 2.0 * b * o * i),
            "hyper_apply_bwd_dhdx": (
                2.0 * (2 * b * c + 2 * b * i + b * o + f * c + f),
                4.0 * b * f * c + 2.0 * b * o * i),
            "hyper_apply_bwd_dk": (
                2.0 * (b * c + b * i + b * o + o * i * c) + 4.0 * o * i,
                2.0 * b * o * i * c)}


def segment_sum_work(rows: int, f: int,
                     num_segments: int) -> tuple[float, float]:
    """#8 (bf16): the rows read, the sums written, the CSR pointers read;
    an add a row element."""
    return (2.0 * (rows * f + num_segments * f) + 4.0 * (num_segments + 1),
            1.0 * rows * f)


def dropout_work(n: int) -> tuple[float, float]:
    """The dropout kernel on ``n`` bf16 elements: x read, out written; a
    multiply an element (Philox's integer work not counted)."""
    return 2.0 * 2 * n, float(n)


def adamw_work(elements: int, mu_bytes: int) -> tuple[float, float]:
    """The fused AdamW pass over ``elements`` parameters with a first
    moment of ``mu_bytes`` bytes an element: g, p and nu (f32) and mu read,
    p, mu and nu written; 16 f32 operations an element."""
    return float(elements) * (20 + 2 * mu_bytes), 16.0 * elements


def pair_work(local_edges: int, halo_edges: int, hf: int,
              num_nodes: int) -> dict[str, tuple]:
    """The pair path (#1 on a local and a halo block, the f32 merge, #2 on
    each) on real rows: forward, both blocks' alpha and m read, out, max
    and den of both written and read by the merge, out written; backward,
    the four gradients written, alpha and m read again, g, out, max and
    den read for each block."""
    e = local_edges + halo_edges
    return {"pair": (2.0 * 2 * e * hf + (2 + 8 + 8) * 2 * num_nodes * hf
                     + 2.0 * num_nodes * hf,
                     6.0 * e * hf + 12.0 * num_nodes * hf),
            "pair_bwd": (2.0 * 4 * e * hf
                         + 2 * (2 + 2 + 4 + 4) * num_nodes * hf,
                         5.0 * e * hf)}


def summarize(work: tuple[float, float], seconds: float,
              peak: float) -> dict:
    """A measured time against both rooflines: the achieved rates, each as
    a share of its peak, and the larger share as the bound."""
    n_bytes, ops = work
    bytes_share = n_bytes / seconds / HBM_BYTES_PER_S
    ops_share = ops / seconds / peak
    return {"seconds": seconds, "bytes": n_bytes, "operations": ops,
            "bytes_per_s": n_bytes / seconds, "ops_per_s": ops / seconds,
            "bytes_share": bytes_share, "ops_share": ops_share,
            "bound_by": "bytes" if bytes_share >= ops_share
            else "operations"}


# -------------------------------------------------- measuring on the card

def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("measuring the kernels needs a CUDA card")
    return torch.device("cuda")


def request_batch(device, batch_size: int = 64):
    """Serving request 0 of ``chip_smoke.py``: ``batch_size`` synthetic
    crystals of 8 to 16 atoms at full degree, node slots the 64-multiple
    of their atoms and 24 edge slots a node."""
    from ..data import collate, pad_to_bucket
    from ..data.synthetic import random_graphs

    graphs = random_graphs(0, batch_size, n_atoms_range=(8, 16), max_nbr=24,
                           full_degree=True)
    n = pad_to_bucket(sum(g.n_atoms for g in graphs), 64)
    return collate(graphs, num_graphs=batch_size, num_node_slots=n,
                   num_edge_slots=n * 24, num_comp_slots=8, max_nbr=24,
                   orig_fea=200).to(device)


def training_batch(device, batch_size: int = 64):
    """The first batch of a default bf16 ``Trainer`` on ``chip_smoke.py``'s
    training crystals (5 x ``batch_size`` of them, seed 100)."""
    from ..data.synthetic import random_graphs
    from ..models import CGATConfig
    from ..training import Trainer, TrainerConfig

    graphs = random_graphs(100, 5 * batch_size, n_atoms_range=(8, 16),
                           max_nbr=24, full_degree=True)
    trainer = Trainer(TrainerConfig(batch_size=batch_size,
                                    moment_dtype="bfloat16"),
                      CGATConfig(compute_dtype="bfloat16"), graphs,
                      device=device)
    return next(iter(trainer.loader(trainer.train_graphs,
                                    shuffle=True))).to(device)


def gp_batch(device, batch_size: int = 512):
    """The first batch of ``chip_smoke.py``'s GP phase: ``batch_size``
    crystals of its pool of 2,048 (seed 500, full degree), shuffled with
    seed 0, node slots a multiple of 64."""
    from ..data.dataset import GraphLoader
    from ..data.synthetic import random_graphs

    pool = random_graphs(500, 2048, n_atoms_range=(8, 16), max_nbr=24,
                         full_degree=True)
    loader = GraphLoader(pool, batch_size, shuffle=True, seed=0, max_nbr=24,
                         node_bucket=64)
    return next(iter(loader)).to(device)


def _device_time(fn, args, iters: int) -> tuple[float, float]:
    """Device ms of one call ``fn(*a)``, from the device events of
    ``iters`` calls captured in one CUDA graph: each kernel's mean event
    time times its events a call (so an event the profiler drops moves
    nothing), summed; and the device events a call the profiler saw. The
    calls take turns over copies of the tensors in ``args`` that together
    hold at least twice the L2 cache, each writes new memory, and the
    graph runs them back to back: each call reads its inputs from HBM and
    the write-back of its outputs overlaps the next call, as among a
    training step's kernels. (Calls on the same tensors, or with the card
    idle in between while the host issues the next, end before their
    writes reach HBM and can beat the bytes' bound.)"""
    from .profiling import device_ms

    size = sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))
    n = max(2, math.ceil(2 * L2_BYTES / max(size, 1)))
    sets = [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args) for _ in range(n)]
    for a in sets:                       # first launches, outside the graph
        fn(*a)
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    before = counters.snapshot()
    with torch.cuda.graph(graph):
        for i in range(iters):
            outs.append(fn(*sets[i % n]))
    counters.add(counters.since(before), -1)    # a capture runs nothing
    graph.replay()
    torch.cuda.synchronize()
    per_name = device_ms(graph.replay, 1)
    if not per_name:
        raise RuntimeError("the profiler recorded no device events")
    ms = sum(t / c * max(1, round(c / iters)) for t, c in per_name.values())
    return ms, sum(c for _, c in per_name.values()) / iters


def _row(name: str, shape, fn, args, work, iters: int) -> dict:
    ms, events = _device_time(fn, args, iters)
    b_ms, b_by = bound(*work, PEAKS[name])
    return {"kernel": name, "shape": list(shape), "device_ms": ms,
            "events_a_call": events, "bound_ms": b_ms, "bound_by": b_by,
            "share": b_ms / ms, **summarize(work, ms / 1e3, PEAKS[name])}


def _randn(gen, *shape, scale: float = 1.0):
    return (torch.randn(*shape, generator=gen, device="cuda")
            * scale).to(torch.bfloat16)


def measure_kernels(batch_size: int = 64, iters: int = 20) -> dict:
    """#1 at serving request 0's shapes, #2 and #8 at the first training
    step's, and dropout on request 0's node-layer dropout site (edge slots
    x 5 heads x 128), bf16 inputs from a seeded generator; also #1 at the
    training step's shapes with its stats (``segment_attention_stats``)
    and at a GP batch (``segment_attention_gp``). Each row names its
    kernel; raises without a card."""
    from ..ops.kernels import dropout as dk
    from ..ops.kernels import segment_attention as sk
    from ..ops.kernels import segment_sum as ssk

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    hf = 5 * 128
    req = request_batch(dev, batch_size)
    n_nodes, e = int(req.num_node_slots), int(req.num_edge_slots)
    real = req.edge_mask.sum(dtype=torch.int32)
    offn = req.edge_dst_offn
    rows = {"segment_attention": _row(
        "segment_attention", [e, hf, n_nodes],
        lambda a, m: sk.segment_attention(a, m, offn, real, n_nodes),
        (_randn(gen, e, hf), _randn(gen, e, hf)),
        segment_attention_work(int(real), hf, n_nodes), iters)}
    x = _randn(gen, e, 5, 128)
    step = torch.tensor(12345, dtype=torch.int64, device=dev)
    key = dk.site_key(0, 0)
    rows["dropout"] = _row("dropout", list(x.shape),
                           lambda t: dk.dropout(t, 0.1, key, step), (x,),
                           dropout_work(x.numel()), iters)

    tr = training_batch(dev, batch_size)
    n_nodes, e = int(tr.num_node_slots), int(tr.num_edge_slots)
    real = tr.edge_mask.sum(dtype=torch.int32)
    alpha, m = _randn(gen, e, hf), _randn(gen, e, hf)
    out, mx, den = sk.segment_attention(alpha, m, tr.edge_dst_offn, real,
                                        n_nodes, return_stats=True)
    ids = tr.edge_dst.to(torch.int32).contiguous()
    rows["segment_attention_stats"] = _row(
        "segment_attention", [e, hf, n_nodes],
        lambda a, m: sk.segment_attention(a, m, tr.edge_dst_offn, real,
                                          n_nodes, return_stats=True),
        (alpha, m), segment_attention_work(int(real), hf, n_nodes, True),
        iters)
    rows["segment_attention_bwd"] = _row(
        "segment_attention_bwd", [e, hf, n_nodes],
        lambda a, m, g, o, x, d: sk.segment_attention_bwd(a, m, ids, real,
                                                          g, o, x, d),
        (alpha, m, _randn(gen, n_nodes, hf), out, mx, den),
        segment_attention_bwd_work(e, int(real), hf, n_nodes), iters)
    offn = tr.edge_dst_offn
    rows["segment_sum"] = _row(
        "segment_sum", [e, 128, n_nodes],
        lambda v: ssk.segment_sum(v, ids, offn, n_nodes),
        (_randn(gen, e, 128),), segment_sum_work(e, 128, n_nodes), iters)

    gp = gp_batch(dev)
    n_nodes, e = int(gp.num_node_slots), int(gp.num_edge_slots)
    real = gp.edge_mask.sum(dtype=torch.int32)
    rows["segment_attention_gp"] = _row(
        "segment_attention", [e, hf, n_nodes],
        lambda a, m: sk.segment_attention(a, m, gp.edge_dst_offn, real,
                                          n_nodes),
        (_randn(gen, e, hf), _randn(gen, e, hf)),
        segment_attention_work(int(real), hf, n_nodes), iters)
    return rows


def measure_mh_kernels(fwd_rows: int | None = None,
                       bwd_rows: int | None = None, cat: int = 384,
                       hid: int = 256, f: int = 128, heads: int = 5,
                       iters: int = 20) -> dict:
    """#3 on ``fwd_rows`` edge rows (serving request 0's edge slots by
    default) and #4 on ``bwd_rows`` (the first training step's), at the
    default model's MH widths (cat = 2 x 128 + 128, hidden 256, 128 out a
    head, 5 heads); raises without a card."""
    from ..ops.kernels import mh_network as mk

    dev = _card()
    if fwd_rows is None:
        fwd_rows = int(request_batch(dev).num_edge_slots)
    if bwd_rows is None:
        bwd_rows = int(training_batch(dev).num_edge_slots)
    gen = torch.Generator(device=dev).manual_seed(0)
    win, b_in = _randn(gen, heads * hid, cat, scale=0.05), \
        _randn(gen, heads * hid, scale=0.05)
    wout, b_out = _randn(gen, heads * f, hid, scale=0.05), \
        _randn(gen, heads * f, scale=0.05)
    rows = {"mh_network": _row(
        "mh_network", [fwd_rows, cat, heads * hid, heads * f],
        lambda x: mk.mh_network(x, win, b_in, wout, b_out, heads),
        (_randn(gen, fwd_rows, cat),),
        mh_network_work(fwd_rows, cat, heads, hid, f), iters)}
    x = _randn(gen, bwd_rows, cat)
    _, h = mk.mh_network(x, win, b_in, wout, b_out, heads,
                         return_hidden=True)
    rows["mh_network_bwd"] = _row(
        "mh_network_bwd", [bwd_rows, cat, heads * hid, heads * f],
        lambda x, h, g: mk.mh_network_bwd(x, h, g, win, wout, heads),
        (x, h, _randn(gen, bwd_rows, heads * f)),
        mh_network_bwd_work(bwd_rows, cat, heads, hid, f), iters)
    return rows


def measure_hyper_kernels(fwd_rows: int | None = None,
                          bwd_rows: int | None = None, c: int = 128,
                          i_ch: int = 128, o_ch: int = 128,
                          iters: int = 20) -> dict:
    """#5 on ``fwd_rows`` node rows (serving request 0's node slots by
    default), #6 and #7 on ``bwd_rows`` (the first training step's), at
    hidden width ``c``, ``i_ch`` inputs and ``o_ch`` outputs; raises
    without a card."""
    from ..ops.kernels import hyper_apply as hk

    dev = _card()
    if fwd_rows is None:
        fwd_rows = int(request_batch(dev).num_node_slots)
    if bwd_rows is None:
        bwd_rows = int(training_batch(dev).num_node_slots)
    gen = torch.Generator(device=dev).manual_seed(0)
    f = o_ch * i_ch + o_ch
    k, bias = _randn(gen, f, c, scale=0.01), _randn(gen, f, scale=0.01)
    rows = {"hyper_apply": _row(
        "hyper_apply", [fwd_rows, c, i_ch, o_ch],
        lambda hidden, x: hk.hyper_apply(hidden, k, bias, x, o_ch),
        (_randn(gen, fwd_rows, c), _randn(gen, fwd_rows, i_ch)),
        hyper_work(fwd_rows, c, i_ch, o_ch)["hyper_apply"], iters)}
    work = hyper_work(bwd_rows, c, i_ch, o_ch)
    args = (_randn(gen, bwd_rows, c), _randn(gen, bwd_rows, i_ch),
            _randn(gen, bwd_rows, o_ch))
    rows["hyper_apply_bwd_dhdx"] = _row(
        "hyper_apply_bwd_dhdx", [bwd_rows, c, i_ch, o_ch],
        lambda hidden, x, g: hk.hyper_apply_bwd_dhdx(hidden, k, bias, x, g,
                                                     o_ch),
        args, work["hyper_apply_bwd_dhdx"], iters)
    rows["hyper_apply_bwd_dk"] = _row(
        "hyper_apply_bwd_dk", [bwd_rows, c, i_ch, o_ch],
        lambda hidden, x, g: hk.hyper_apply_bwd_dk(hidden, x, g, o_ch),
        args, work["hyper_apply_bwd_dk"], iters)
    return rows


def main() -> int:
    from ..device import card_line

    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {**measure_kernels(), **measure_mh_kernels(),
            **measure_hyper_kernels()}
    print(json.dumps({"card": card_line(), "kernels": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
