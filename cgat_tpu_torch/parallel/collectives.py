"""The collectives of the data-parallel and edge-sharded paths, with
autograd where the model differentiates through them.

Counterparts of ``jax.lax.all_to_all``, ``all_gather`` and ``psum`` inside
the JAX package's ``shard_map`` steps:

* :func:`all_to_all` (the edge group's boundary exchange, equal static
  splits along dim 0); its backward is the same exchange of the
  cotangents, which returns each row's gradient to the rank that sent it;
* :func:`all_gather` (the pool's per-crystal max); its backward sums the
  cotangents over the ranks and keeps this rank's slice;
* :func:`all_reduce` (the pool's numerator and denominator); its backward
  sums the cotangents over the ranks;
* :func:`all_reduce_` (no autograd: the metrics' sums, and
  :func:`reduce_gradients` over the flat gradient buffers).

NCCL takes CUDA tensors as they are, and its collectives are captured in
the CUDA graph of a training step. Under a gloo group, CUDA tensors are
staged through host memory (copied to the CPU, reduced or exchanged there,
copied back) whatever gloo itself supports for them: a rule keyed on the
group's backend, for the several-ranks-on-one-card check, never applied
to NCCL. A gloo step is therefore eager (``training/dispatch.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# gradient buckets: tensors of one dtype are joined up to this many
# elements a collective (the flat vectors of ``training/flatten.py`` are
# one bucket each)
BUCKET_ELEMS = 1 << 25

# collectives issued from the host, by kind (a CUDA graph's replay issues
# none: its capture counts them once)
calls = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    calls["all_reduce"] += 1
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    calls["all_gather"] += 1
    size = dist.get_world_size(group)
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    calls["all_to_all"] += 1
    src = t.cpu() if _staged(t, group) else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g[dist.get_rank(ctx.group)], None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row block j of ``x`` (dim 0 cut into as many equal blocks as the
    group has ranks) goes to the group's rank j; block j of the result came
    from rank j."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis, in group rank
    order."""
    return _AllGather.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor)."""
    return _AllReduce.apply(x, group)


def reduce_gradients(tensors, group) -> None:
    """Sum ``tensors`` (gradients) over ``group`` in place, in a few
    collectives: tensors of one dtype are joined into buckets of at most
    ``BUCKET_ELEMS`` elements (a tensor at least that large is a bucket of
    its own and is reduced where it lies), never one collective a
    tensor."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket, n = [], 0
        for t in ts + [None]:
            if t is not None and t.numel() >= BUCKET_ELEMS \
                    and t.is_contiguous():
                all_reduce_(t, group)
                continue
            if bucket and (t is None or n + t.numel() > BUCKET_ELEMS):
                if len(bucket) == 1 and bucket[0].is_contiguous():
                    all_reduce_(bucket[0], group)
                else:
                    flat = all_reduce_(
                        torch.cat([b.reshape(-1) for b in bucket]), group)
                    torch._foreach_copy_(
                        bucket, [v.view_as(b) for v, b in zip(
                            torch.split(flat, [b.numel() for b in bucket]),
                            bucket)])
                bucket, n = [], 0
            if t is not None:
                bucket.append(t)
                n += t.numel()
