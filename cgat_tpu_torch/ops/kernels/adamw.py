"""AdamW's update in one pass: the CUDA kernel's wrapper, its launch plan
and its gate.

The kernel (``cgat_tpu_torch/csrc/adamw.cu``) does for every element of a
list of tensors what the ``_foreach`` passes of
:meth:`cgat_tpu_torch.training.optim.AdamW.update_plain` do, the same f32
operations in the same order, so the same bits: it reads g, p, mu and nu
once and writes p, mu and nu once. ``update_plain`` is the plain version,
and the path of CPU tensors; CUDA tensors launch the kernel or raise.

A launch's table of tensors travels by value in the kernel's parameters
(:class:`Table`, a mirror of the source's), which hold ``MAX_TENSORS``
tensors: :func:`plan` splits a longer list over more launches (the
default model's flat layout, 73 tensors, takes one) and numbers each
tensor's chunks of ``CHUNK`` elements through its launch; the blocks, one
wave of ``BLOCKS_PER_SM`` an SM, take the chunks grid-stride.

``build.run`` counts each launch under the C entry's name, and the
wrapper counts the elements it updated in the ``utils.counters`` counter
"adamw_fused" (:func:`stats`); a replayed CUDA graph adds what its
capture counted to both, so a replayed training step counts its update.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...utils import counters
from . import build

MAX_TENSORS = 80       # the source's MAX_TENSORS: tensors a table holds
CHUNK = 4096           # elements a block takes at a time: 4 a thread, 4 times
BLOCKS_PER_SM = 4      # the source's __launch_bounds__: one wave
PARAM_BYTES = 4096     # kernel parameters every CUDA toolkit takes

_P = ctypes.c_void_p
_MU_DTYPES = (torch.float32, torch.bfloat16)
# elements updated
_ELEMENTS = counters.counter("adamw_fused", 1)


def stats() -> dict[str, int]:
    """The launches made so far in this process, and the elements they
    updated."""
    return {"launches": build.launch_counts().get("cgat_adamw", 0),
            "elements": _ELEMENTS[0]}


class _Entry(ctypes.Structure):
    _fields_ = [("p", _P), ("g", _P), ("mu", _P), ("nu", _P),
                ("numel", ctypes.c_longlong), ("chunk0", ctypes.c_longlong)]


class Table(ctypes.Structure):
    """``csrc/adamw.cu``'s ``Table``, field for field (the C entry refuses
    a table of another size): the step's device scalars, the f32
    constants, and the launch's tensors."""
    _fields_ = [("bc1", _P), ("bc2", _P), ("neg_lr", _P),
                ("b1", ctypes.c_float), ("one_minus_b1", ctypes.c_float),
                ("b2", ctypes.c_float), ("one_minus_b2", ctypes.c_float),
                ("eps", ctypes.c_float), ("weight_decay", ctypes.c_float),
                ("n", ctypes.c_int), ("chunk", ctypes.c_int),
                ("chunks", ctypes.c_longlong),
                ("e", _Entry * MAX_TENSORS)]


@functools.cache
def _entry():
    return build.entry("adamw", "cgat_adamw",
                       [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P])


def plan(numels) -> list[tuple[list[tuple[int, int]], int]]:
    """The launches for tensors of ``numels`` elements: each a list of
    (tensor index, the launch's number of its first chunk) of at most
    ``MAX_TENSORS`` tensors, in list order, and the launch's chunks.
    Empty tensors take no place."""
    launches: list = []
    tensors: list = []
    chunks = 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(tensors) == MAX_TENSORS:
            launches.append((tensors, chunks))
            tensors, chunks = [], 0
        tensors.append((i, chunks))
        chunks += -(-n // CHUNK)
    if tensors:
        launches.append((tensors, chunks))
    return launches


def refusal(device, params, grads, mu, nu, scalars) -> Exception | None:
    """The error for lists the kernel does not take, or None: four lists
    of one length, every tensor contiguous on ``device`` with its
    parameter's shape, p, g and nu f32, mu all f32 or all bf16, and the
    step's ``scalars`` (bc1, bc2, the negated learning rate) f32 of one
    element on ``device``."""
    if not len(params) == len(grads) == len(mu) == len(nu):
        return ValueError(f"fused AdamW takes lists of one length, not "
                          f"{len(params)}, {len(grads)}, {len(mu)} and "
                          f"{len(nu)} parameters, gradients, mu and nu")
    mu_dtype = mu[0].dtype if mu else torch.float32
    if mu_dtype not in _MU_DTYPES:
        return TypeError(f"fused AdamW keeps mu in float32 or bfloat16, "
                         f"not {mu_dtype}")
    f32 = torch.float32
    for i, lists in enumerate(zip(params, grads, mu, nu)):
        for name, t, dtype in zip(("parameter", "gradient", "mu", "nu"),
                                  lists, (f32, f32, mu_dtype, f32)):
            if t.dtype != dtype or t.device != device \
                    or not t.is_contiguous() or t.shape != lists[0].shape:
                return TypeError(
                    f"fused AdamW takes {name} {i} as a contiguous {dtype} "
                    f"tensor of shape {tuple(lists[0].shape)} on {device}, "
                    f"not {'a contiguous' if t.is_contiguous() else 'a'} "
                    f"{t.dtype} tensor of shape {tuple(t.shape)} on "
                    f"{t.device}")
    for t in scalars:
        if t.dtype != f32 or t.numel() != 1 or t.device != device:
            return TypeError(f"fused AdamW reads its step's scalars as one "
                             f"float32 on {device}, not {t.dtype} of shape "
                             f"{tuple(t.shape)} on {t.device}")
    return None


def adamw(params, grads, mu, nu, bc1, bc2, neg_lr, *, b1: float, b2: float,
          eps: float, weight_decay: float) -> None:
    """AdamW's update of ``params``, ``mu`` and ``nu`` in place for
    ``grads``, the bias corrections ``bc1``, ``bc2`` and the negated
    learning rate ``neg_lr`` read on the device (0-dim f32 tensors), the
    constants as the f32 values torch makes of them; each launch counted
    in :func:`stats`."""
    device = params[0].device if params else torch.device("cpu")
    err = refusal(device, params, grads, mu, nu, (bc1, bc2, neg_lr))
    if err is not None:
        raise err
    if device.type != "cuda":
        raise ValueError(f"fused AdamW runs on a CUDA card, not on {device}; "
                         f"CPU tensors take AdamW.update_plain")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    grid_max = build.sm_count(index) * BLOCKS_PER_SM
    mu_bf16 = int(mu[0].dtype == torch.bfloat16)
    table = Table(bc1.data_ptr(), bc2.data_ptr(), neg_lr.data_ptr(),
                  b1, 1 - b1, b2, 1 - b2, eps, weight_decay)
    table.chunk = CHUNK
    for tensors, chunks in plan([p.numel() for p in params]):
        table.n, table.chunks = len(tensors), chunks
        rows = 0
        for j, (i, chunk0) in enumerate(tensors):
            table.e[j] = _Entry(params[i].data_ptr(), grads[i].data_ptr(),
                                mu[i].data_ptr(), nu[i].data_ptr(),
                                params[i].numel(), chunk0)
            rows += params[i].numel()
        code = build.run(_entry(), device, ctypes.byref(table),
                         ctypes.sizeof(table), mu_bf16,
                         min(chunks, grid_max), rows=rows)
        build.check("adamw", code)
        _ELEMENTS[0] += rows
