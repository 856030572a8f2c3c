"""CUDA graphs of the work the card repeats: the training step (the
card's counterpart of the JAX package's jitted step, ``make_train_step``,
and, K of them in one call, of ``make_multi_step``), the GP head's step
and the serving forward (the counterpart of a pre-lowered executable a
signature).

Each training step on the card (``Trainer.train_step``) is one
``replay()`` of a CUDA graph of the whole step (forward, backward,
optimizer update, damping projection), so the host issues one call where
eager PyTorch issues ~2,600 launches; a GP step (``uncertainty.gp.GPFit``)
and a serving request (``serving.ServingModel``) likewise. A graph holds
for one batch shape signature (every field's shape: node, edge, graph and
composition slots and the CSR lengths) and the caller's key (the training
step's optimizer phase, ``MultiSteps``' mini-step, which the update
branches on and divides by on the host; None for the others), so graphs
are kept by both; one ``StepGraphs``' graphs share one memory pool.

The first call of a key is real work, run eagerly on the card's one side
stream (:func:`side_stream`; an inference forward, serving's, on the
current stream) on a copy of the batch on the card: the
warm-up that capture needs (the kernels' first-launch set-up, cuBLAS's
workspace, the zero gradients of parameters that get none), whose result
is kept. The capture that follows runs nothing. So the trajectory is the
eager one. Before each replay the batch is copied into the graph's static
input buffers; the replay returns the graph's static outputs, which the
trainer and the GP fit clone (so successive steps' metrics do not share
one buffer) and serving reads back. What changes between steps and
enters the arithmetic lives on the device (the optimizers' count and
learning rate, ``training/optim.py``, and the trainer's step count, which
dropout draws its masks from); the host's bookkeeping (the step count,
the mini-step) is advanced by the caller after each call. A failed
capture or replay raises: the card never falls back to eager work.

On a rank of a parallel world under NCCL the step's collectives (the
metrics' sums, the flat gradients' reduction, and under edge sharding the
boundary exchange and the pool's) are captured with it; the key's eager
first step has initialised the communicators. Every rank of a group
collates to the same shapes, so all ranks capture and replay the same keys
in step. A gloo world is never captured (``Trainer.train_step``).

A replay runs no Python, so what the work counts on the host in a
``utils.counters`` counter (every kernel launch, in
``ops.kernels.build.run``; the live edge update; the fused AdamW pass's
elements) is counted at the capture, taken back there (the capture
computes nothing) and added on each replay of the graph: every call
counts its work once, eager or replayed. While the launch record is on
(``ops.kernels.build.record_launches``) each capture's launches are kept
in ``launches`` by the graph's key.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ..data.batching import CrystalBatch
from ..ops.kernels import build
from ..utils import counters
from ..utils.profiling import annotate


def signature(batch: CrystalBatch) -> tuple:
    """The shapes of every field of ``batch`` (None for a field that is
    None)."""
    return tuple(None if getattr(batch, f.name) is None
                 else tuple(getattr(batch, f.name).shape)
                 for f in dataclasses.fields(batch))


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    static: object            # inputs, copied in before each replay
    outputs: object           # the work's outputs, the graph's own buffers
    # what its capture counted on the host (``utils.counters``), added on
    # each replay; None where it counted nothing
    counted: dict | None = None


# the side stream of each card, shared by every StepGraphs on it: cuBLAS
# keeps a workspace for each stream it ran on until the process ends, so a
# stream of each StepGraphs's own would leave one behind with every
# dropped trainer, GP fit and serving model
_SIDE_STREAMS: dict[int, torch.cuda.Stream] = {}


def side_stream(device) -> torch.cuda.Stream:
    """The one side stream of ``device`` (made at its first use)."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


class StepGraphs:
    """The CUDA graphs of a piece of work on ``device`` (a training step, a
    GP step, a serving forward), by key (batch signature, the caller's
    key); ``capture_s`` holds each key's capture seconds and, while the
    launch record is on, ``launches`` each key's captured launches. It
    keeps no reference to its owner (whose work comes with each call), so
    an owner that is dropped frees its graphs' memory at once."""

    def __init__(self, device):
        self.device = device
        self.graphs: dict[tuple, _Graph] = {}
        self.capture_s: dict[tuple, float] = {}
        self.launches: dict[tuple, list] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.side = side_stream(device)

    def run(self, work, batch, key=None):
        """``work(batch)`` on the card (``batch`` on the card or the
        host): a replay of the graph of (``batch``'s signature, ``key``)
        after ``batch`` is copied into its inputs, or for a new key the
        eager warm-up, whose outputs are returned, then the capture. A
        replay returns the graph's own output buffers, valid until its
        next replay."""
        key = (signature(batch), key)
        g = self.graphs.get(key)
        if g is None:
            with annotate("capture"):
                return self._first(key, work, batch)
        g.static.copy_(batch)
        with annotate("replay"):
            g.graph.replay()
        if g.counted:
            counters.add(g.counted)
        return g.outputs

    def _first(self, key, work, batch):
        """The eager work on a copy of ``batch`` on the card (the
        warm-up), then the capture of the work on that copy; returns the
        eager work's outputs."""
        static = batch.map(lambda t: torch.empty_like(
            t, device=self.device)).copy_(batch)
        current = torch.cuda.current_stream(self.device)
        # an inference forward (serving) needs no side stream for its
        # warm-up: on the current one, a process that only serves makes no
        # cuBLAS workspace for the side stream
        side = (contextlib.nullcontext() if torch.is_inference_mode_enabled()
                else torch.cuda.stream(self.side))
        self.side.wait_stream(current)
        with side:
            outputs = work(static)
        current.wait_stream(self.side)
        graph = torch.cuda.CUDAGraph()
        launches = [] if build.recording_launches() else None
        before = counters.snapshot()
        t0 = time.perf_counter()
        try:
            with (build.recording(launches) if launches is not None
                  else contextlib.nullcontext()), \
                    torch.cuda.graph(graph, pool=self.pool):
                captured = work(static)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the work as a CUDA graph failed (batch shapes "
                f"{key[0][:2]}, key {key[1]}); the card does not fall back "
                f"to eager work") from e
        self.capture_s[key] = time.perf_counter() - t0
        counted = counters.since(before)
        counters.add(counted, -1)
        self.graphs[key] = _Graph(graph, static, captured, counted or None)
        if launches is not None:
            self.launches[key] = launches
        return outputs
