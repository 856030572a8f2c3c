"""CUDA graphs of the training step, the card's counterpart of the JAX
package's jitted step (``make_train_step``) and, K of them in one call,
of ``make_multi_step`` (``steps_per_dispatch``).

Each training step on the card (``Trainer.train_step``) is one
``replay()`` of a CUDA graph of the whole step (forward, backward,
optimizer update, damping projection), so the host issues one call where
eager PyTorch issues ~2,600 launches. A graph holds for one
batch shape signature (every field's shape: node, edge, graph and
composition slots and the CSR lengths) and one optimizer phase
(``MultiSteps``' mini-step, which the update branches on and divides by
on the host), so graphs are kept by that key; they share one memory pool.

The first step of a key is a real step, run eagerly on a side stream: the
warm-up that capture needs (the kernels' first-launch set-up, cuBLAS's
workspace, the zero gradients of parameters that get none), whose result
is kept. The capture that follows runs nothing. So the trajectory is the
eager one. Before each replay the batch is copied into the graph's static
input buffers; after it the metrics are cloned out of its static outputs,
so successive steps' metrics do not share one buffer. What changes between
steps and enters the arithmetic lives on the device (the optimizers'
count and learning rate, ``training/optim.py``, and the trainer's step
count, which dropout draws its masks from); the host's bookkeeping
(the step count, the mini-step) is advanced after each replay. A failed
capture or replay raises: the card never falls back to eager steps.

On a rank of a parallel world under NCCL the step's collectives (the
metrics' sums, the flat gradients' reduction, and under edge sharding the
boundary exchange and the pool's) are captured with it; the key's eager
first step has initialised the communicators. Every rank of a group
collates to the same shapes, so all ranks capture and replay the same keys
in step. A gloo world is never captured (``Trainer.train_step``).

A replay runs no Python, so what the forward counts on the host in a
``utils.counters`` counter is counted at the capture, taken back there
(the capture computes nothing) and added on each replay of the graph,
only for a graph whose capture counted something. While the launch
record is on (``ops.kernels.build.record_launches``) each capture's
launches are kept in ``launches`` by the graph's key.
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
    static: CrystalBatch      # inputs, copied in before each replay
    metrics: dict             # outputs, cloned out after each replay
    # what its capture counted on the host (``utils.counters``), added on
    # each replay; None where it counted nothing
    counted: dict | None = None


# the side stream of each card, shared by every StepGraphs on it: cuBLAS
# keeps a workspace for each stream it ran on until the process ends, so a
# stream of each StepGraphs's own would leave one behind with every
# dropped trainer and GP fit
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
    """The CUDA graphs of a training step on ``device``, by key (batch
    signature, optimizer phase); ``capture_s`` holds each key's capture
    seconds and, while the launch record is on, ``launches`` each key's
    captured launches. It keeps no reference to the trainer (whose work
    comes with each call), so a trainer that is dropped frees its graphs'
    memory at once; the eager first steps run on the card's one side
    stream (:func:`side_stream`)."""

    def __init__(self, device):
        self.device = device
        self.graphs: dict[tuple, _Graph] = {}
        self.capture_s: dict[tuple, float] = {}
        self.launches: dict[tuple, list] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.side = side_stream(device)

    def step(self, batch: CrystalBatch, phase: int, step_fn, advance) -> dict:
        """One training step on ``batch`` (on the card) in optimizer phase
        ``phase``: ``step_fn(batch)`` is the step's work on the device,
        returning its metrics, and ``advance()`` the host's part. Returns
        the metrics as device scalars of their own."""
        key = (signature(batch), phase)
        g = self.graphs.get(key)
        if g is None:
            with annotate("capture"):
                return self._first_step(key, batch, step_fn, advance)
        g.static.copy_(batch)
        with annotate("replay"):
            g.graph.replay()
        if g.counted:
            counters.add(g.counted)
        advance()
        return {k: v.clone() for k, v in g.metrics.items()}

    def _first_step(self, key, batch: CrystalBatch, step_fn, advance) -> dict:
        """The eager step on ``batch`` (the warm-up), then the capture of
        the step on a copy of it; returns the eager step's metrics."""
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        with torch.cuda.stream(self.side):
            metrics = step_fn(batch)
        current.wait_stream(self.side)
        static = batch.map(torch.clone)
        graph = torch.cuda.CUDAGraph()
        launches = [] if build.recording_launches() else None
        before = counters.snapshot()
        t0 = time.perf_counter()
        try:
            with (build.recording(launches) if launches is not None
                  else contextlib.nullcontext()), \
                    torch.cuda.graph(graph, pool=self.pool):
                out = step_fn(static)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the training step as a CUDA graph failed (batch "
                f"shapes {key[0][:2]}, optimizer phase {key[1]}); the card "
                f"does not fall back to eager steps") from e
        self.capture_s[key] = time.perf_counter() - t0
        counted = counters.since(before)
        counters.add(counted, -1)
        self.graphs[key] = _Graph(graph, static, out, counted or None)
        if launches is not None:
            self.launches[key] = launches
        advance()
        return metrics
