#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cgat_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX. Fourteen phases, any
failure exits non-zero:

1. build the CUDA kernels from ``cgat_tpu_torch/csrc`` with nvcc (sm_90a);
2. hold each forward kernel against its plain PyTorch version on the card
   at the shapes the serving forward gives it, and time both with CUDA
   events; segment_attention through its stream kernel (``streams`` and
   its device kernel's name), timed beside scatter_reduce's
   amax, the exp, two index_add_ sums and the divide (PyTorch calls, a
   yardstick the port never calls), and on ``segment_layout``'s edge
   layouts (empty nodes, an empty tail, one node holding every row, no
   real row, every row real, a 2,000-row node, the request, training and
   GP shapes) in bf16 at H*F = 640 (the stream kernel) and f32 at 13 (the
   per-node kernel), each within the tolerances, its max bit-equal, the
   same bits twice and one launch through the kernel ``streams`` names;
   mh_network in both forms (out, and out with h), bit-identical in
   two launches, and timed beside addmm, leaky ReLU and baddbmm (cuBLAS
   calls, a yardstick the port never calls); hyper_apply bit-identical in
   two launches, with its device time by launch, and timed beside addmm
   for P, bmm of P's weight part with x and the tail added (a yardstick of
   several calls the port never calls); then the pair path of the
   edge-sharded layer (#1 on the local and the halo block, the f32 merge,
   #2 on each block against the merged arrays) at edge shard 0's shapes
   of an edge = 2 collate of request 0, with layer 0's real MH outputs,
   against the plain pair function and its autograd gradient,
   bit-identical in two launches and timed beside its bound; and the
   port's own dropout kernel (forward and backward entry) on a node
   layer's bf16 dropout site of request 0's shape: its masks and outputs
   equal the plain version's bit for bit, twice, timed beside its bound;
3. serve: the reference-default CGAtNet in bf16 (seeded random weights)
   answers 3 requests of 64 crystals through ``ServingModel.predict``,
   each signature's forward a CUDA graph: every request must count
   mh_network x10, segment_attention x6 and hyper_apply x20 and no
   backward kernel, a signature's first (the eager warm-up; its capture's
   counts taken back) and each replay (its capture's counts added); the
   first is timed with its capture and peak memory. A
   replayed request must give the eager warm-up's bits on the same batch
   and launch 10/6/20 (the profiler's device events by kernel name),
   every segment_attention launch through its stream kernel; the
   steady replayed requests are timed beside an eager ServingModel's on
   the same requests. The forward agrees with the port's own bf16 forward
   on the CPU; then one eager request's time is broken down into collate,
   copy, forward and the card's busy time;
4. train: ``cgat_tpu_torch.training.Trainer`` takes 3 checked and 10 timed
   AdamW steps of the same model (f32 master weights, bf16 compute, bf16
   first moment) on batches of 64 crystals. Each checked step must give a
   finite loss and finite grads and launch exactly 10/6/20 forward and
   10/6/20/20/11 backward kernels; the first step's loss must agree with
   the port's own bf16 CPU step. Each backward kernel is then held against
   its plain version on the inputs and cotangents it got in the first step,
   and timed (CUDA events around back-to-back calls, and device time from
   the profiler); mh_network_bwd, hyper_apply_bwd_dhdx,
   hyper_apply_bwd_dk and segment_sum must give bit-identical results in
   two launches; mh_network_bwd and hyper_apply_bwd_dhdx are timed beside
   the same products as bf16 cuBLAS calls, with their device time by
   launch, and hyper_apply_bwd_dk beside dP materialised, dP^T @ hidden
   and dP's column sums (yardsticks of several calls the port never
   calls, timed on events and on the device);
   one step is broken down into collate, copy, forward, backward and
   optimizer, and the card's busy time;
5. cli: the user's path through the command-line entry points, in this
   process (so the launch counts see it) and in a temporary directory:
   384 prototype crystals (``random_structures(0, 384)``) through
   ``cli.prepare`` (the native kNN, held equal to its numpy oracle on the
   first 8), ``cli.train --smoke-test`` with the CLI's defaults (the
   reference-default model at full width and depth, bf16, batch 64: 2
   epochs of 4 steps), ``cli.evaluate``, ``cli.predict`` with and without
   ``--embeddings``, then ``cli.train --ckp <run> --epochs 3``, which must
   start at epoch 2. Each training step on the card replays its batch
   shape's CUDA graph (a shape's first step runs eagerly and is then
   captured), and counts one step's launches either way: each call must
   launch each kernel exactly the count its steps (``cli_steps``) and
   evaluation batches imply, every metric and output must be finite, and
   ``best`` and ``last`` must load; it prints the
   featurisation ms per structure, each epoch's wall time and graphs/s
   (``metrics.jsonl``) and the checkpoint's save and load ms;
6. variants: the hyper-edge model (``no_hyper=False``, the reference
   width and depth, bf16) takes 3 checked steps of 64 crystals in a
   ``Trainer`` (``train_step``), each launching exactly 10/6/36 forward
   and 10/6/36/36/19 backward kernels, captured or replayed (the last
   layer's edge update feeds nothing and is skipped); the card's busy
   time and device events of one of
   its steps; hyper_apply and its two backward kernels held against their
   plain versions on an edge HNet's recorded inputs (at least 18,432 edge
   rows), bit-identical in two launches and timed beside their bounds and
   the yardsticks of phases 2 and 4; its bf16 forward against the CPU's
   on 8 crystals; ``cli.train --hyper-edges --smoke-test`` and
   ``cli.evaluate`` on phase 5's data with exact launches; then 2 steps
   each of ``update_edges=False``, ``dropout=0.1``, ``remat``,
   ``hyper_remat``, ``split_projection``, ``--optim SGD|Adam|LAMB``,
   ``--acc-batches 2``, ``--only-residual`` and a ``--version`` plug-in
   written to the temporary directory, each with a finite loss and its
   own exact launches (``variant_launches``; the dropout variant's steps
   are captured and replayed like the others, the dropout kernel once a
   node layer forward and once backward);
7. dispatch: ``TrainerConfig(steps_per_dispatch=4)`` on phase 4's model
   and traffic, each step of a group a replay of a CUDA graph of the
   step: the replayed steps' losses equal eager steps' bit for bit on the
   same groups; the flat AdamW every run uses and AdamW on the parameters
   as they are give the same bits after one update from the same
   gradients, and the fused AdamW pass the ``_foreach`` sequence's bits
   over 20 updates at the step's gradients (mu bf16 and f32), its device
   ms beside its bound; a replayed step counts and launches
   exactly 10/6/20 forward and 10/6/20/20/11 backward kernels (its
   capture's counts, and device events by kernel name from the profiler)
   and 1 to 3 fused AdamW launches over every parameter (the only
   ``multi_tensor_apply`` events, ``training.optim.fused_stats``);
   eager and replayed step times, the card's busy time, idle share and
   device events a step, the optimizers' host ms and
   ``multi_tensor_apply`` launches, capture seconds and peak memory; the
   replayed step with its groups' collate and copy over one epoch of 7
   groups, iterated inline and through ``PrefetchLoader`` in turns; K = 4
   groups of a ``dropout=0.1`` model, replayed against eager dropout
   steps bit for bit, with a replayed dropout step's launches (profiler)
   and both paths' step times; then ``cli.train --steps-per-dispatch 2
   --smoke-test`` on phase 5's data;
8. parallel: the data-parallel and edge-sharded trainer
   (``TrainerConfig(n_devices, edge_shards)``) on phase 4's model, 64
   crystals a replica: dp = 2 and edge = 2 as two gloo ranks sharing the
   card (spawned processes; eager steps, gloo's collectives staged
   through the host), 3 steps each against one process on the same
   groups, each rank's launches a step exact (edge = 2: 20/10/20 and
   20/10/20/20/19, #1 and #2 all the pair path's) and the boundary
   exchange's
   rows and bytes a layer; under edge = 2 each rank also takes a
   ``dropout=0.1`` forward and backward twice from the same state, whose
   loss and summed gradient must have the same bits (the halo layer's
   and the sharded pool's sums through #8); a one-rank NCCL world
   through the parallel step, its steps after the first replayed with
   the collectives captured, against the one-card trainer; dp = 2 over
   NCCL when there are two cards, else a line saying it was skipped;
9. export: ``cli.export`` on phase 5's run directory, ``load_artifact``
   on the card, phase 3's requests served from it with exact launches
   (one forward's a request: a warm-up and a capture for each signature,
   replays after), the
   predictions within phase 3's bf16 tolerance of that run's trainer's
   own ``predict``;
10. streaming: phase 5's crystals in 4 shards (its validation split
   apart), ``cli.train --streaming --smoke-test`` with single steps and
   with ``--steps-per-dispatch 2``: finite metrics, exact launches for
   the stream's steps, fewer captured keys than steps, graphs/s beside
   phase 5's in-memory epochs;
11. gp: the GP head on phase 4's frozen model over 2,048 crystals at the
   reference GP's settings (500 inducing points, 512 crystals a step):
   #1, #3 and #5 against their plain versions at a 512-crystal batch's
   shapes; ``fit_gp_streaming`` for 2 epochs of 4 steps with exact
   launches (one forward's a step: each batch shape's eager first step
   and capture, replays after); GP steps replayed against eager ones on
   the card bit for bit,
   a replayed step's launches (10/6/20 forward, no backward kernel), step
   ms, busy ms, idle share and peak memory; on 512 crystals, one batch an
   epoch, the on-the-fly history against ``Trainer.embeddings`` +
   ``fit_gp`` (rtol 1e-4, atol 1e-5); ``cli.train_gp`` on phase 5's run,
   precomputed and ``--on-the-fly``, with exact launches;
12. active_learning: ``cgat_tpu_torch.tools`` on 1,024 prototype
   crystals (``random_structures``, the port's featuriser, 4 shards of
   256): a Metropolis initial sample of 256, then three rounds of
   ``active_learning_round`` with the reference-default model (bf16,
   batch 64, 2 epochs): ranked by error, by an SVGP's predictive std on
   the sample's frozen embeddings (64 inducing points, 30 epochs), and by
   error from round 2's weights; each absorbs 128. The sample must grow
   256, 384, 512, 640 and the pool shrink as much, with no id in both;
   round 1's pool errors agree with the same run's f32 forward on the
   CPU (rtol 5e-2, atol 5e-2 x max); every kernel launches in the phase,
   each backward kernel in every round's training; the card's allocated
   memory after rounds 2 and 3 (trainers and GP fit dropped) stays within
   4 MiB of round 1's; then ``tools.embeddings`` over the final sample and
   the ``tools.tsne`` CLI on the card; each round's seconds split into
   train, score (the GP fit's apart) and absorb;
13. tools: slices 8c and 9 on phase 5's data and run: ``tools.ensemble``
   trains two seeds (each member's exact launches, the card's allocated
   memory after member 2 within 4 MiB of member 1's), predicts,
   summarizes (finite columns, a nonzero spread) and soups them (the
   members' f64 mean cast to f32, to the bit; ``cli.predict`` on the
   soup); phase 5's run exported to a reference ``.ckpt`` and imported
   back (the same weights and the same predictions on the card, bit for
   bit); ``cli.train --profile-epoch 0`` and ``1`` (a capturing and a
   replay-only epoch), each trace holding every kernel's device events
   and a ``train_step`` span a step; ``utils.roofline``'s ``measure_*``
   (each bound the one phases 2 and 4 print, #1 also with its stats at
   the training step's shapes and at a GP batch; no share above 1.05);
   ``tools.step_trace`` (its categories adding up to its total, within 5
   % of phase 7's busy ms);
14. report the card, and the nine kernels as one JSON line (with their
   launches in phases 5 and 6 as ``cli_launches`` and
   ``variants_launches``, a replayed step's as ``replay_launches``, a
   rank's a step in phase 8 as ``parallel_launches``, the pair path's
   as ``pair_launches`` with its phase-2 check as ``pair_path``, #5
   to #7 at the edge rows as ``edge_rows``, a replayed request's as
   ``serve_replay_launches``, phase 9's as ``export_launches``, phase
   10's as ``streaming_launches``, phase 11's fit as ``gp_launches``,
   phase 12's as ``al_launches`` and phase 13's as ``tools_launches``;
   the dropout row's launches, forward and backward, are phase 6's
   dropout steps'); the last
   line is ``{"ok": true, "device": {...}}``.

Device time comes from ``cgat_tpu_torch.utils.profiling.device_ms`` and
every bound from ``cgat_tpu_torch.utils.roofline``'s work functions, as in
the tools; ``chip_variants.py`` reads ``device_ms`` from here.

Each phase's start goes to stderr with the seconds since start, so a run
that is stopped shows how far it got; past ``WATCHDOG_S`` seconds the
script prints every thread's stack to stderr and exits with 1.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import faulthandler
import gc
import glob
import gzip
import io
import json
import math
import os
import pickle
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from cgat_tpu_torch.device import card_line
from cgat_tpu_torch.ops.kernels import ENTRIES
from cgat_tpu_torch.utils import counters, roofline
from cgat_tpu_torch.utils.profiling import device_ms
from cgat_tpu_torch.utils.roofline import (BF16_TENSOR_FLOPS, F32_FLOPS,
                                           bound, hyper_work)

N_GRAPHS = 64                  # crystals per request and per batch
N_REQUESTS = 3
N_TIMED = 10                   # extra timed requests after the checked ones
N_TRAIN_GRAPHS = 320           # 256 in the training split: 4 batches of 64
N_CHECKED_STEPS = 3
N_TIMED_STEPS = 10
N_CLI_STRUCTURES = 384         # 307 in the training split: 4 batches of 64
N_NATIVE_CHECKED = 8           # structures held native == numpy
WATCHDOG_S = 1080             # past this, dump every thread's stack and exit
KERNEL_TOL = 2e-2              # kernel vs plain, times max|plain| (bf16 I/O)
NORM_TOL = 1e-2                # ||kernel - plain|| / ||plain|| per output
MODEL_RTOL = 5e-2              # card vs CPU forward (bf16 end to end)
PER_FORWARD = {"mh_network": 10, "segment_attention": 6, "hyper_apply": 20}
PER_BACKWARD = {"mh_network_bwd": 10, "segment_attention_bwd": 6,
                "hyper_apply_bwd_dhdx": 20, "hyper_apply_bwd_dk": 20,
                "segment_sum": 11}
N_VARIANT_STEPS = 2
N_CPU_CHECK_GRAPHS = 8         # crystals of the hyper-edge CPU cross-check
MIN_EDGE_ROWS = 18432          # edge rows #5 to #7 are held at, at least
PLUGIN = "chip_smoke_plugin"   # the --version module the variants phase writes
N_DISPATCH = 4                 # steps a dispatch in phase 7
N_DISPATCH_CHECKED = 2         # groups held graph against eager
N_DISPATCH_TIMED = 20          # resident steps timed on each path
N_DISPATCH_LOOP = 6            # groups timed with their collate and copy
N_PARALLEL_STEPS = 3           # steps of each world in phase 8
N_PARALLEL_REPLAYS = 4         # replayed steps of the one-rank NCCL world
N_SHARDS = 4                   # shards phase 10 streams phase 5's crystals from
DROPOUT = 0.1                  # the rate of the dropout steps (phases 2, 6, 7)
N_GP_GRAPHS = 2048             # the GP phase's pool of crystals
GP_BATCH = 512                 # crystals a GP step (cli.train_gp's default)
GP_INDUCING = 500              # inducing points (cli.train_gp's default)
GP_EPOCHS = 2                  # epochs of the on-the-fly fit: 4 steps each
GP_CHECKED = 4                 # GP steps held replayed against eager
GP_CHECK_POOL = 512            # the pool of the on-the-fly-vs-precomputed check
GP_CHECK_EPOCHS = 5
GP_CLI_EPOCHS = 10             # epochs of each cli.train_gp call
GP_RTOL, GP_ATOL = 1e-4, 1e-5  # on-the-fly vs precomputed (tests/test_gp.py)
AL_POOL = 1024                 # prototype structures in phase 12's pool
AL_SHARDS = 4                  # pool shards of AL_POOL / AL_SHARDS each
AL_INITIAL = 256               # the Metropolis initial sample
AL_NEW = 128                   # entries absorbed a round
AL_EPOCHS = 2                  # training epochs a round
AL_GP = dict(num_inducing=64, epochs=30, batch_size=256)  # round 2's fit
AL_MEMORY_TOL = 4 << 20        # bytes a later round may hold above round 1
ENSEMBLE_SEEDS = (0, 1)        # phase 13's ensemble members
ENSEMBLE_MEMORY_TOL = 4 << 20  # bytes member 2 may hold above member 1
TRACE_BUCKET = 768             # phase 13's traced runs: one batch shape
SHARE_LIMIT = 1.05             # a kernel's share of its roofline, at most
STEP_TRACE_TOL = 0.05          # step_trace's total against phase 7's busy ms
N_FUSED_CHECKED = 20           # updates the fused AdamW is held bit-equal over
FUSED_ADAMW = "adamw_multi_tensor_apply_kernel"  # its device kernel's name
# a substring (or substrings) of the name of the device kernel each entry
# launches (a fixed number of times a call): phases 3, 7 and 11 count a
# replay's device events by these names
REPLAY_KERNELS = {"segment_attention": "segment_attention_fwd",
                  "mh_network": "sm90::gemm_kernel<",
                  "hyper_apply": "fwd::kernel(",
                  "segment_attention_bwd": "segment_attention_bwd",
                  "mh_network_bwd": "pass_a::kernel(",
                  "hyper_apply_bwd_dhdx": "dhdx::bwd_kernel(",
                  "hyper_apply_bwd_dk": "dk::kernel(",
                  "segment_sum": "segment_sum_kernel",
                  "dropout": ("dropout_fwd_kernel", "dropout_bwd_kernel")}


def dropout_backward(n: int) -> dict[str, int]:
    """The backward kernels (and, under ``segment_sum``, every segment sum
    of the step) of an ``n``-layer default model's training step under
    dropout: no MH backward kernel (the einsum path), #2 for the pool
    alone, the dropout kernel once a layer, and 6n + 1 segment sums (the
    node gathers' 2n and the pool's one, the softmax's 2n sums forward and
    its 2n gathers' backward)."""
    return {"mh_network_bwd": 0, "segment_attention_bwd": 1,
            "hyper_apply_bwd_dhdx": 4 * n, "hyper_apply_bwd_dk": 4 * n,
            "segment_sum": 6 * n + 1, "dropout": n}


def variant_launches(n: int):
    """Kernel launches a training step of an ``n``-layer model: the
    hyper-edge model's (forward, backward), and for each variant of phase
    6 (name, CGATConfig fields, TrainerConfig fields, forward kernels with
    the backward's recomputes, backward kernels)."""
    fwd = {"mh_network": 2 * n, "segment_attention": n + 1,
           "hyper_apply": 4 * n}
    bwd = {"mh_network_bwd": 2 * n, "segment_attention_bwd": n + 1,
           "hyper_apply_bwd_dhdx": 4 * n, "hyper_apply_bwd_dk": 4 * n,
           "segment_sum": 2 * n + 1}
    # the edge HNets add 4 hyper_apply launches a layer to the forward, and
    # their gathers 2 segment sums to the backward; the last layer's edge
    # update feeds nothing and is skipped, so n - 1 layers add them
    hyper_edge = ({**fwd, "hyper_apply": 8 * n - 4},
                  {**bwd, "hyper_apply_bwd_dhdx": 8 * n - 4,
                   "hyper_apply_bwd_dk": 8 * n - 4,
                   "segment_sum": 4 * n - 1})
    table = (
        ("update_edges=False", {"update_edges": False}, {}, fwd, bwd),
        # node layers leave the flat path: segment softmax and sum as torch
        # ops around the dropout kernel (one a layer, forward and
        # backward), the MH nets on the einsum path; the crystal pool keeps
        # the segment-attention kernel. The softmax's denominator and the
        # weighted sum are segment sums (2 a layer in the forward), its two
        # gathers take segment sums as their backward (2 more a layer)
        (f"dropout={DROPOUT}", {"dropout": DROPOUT}, {},
         {**fwd, "mh_network": 0, "segment_attention": 1, "dropout": n},
         dropout_backward(n)),
        # every node layer's forward runs again in the backward
        ("remat", {"remat": True}, {},
         {"mh_network": 4 * n, "segment_attention": 2 * n + 1,
          "hyper_apply": 8 * n}, bwd),
        ("hyper_remat", {"hyper_remat": True}, {},
         {**fwd, "hyper_apply": 8 * n}, bwd),
        # the einsum path on per-node projections: no mh_network, no node
        # gather (the crystal pool's stays)
        ("split_projection", {"split_projection": True}, {},
         {**fwd, "mh_network": 0},
         {**bwd, "mh_network_bwd": 0, "segment_sum": 1}),
        ("--optim SGD", {}, {"optim": "SGD"}, fwd, bwd),
        ("--optim Adam", {}, {"optim": "Adam"}, fwd, bwd),
        ("--optim LAMB", {}, {"optim": "LAMB"}, fwd, bwd),
        ("--acc-batches 2", {}, {"acc_batches": 2}, fwd, bwd),
        # only the output head trains: no backward reaches a kernel
        ("--only-residual", {}, {"only_residual": True}, fwd,
         dict.fromkeys(bwd, 0)),
        ("--version", {}, {"version": PLUGIN}, fwd, bwd),
    )
    return hyper_edge, table


PLUGIN_SOURCE = """
import torch

from cgat_tpu_torch.models import CGAtNet as _Base


class CGAtNet(_Base):
    \"\"\"A model plug-in: the port's CGAtNet, its output head's second
    column (log_std) clamped to [-10, 10].\"\"\"

    def head(self, crys_fea, *, last_layer=True):
        out = super().head(crys_fea, last_layer=last_layer)
        return out if not last_layer else torch.cat(
            [out[:, :1], out[:, 1:].clamp(-10.0, 10.0)], dim=1)
"""
REPLACES = {
    "segment_attention": "cgat_tpu/ops/pallas/segment_attention.py:82",
    "mh_network": "cgat_tpu/ops/pallas/mh_network.py:63",
    "hyper_apply": "cgat_tpu/ops/pallas/hyper_apply.py:82",
    "segment_attention_bwd": "cgat_tpu/ops/pallas/segment_attention.py:197",
    "mh_network_bwd": "cgat_tpu/ops/pallas/mh_network.py:87",
    "hyper_apply_bwd_dhdx": "cgat_tpu/ops/pallas/hyper_apply.py:182",
    "hyper_apply_bwd_dk": "cgat_tpu/ops/pallas/hyper_apply.py:221",
    "segment_sum": "cgat_tpu/ops/pallas/segment_sum.py:38",
    # no TPU kernel: cgat_tpu drops with flax's nn.Dropout (XLA's RNG)
    "dropout": "none (cgat_tpu/models/cgat.py:253 nn.Dropout)",
    # nor for the update: cgat_tpu leaves optax's AdamW to XLA
    "adamw": "none (cgat_tpu/training/trainer.py:141 optax.adamw, XLA's)",
}
SOURCES = {"segment_attention": "segment_attention", "mh_network": "mh_network",
           "hyper_apply": "hyper_apply",
           "segment_attention_bwd": "segment_attention",
           "mh_network_bwd": "mh_network", "hyper_apply_bwd_dhdx": "hyper_apply",
           "hyper_apply_bwd_dk": "hyper_apply", "segment_sum": "segment_sum",
           "dropout": "dropout", "adamw": "adamw"}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


_T0 = time.perf_counter()


def progress(msg: str) -> None:
    """A line on stderr with the seconds since start, so that a run that is
    stopped shows on stderr how far it got."""
    print(f"[chip_smoke {time.perf_counter() - _T0:7.1f} s] {msg}",
          file=sys.stderr, flush=True)


def time_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def hyper_yardsticks(hidden, k, bias, x, g, o) -> dict:
    """Per kernel, cuBLAS and PyTorch calls computing what #5, #6 and #7
    compute (several calls, not one: a yardstick the port never calls):
    P materialised by addmm, bmm of its weight part with x and its tail
    added (#5); addmm for P, the g product and the sum over o, and
    [dP | g] @ K materialised (#6); dP materialised, dP^T @ hidden and
    dP's column sums (#7)."""
    b, i = x.shape
    w = o * i

    def fwd():
        p = torch.addmm(bias, hidden, k.T)
        y = torch.bmm(p[:, :w].view(b, o, i), x.view(b, i, 1))
        y.view(b, o) + p[:, w:]

    def dhdx():
        p = torch.addmm(bias[:w], hidden, k[:w].T)
        (p.view(b, o, i) * g[:, :, None]).float().sum(1).to(x.dtype)
        dp = torch.cat([(g[:, :, None] * x[:, None, :]).reshape(b, w), g],
                       1)
        torch.matmul(dp, k)

    def dk():
        dp = (g[:, :, None] * x[:, None, :]).reshape(b, w)
        torch.matmul(dp.T, hidden)
        dp.float().sum(0)
    return {"hyper_apply": fwd, "hyper_apply_bwd_dhdx": dhdx,
            "hyper_apply_bwd_dk": dk}


def attention_yardstick(alpha, m, offn, n_real, num_nodes):
    """PyTorch calls computing what #1 computes, on the real rows (several
    calls, not one: a yardstick the port never calls): the per-node max by
    ``scatter_reduce_`` (amax), the exp, the two segment sums by
    ``index_add_`` and the divide."""
    from cgat_tpu_torch.ops.segment import NEG_BIG, SOFTMAX_EPS

    off = torch.clamp(offn[:num_nodes + 1].long(), max=int(n_real))
    lo, hi = int(off[0]), int(off[-1])
    ids = torch.repeat_interleave(torch.arange(num_nodes, device=off.device),
                                  off[1:] - off[:-1], output_size=hi - lo)
    a, mm = alpha[lo:hi], m[lo:hi]
    idx = ids[:, None].expand(-1, alpha.shape[1])
    shape = (num_nodes, alpha.shape[1])

    def run():
        af = a.float()
        mx = torch.full(shape, NEG_BIG, device=a.device).scatter_reduce_(
            0, idx, af, "amax")
        ex = torch.exp(af - mx[ids])
        den = torch.zeros(shape, device=a.device).index_add_(0, ids, ex)
        num = torch.zeros(shape, device=a.device).index_add_(
            0, ids, ex * mm.float())
        return (num / (den + SOFTMAX_EPS)).to(alpha.dtype)
    return run


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since the counts were last set to 0
    (``counters.reset()``), by its wrapper's name (``ENTRIES``): the eager
    ones and, since a replay adds what its graph's capture counted, the
    replayed ones."""
    from cgat_tpu_torch.ops.kernels import build
    counts = build.launch_counts()
    return {name: counts.get(entry, 0) for name, entry in ENTRIES.items()}


def scaled(*tables) -> dict[str, int]:
    """Each kernel's launches in (counts, times) pairs, summed: 0 for a
    kernel no table names."""
    out = dict.fromkeys(ENTRIES, 0)
    for counts, times in tables:
        for k, v in counts.items():
            out[k] += v * times
    return out


def compare(name: str, got, want) -> dict:
    """One output of a kernel against its plain version: elementwise within
    KERNEL_TOL x max|plain| and, so that small entries count too, norm-wise
    within NORM_TOL of the plain version's norm. Returns the numbers and
    their scales."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    diff_norm = float(torch.linalg.vector_norm(got - want))
    norm = float(torch.linalg.vector_norm(want))
    rel = diff_norm / norm if norm > 0 else (0.0 if diff_norm == 0 else
                                              float("inf"))
    if err > KERNEL_TOL * scale:
        fail(f"{name}: max |kernel - plain| {err:.3e} > {KERNEL_TOL} * "
             f"max|plain| ({scale:.3e})")
    if rel > NORM_TOL:
        fail(f"{name}: ||kernel - plain|| / ||plain|| {rel:.3e} > {NORM_TOL} "
             f"(||plain|| {norm:.3e})")
    return {"max_abs_err": err, "max_abs_plain": scale, "rel_norm_err": rel,
            "norm_plain": norm}


def checks_row(checks: list[dict]) -> dict:
    """A kernel's comparisons (one per output and input case) for its row:
    the largest errors, and every comparison with its scale."""
    return {"max_abs_err": max(c["max_abs_err"] for c in checks),
            "rel_norm_err": max(c["rel_norm_err"] for c in checks),
            "checks": checks}


def deterministic(name: str, fn) -> bool:
    """Two launches on the same inputs must give the same bits."""
    first, second = fn(), fn()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"{name}: two launches on the same inputs differ")
    return True


def scales(row: dict) -> str:
    return ", ".join(f"{c['max_abs_plain']:.3e}" for c in row["checks"])


def report(rows: list[dict]) -> None:
    """Print each kernel row: its checks, times, bound and yardsticks."""
    for r in rows:
        print(f"[kernels] {r['name']} {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.3e} (tol {KERNEL_TOL} x max|plain|, "
              f"max|plain| {scales(r)}), norm-wise {r['rel_norm_err']:.3e} "
              f"(tol {NORM_TOL}), "
              f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms"
              + (f", index_add_ {r['library_ms']:.4f} ms (device "
                 f"{fmt_ms(r['library_device_ms'])})"
                 if r.get("library_ms") is not None else "")
              + (f", pool shape {r['pool_ms']:.4f} ms" if "pool_ms" in r
                 else "")
              + (", two launches bit-identical" if r.get("deterministic")
                 else ""))
        if "cublas_ms" in r:
            print(f"[kernels] {r['name']}: {r['cublas_what']}, a yardstick "
                  f"the port never calls: {r['cublas_ms']:.4f} ms"
                  + (f" (device {fmt_ms(r['cublas_device_ms'])})"
                     if "cublas_device_ms" in r else ""))
        for name, ms in r.get("device_split", {}).items():
            print(f"[kernels] {r['name']} device time by kernel: "
                  f"{ms:.4f} ms  {name}")


def build_kernels() -> None:
    from cgat_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    print(f"[build] {len(info)} kernels in {time.perf_counter() - t0:.1f} s "
          f"({build.BUILD_DIR})")
    # one line a source: ptxas's full report stays in its .log beside the
    # library, so that stdout stays short
    for name, rec in info.items():
        log = rec["log"]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", log))
        print(f"[build] {name}: {log.count('entry function')} entry "
              f"functions, {min(regs, default=0)}-{max(regs, default=0)} "
              f"registers, {spills} bytes spilled")


def check_kernels(model, batch) -> list[dict]:
    """Phase 2: each kernel vs its plain version at the serving shapes, with
    the first message-passing layer's weights and real activations."""
    from cgat_tpu_torch.ops.kernels import hyper_apply as hk
    from cgat_tpu_torch.ops.kernels import mh_network as mk
    from cgat_tpu_torch.ops.kernels import segment_attention as sk

    node = model.graphs[0].Node
    rows = []
    with torch.inference_mode():
        x = model.embedding(batch.nodes)
        e_attr = model.nbr_embedding(batch.edge_shell)
        m_cat = torch.cat([x[batch.edge_dst], e_attr, x[batch.edge_src]], -1)
        n_edges, cat = m_cat.shape
        n_nodes = x.shape[0]

        # mh_network: MH_A and MH_M of layer 0 on the real edge features
        def mh_args(net):
            H, hid, f = net.nb_heads, net.hidden_layer_dim, net.output_dim
            return (m_cat, net.fc_in.weight.view(H * hid, cat),
                    net.fc_in.bias, net.fc_out.weight.view(H * f, hid),
                    net.fc_out.bias, H)
        args_a, args_m = mh_args(node.MH_A), mh_args(node.MH_M)
        alpha = mk.mh_network(*args_a)
        msg = mk.mh_network(*args_m)
        checks = [compare("mh_network", alpha, mk.mh_network_plain(*args_a)),
                  compare("mh_network", msg, mk.mh_network_plain(*args_m))]
        # the training form: out and the hidden activation h
        out_t, h_t = mk.mh_network(*args_a, return_hidden=True)
        p_out, p_h = mk.mh_network_plain(*args_a, return_hidden=True)
        checks += [compare("mh_network", out_t, p_out),
                   compare("mh_network", h_t, p_h)]
        if not torch.equal(out_t, alpha):
            fail("mh_network: the serving and training forms differ")
        H, hid, f = node.MH_A.nb_heads, node.MH_A.hidden_layer_dim, \
            node.MH_A.output_dim
        x_a, win, b_in, wout, b_out, _ = args_a

        # addmm, leaky ReLU, per-head baddbmm as bf16 cuBLAS and PyTorch
        # calls: a yardstick (three calls, not one), never called by the port
        def cublas():
            p = torch.nn.functional.leaky_relu_(
                torch.addmm(b_in, x_a, win.T), mk.LEAKY_SLOPE)
            torch.baddbmm(b_out.view(H, 1, f), p.view(-1, H, hid).transpose(
                0, 1), wout.view(H, f, hid).transpose(1, 2))
        b_ms, b_by = bound(*roofline.mh_network_work(n_edges, cat, H, hid,
                                                     f), BF16_TENSOR_FLOPS)
        rows.append({"name": "mh_network", "shape": [n_edges, cat, H * hid,
                                                     H * f],
                     **checks_row(checks),
                     "ms": time_ms(lambda: mk.mh_network(*args_a)),
                     "device_ms": kernel_device_ms(
                         lambda: mk.mh_network(*args_a)),
                     "plain_ms": time_ms(lambda: mk.mh_network_plain(*args_a)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "deterministic": deterministic(
                         "mh_network",
                         lambda: mk.mh_network(*args_a, return_hidden=True)),
                     "cublas_ms": time_ms(cublas),
                     "cublas_device_ms": kernel_device_ms(cublas),
                     "cublas_what": "addmm, leaky ReLU and baddbmm (bf16 "
                                    "cuBLAS and PyTorch calls)",
                     "device_split": kernel_device_ms(
                         lambda: mk.mh_network(*args_a), split=True)})

        # segment_attention: the layer-0 aggregation (edges -> nodes) and the
        # crystal pool's shape (nodes -> crystals)
        n_real = batch.edge_mask.sum(dtype=torch.int32)
        seg_args = (alpha, msg, batch.edge_dst_offn, n_real, n_nodes)
        out, mx, den = sk.segment_attention(*seg_args, return_stats=True)
        if not sk.streams(alpha.shape[1], alpha.element_size(), alpha, msg,
                          out, mx, den):
            fail("segment_attention: the main path's call does not take the "
                 "stream kernel")
        p_out, p_mx, p_den = sk.segment_attention_plain(*seg_args)
        checks = [compare("segment_attention", out, p_out)]
        if not torch.equal(mx, p_mx):
            fail("segment_attention: per-node max differs from the plain "
                 "version")
        torch.testing.assert_close(den, p_den, rtol=1e-4, atol=1e-6)
        hf = alpha.shape[1]
        n_pool = int(batch.node_mask.sum())
        gen = torch.Generator(device=x.device).manual_seed(0)
        pa = torch.randn(n_nodes, hf, generator=gen,
                         device=x.device).to(torch.bfloat16)
        pm = torch.randn(n_nodes, hf, generator=gen,
                         device=x.device).to(torch.bfloat16)
        pool_args = (pa, pm, batch.node2graph_offn,
                     batch.node_mask.sum(dtype=torch.int32),
                     batch.num_graphs)
        checks.append(compare("segment_attention",
                              sk.segment_attention(*pool_args),
                              sk.segment_attention_plain(*pool_args)[0]))
        b_ms, b_by = bound(*roofline.segment_attention_work(
            int(n_real), hf, n_nodes, stats=False), F32_FLOPS)
        yard = attention_yardstick(*seg_args)
        compare("segment_attention yardstick", yard(), p_out)
        split = kernel_device_ms(lambda: sk.segment_attention(*seg_args),
                                 split=True)
        if not any("segment_attention_fwd_stream" in k for k in split):
            fail(f"segment_attention: the stream kernel is not among the "
                 f"call's device kernels {list(split)}")
        rows.append({"name": "segment_attention",
                     "shape": [n_edges, hf, n_nodes], **checks_row(checks),
                     "ms": time_ms(lambda: sk.segment_attention(*seg_args)),
                     "device_ms": kernel_device_ms(
                         lambda: sk.segment_attention(*seg_args)),
                     "plain_ms": time_ms(
                         lambda: sk.segment_attention_plain(*seg_args)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "deterministic": deterministic(
                         "segment_attention",
                         lambda: sk.segment_attention(*seg_args,
                                                      return_stats=True)),
                     "pool_ms": time_ms(lambda: sk.segment_attention(
                         *pool_args)),
                     "cublas_ms": time_ms(yard),
                     "cublas_device_ms": kernel_device_ms(yard),
                     "cublas_what": "scatter_reduce_ (amax), exp, two "
                                    "index_add_ sums and the divide "
                                    "(PyTorch calls)",
                     "device_split": split})

        # hyper_apply: layer 0's first HyperLinear on the real node features
        hl = node.Pooling_NN.Hyper.layers[0].hyper_linear
        last = hl.hypo_params.net[-1]
        hidden = hl.hypo_params.hidden(x).contiguous()
        h_args = (hidden, last.weight, last.bias, x.contiguous(), hl.out_ch)
        checks = [compare("hyper_apply", hk.hyper_apply(*h_args),
                          hk.hyper_apply_plain(*h_args))]
        C, I, O = hidden.shape[1], hl.in_ch, hl.out_ch
        b_ms, b_by = bound(*hyper_work(n_nodes, C, I, O)["hyper_apply"],
                           BF16_TENSOR_FLOPS)
        cublas_h = hyper_yardsticks(*h_args[:4], None, O)["hyper_apply"]
        rows.append({"name": "hyper_apply", "shape": [n_nodes, C, I, O],
                     **checks_row(checks),
                     "ms": time_ms(lambda: hk.hyper_apply(*h_args)),
                     "device_ms": kernel_device_ms(
                         lambda: hk.hyper_apply(*h_args)),
                     "plain_ms": time_ms(lambda: hk.hyper_apply_plain(*h_args)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "deterministic": deterministic(
                         "hyper_apply",
                         lambda: (hk.hyper_apply(*h_args),)),
                     "cublas_ms": time_ms(cublas_h),
                     "cublas_device_ms": kernel_device_ms(cublas_h),
                     "cublas_what": "addmm for P, bmm of its weight part "
                                    "with x and the tail added (bf16 cuBLAS "
                                    "and PyTorch calls)",
                     "device_split": kernel_device_ms(
                         lambda: hk.hyper_apply(*h_args), split=True)})
    report(rows)
    return rows


def check_attention_layouts() -> dict:
    """Phase 2: #1 on each of ``segment_layout``'s edge layouts, in bf16 at
    H*F = 640 (rows of whole 16-byte groups: the stream kernel) and f32 at
    13 (the per-node kernel), seeded random rows: within the tolerances of
    the plain version, its max bit-equal and its den within rtol 1e-4, the
    same bits twice, and one launch, through the kernel ``streams``
    names."""
    from cgat_tpu_torch.data.synthetic import SEGMENT_LAYOUTS, segment_layout
    from cgat_tpu_torch.ops.kernels import segment_attention as sk

    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {}
    with torch.inference_mode():
        for kind in SEGMENT_LAYOUTS:
            offn, n_real, n = segment_layout(kind)
            for dtype, hf, route in ((torch.bfloat16, 640, "stream"),
                                     (torch.float32, 13, "per_node")):
                e = int(offn[-1])
                args = ((torch.randn(e, hf, generator=gen, device="cuda")
                         * 3).to(dtype),
                        torch.randn(e, hf, generator=gen,
                                    device="cuda").to(dtype),
                        torch.from_numpy(offn).cuda(),
                        torch.tensor(n_real, dtype=torch.int32,
                                     device="cuda"), n)
                name = f"segment_attention {kind} {str(dtype)[6:]} {hf}"
                counters.reset()
                out, mx, den = sk.segment_attention(*args, return_stats=True)
                got = launch_counts()["segment_attention"]
                took = "stream" if sk.streams(hf, args[0].element_size(),
                                              *args[:2], out, mx, den) \
                    else "per_node"
                if got != 1 or took != route:
                    fail(f"{name}: {got} launches of the {took} kernel, not "
                         f"one of the {route} kernel")
                p_out, p_mx, p_den = sk.segment_attention_plain(*args)
                check = compare(name, out, p_out)
                if not torch.equal(mx, p_mx):
                    fail(f"{name}: per-node max differs from the plain "
                         f"version")
                torch.testing.assert_close(den, p_den, rtol=1e-4, atol=1e-6)
                deterministic(name, lambda: sk.segment_attention(
                    *args, return_stats=True))
                res[f"{kind} {str(dtype)[6:]} {hf}"] = {
                    "rows": e, "real_rows": n_real, "nodes": n,
                    "kernel": route, **check}
    worst = max(res.values(), key=lambda r: r["rel_norm_err"])
    print(f"[kernels] segment_attention on {len(SEGMENT_LAYOUTS)} edge "
          f"layouts x (bf16 640: stream, f32 13: per-node): each within "
          f"tolerance (worst norm-wise {worst['rel_norm_err']:.3e}), max "
          f"bit-equal, the same bits twice, one launch each through its "
          f"kernel")
    return res


def check_dropout(cfg, n_edges: int) -> dict:
    """Phase 2's dropout row: both entry points (forward, backward) on a
    bf16 (E, H, F) tensor at a node layer's dropout site (E the request's
    edge slots) against the plain version: the same masks and outputs bit
    for bit, the same bits twice, at a step past 2**32; timed beside the
    bound on bytes (x read once, out written once) and the plain
    version."""
    from cgat_tpu_torch.ops.kernels import dropout as dk

    shape = (n_edges, cfg.msg_heads, cfg.elem_fea_len)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    ones = torch.ones_like(x)
    step = torch.tensor(2 ** 32 + 12345, dtype=torch.int64, device="cuda")
    key = dk.site_key(0, 0)
    checks = []
    with torch.inference_mode():
        want_mask = dk.keep_mask(x.numel(), key, step,
                                 dk.keep_threshold(DROPOUT)).view(shape)
        for fn in (dk.dropout, dk.dropout_bwd):
            got = fn(x, DROPOUT, key, step)
            want = dk.dropout_plain(x, DROPOUT, key, step)
            if not torch.equal(fn(ones, DROPOUT, key, step) != 0, want_mask):
                fail(f"{fn.__name__}: its mask differs from the plain "
                     f"version's")
            if not torch.equal(got, want):
                fail(f"{fn.__name__}: its output differs from the plain "
                     f"version's")
            deterministic(fn.__name__, lambda: (fn(x, DROPOUT, key, step),))
            checks.append(compare(fn.__name__, got, want))
        kept = float(want_mask.float().mean())
        b_ms, b_by = bound(*roofline.dropout_work(x.numel()), F32_FLOPS)
        row = {"name": "dropout", "shape": list(shape), **checks_row(checks),
               "masks_equal": True, "deterministic": True,
               "kept_share": kept,
               "ms": time_ms(lambda: dk.dropout(x, DROPOUT, key, step)),
               "device_ms": kernel_device_ms(
                   lambda: dk.dropout(x, DROPOUT, key, step)),
               "plain_ms": time_ms(
                   lambda: dk.dropout_plain(x, DROPOUT, key, step), reps=3),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    report([row])
    print(f"[kernels] dropout: masks and outputs equal the plain version's "
          f"bit for bit (forward and backward), kept share {kept:.5f} at "
          f"rate {DROPOUT}; Philox's integer work is not in the bound")
    return row


def serving_manifest(requests) -> dict:
    """Phase 3's manifest: one signature of 64 crystals a multiple of 64
    node slots up to the largest request, mean 0 and std 1."""
    from cgat_tpu_torch.data import pad_to_bucket

    max_atoms = max(sum(g.n_atoms for g in r) for r in requests)
    sigs = [{"key": f"c{N_GRAPHS}_n{n}", "num_graphs": N_GRAPHS,
             "num_node_slots": n, "num_edge_slots": n * 24,
             "num_comp_slots": 8}
            for n in range(64, pad_to_bucket(max_atoms, 64) + 1, 64)]
    return {"mean": 0.0, "std": 1.0, "signatures": sigs,
            "collate": {"max_nbr": 24, "orig_fea": 200}}


def settled_allocated() -> int:
    """The card's allocated bytes once every dropped object is collected
    and the cache emptied."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def forward_events_a_call(server, graphs) -> dict[str, float]:
    """Device events a wrapper call of each forward kernel, from the
    profiler over eager requests (``server.graphs`` None)."""
    counters.reset()
    prof = device_ms(lambda: server.predict(graphs), 3)
    calls = {k: v / 3 for k, v in launch_counts().items() if v}
    if calls != PER_FORWARD:
        fail(f"eager requests launched {calls} a request, not {PER_FORWARD}")
    if not prof:
        fail("the profiler recorded no device events")
    per_call = {k: v / calls[k] for k, v in kernel_events(prof).items()
                if k in PER_FORWARD}
    if any(v < 1 or v != round(v) for v in per_call.values()):
        fail(f"device events a call {per_call} are not whole numbers")
    return per_call


def serve(model, requests, card: str) -> tuple[dict, dict]:
    """Phase 3: answer the requests through ``ServingModel.predict`` on the
    card, each signature's forward a replayed CUDA graph. Every request
    must count one forward's launches, a signature's first (the eager
    warm-up; its capture's counts taken back) and each replay (its
    capture's counts added); a replay must give the warm-up's bits on the
    same batch and, by the profiler's device events by kernel name,
    launch 10/6/20, segment_attention's through its stream kernel. Each
    signature's first request is timed with its capture and peak memory;
    the steady replayed requests beside an eager ServingModel's on the
    same requests."""
    from cgat_tpu_torch.serving import ServingModel

    manifest = serving_manifest(requests)
    allocated = settled_allocated()
    server = ServingModel(manifest, model)
    want = scaled((PER_FORWARD, 1))
    launches = scaled()
    ms, first = [], {}
    for i, graphs in enumerate(requests):
        keys = len(server.graphs.graphs)
        counters.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pred, log_std = server.predict(graphs)
        ms.append((time.perf_counter() - t0) * 1e3)
        got = launch_counts()
        new = len(server.graphs.graphs) - keys
        if new not in (0, 1) or got != want:
            fail(f"request {i}: kernel launches {got} with {new} new "
                 f"graphs, not one forward's {want}")
        launches = scaled((launches, 1), (got, 1))
        if pred.shape != (len(graphs),) or not (
                np.isfinite(pred).all() and np.isfinite(log_std).all()):
            fail(f"request {i}: predictions not finite with shape "
                 f"({len(graphs)},)")
        n_atoms = sum(g.n_atoms for g in graphs)
        if new:
            key = list(server.graphs.graphs)[-1]
            first[str(key[0][0][0])] = {
                "request_ms": ms[-1],
                "capture_ms": server.graphs.capture_s[key] * 1e3,
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(f"[serve] request {i}: {len(graphs)} crystals, {n_atoms} "
              f"atoms, {ms[-1]:.2f} ms "
              f"({'warm-up and capture' if new else 'replay'}), launches "
              f"{got}")
    for n, r in first.items():
        print(f"[serve] signature of {n} node slots, first request: "
              f"{r['request_ms']:.2f} ms (capture {r['capture_ms']:.2f} ms), "
              f"peak device memory {r['peak_memory_gib']:.2f} GiB ({card})")

    # a replay against the eager warm-up on the same batch
    warm = server.predict(requests[0], return_embeddings=True)
    again = server.predict(requests[0], return_embeddings=True)
    if not all(np.array_equal(a, b) for a, b in zip(warm, again)):
        fail("a replayed request differs from the eager warm-up's bits on "
             "the same batch")
    # the launches of one replay, from the profiler
    eager = ServingModel(manifest, model)
    eager.graphs = None                      # the same forward, eagerly
    per_call = forward_events_a_call(eager, requests[1])
    counters.reset()
    prof = device_ms(lambda: server.predict(requests[1]), 3)
    counted = {k: v / 3 for k, v in launch_counts().items()}
    if counted != want:
        fail(f"a replayed request counted {counted} launches, not its "
             f"capture's {want}")
    replayed = {k: v / per_call[k] for k, v in kernel_events(prof).items()
                if k in PER_FORWARD}
    if replayed != PER_FORWARD:
        fail(f"a replayed request launched {replayed}, not {PER_FORWARD}")
    # every #1 forward of a replayed request through the stream kernel,
    # by its device kernel's name (device events a request)
    stream = "segment_attention_fwd_stream"
    routes = {"stream": sum(v[1] for k, v in prof.items() if stream in k),
              "per_node": sum(v[1] for k, v in prof.items()
                              if "segment_attention_fwd" in k
                              and stream not in k)}
    if routes["per_node"] or not routes["stream"]:
        fail(f"segment_attention's device events a replayed request by "
             f"kernel {routes}: not all through the stream kernel")
    busy = sum(v[0] for v in prof.values())
    timed = {"replay": timed_ms(lambda: server.predict(requests[1]), N_TIMED),
             "eager": timed_ms(lambda: eager.predict(requests[1]), N_TIMED)}
    stats = {"request_ms": ms, "first_request": first,
             "segment_attention_routes": routes, "replay_bit_equal": True,
             "replay_launches": {k: int(v) for k, v in replayed.items()},
             "device_events_a_call": per_call,
             "replay_device_busy_ms": busy,
             "replay_device_events": sum(v[1] for v in prof.values())}
    for name, t in timed.items():
        stats[f"{name}_ms_median"] = float(np.median(t))
        stats[f"{name}_ms_min"] = float(np.min(t))
    # the names phase 3 kept before its requests replayed
    stats["steady_ms_median"] = stats["replay_ms_median"]
    stats["steady_ms_min"] = stats["replay_ms_min"]
    del server, eager
    stats["left_after_drop_bytes"] = settled_allocated() - allocated
    print(f"[serve] a replayed request equals the eager warm-up bit for bit; "
          f"it counts its capture's launches and launches "
          f"{stats['replay_launches']} (device events by kernel name, "
          f"{per_call} a call; #1 {routes}), device busy {busy:.2f} ms in "
          f"{stats['replay_device_events']:.0f} events; both servers "
          f"dropped, {stats['left_after_drop_bytes']} bytes stay allocated")
    print(f"[serve] steady state over {N_TIMED} requests of {N_GRAPHS}: "
          f"replayed median {stats['replay_ms_median']:.2f} ms, min "
          f"{stats['replay_ms_min']:.2f} ms; eager median "
          f"{stats['eager_ms_median']:.2f} ms, min {stats['eager_ms_min']:.2f}"
          f" ms ({card})")
    return launches, stats


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def kernel_device_ms(fn, n_runs: int = 10, split: bool = False):
    """Device time of one call of ``fn``: the sum of its device events, per
    call, over ``n_runs`` calls (None if the profiler recorded none). Unlike
    ``time_ms`` it leaves out the host's time to issue the call. ``split``
    returns the time of each launch of a call instead, keyed by its
    kernel's name (and its place among that kernel's launches)."""
    fn()
    torch.cuda.synchronize()
    per_name = device_ms(fn, n_runs, by_launch=split)
    if split:
        return {k[:64]: v[0] for k, v in per_name.items()}
    return sum(v[0] for v in per_name.values()) if per_name else None


def breakdown(model, graphs, rows, reps: int = 10) -> dict:
    """Where one request's time goes. The steps of ``ServingModel.predict``
    (collate on the host, copy to the card, forward, copy back) are timed
    one by one on the host clock, each ending in a synchronise; medians over
    ``reps`` requests. Then the card's busy time in one forward, from
    torch.profiler's device events, and the three kernels' part of the
    forward (phase 2 times x launches)."""
    from cgat_tpu_torch.data import collate, pad_to_bucket

    n = pad_to_bucket(sum(g.n_atoms for g in graphs), 64)
    kw = dict(num_graphs=N_GRAPHS, num_node_slots=n, num_edge_slots=n * 24,
              num_comp_slots=8, max_nbr=24, orig_fea=200)

    def forward(batch):
        with torch.inference_mode():
            return model.head(model.embed(batch))

    steps = {"collate_ms": [], "to_card_ms": [], "forward_ms": [],
             "to_host_ms": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        batch = collate(graphs, **kw)
        t.append(time.perf_counter())
        batch = batch.to("cuda")
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = forward(batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out.cpu().numpy()
        t.append(time.perf_counter())
        for k, a, b in zip(steps, t[:-1], t[1:]):
            steps[k].append((b - a) * 1e3)
    res = {k: float(np.median(v)) for k, v in steps.items()}
    res["kernels_ms"] = sum(r["ms"] * PER_FORWARD[r["name"]] for r in rows)

    per_name = device_ms(lambda: forward(batch), 3)
    if per_name:
        busy = sum(v[0] for v in per_name.values())
        res.update(device_busy_ms=busy,
                   device_idle_share=1.0 - busy / res["forward_ms"],
                   device_events=sum(v[1] for v in per_name.values()),
                   top_device_ms=[[k[:70], v[0]] for k, v in sorted(
                       per_name.items(), key=lambda kv: -kv[1][0])[:8]])
    else:           # the profiler saw no device activity on this machine
        res.update(device_busy_ms=None, device_idle_share=None,
                   top_device_ms=None)
    print(f"[breakdown] {n} node slots, medians of {reps}: collate "
          f"{res['collate_ms']:.2f} ms, to card {res['to_card_ms']:.2f} ms, "
          f"forward {res['forward_ms']:.2f} ms, to host "
          f"{res['to_host_ms']:.2f} ms; the three kernels "
          f"{res['kernels_ms']:.2f} ms of the forward")
    if per_name:
        print(f"[breakdown] device busy {busy:.2f} ms per forward in "
              f"{res['device_events']:.0f} device events, idle share "
              f"{res['device_idle_share']:.3f}")
        for name, ms in res["top_device_ms"]:
            print(f"[breakdown]   {ms:8.4f} ms  {name}")
    else:
        print("[breakdown] device busy time: not measured (the profiler "
              "recorded no device events)")
    return res


@contextlib.contextmanager
def capture_backward_inputs():
    """Record, per autograd Function, what its first backward call got: the
    saved tensors, the cotangent and the Function's own settings. The
    segment attention and the gather are recorded once per node count
    (edges -> nodes and atoms -> crystals), since backward runs the crystal
    pool first; the hyper apply also once per row count (nodes, and edges
    under ``no_hyper=False``)."""
    from cgat_tpu_torch.ops import gather
    from cgat_tpu_torch.ops.kernels import hyper_apply as hk
    from cgat_tpu_torch.ops.kernels import mh_network as mk
    from cgat_tpu_torch.ops.kernels import segment_attention as sk
    seen: dict[str, dict] = {}
    classes = {"segment_attention": sk.SegmentAttention,
               "mh_network": mk.MHNetwork, "hyper_apply": hk.HyperApply,
               "gather": gather._GatherRows}
    originals = {key: cls.backward for key, cls in classes.items()}

    def recording(key, orig):
        def backward(ctx, g):
            name = key
            names = [key]
            if key == "gather":
                names = [f"gather_{ctx.num_rows}"]
            elif key == "segment_attention":
                names = [f"segment_attention_{g.shape[0]}"]
            elif key == "hyper_apply":
                names.append(f"hyper_apply_{g.shape[0]}")
            for name in names:
                # detached: a saved tensor's autograd graph would outlive
                # the step (and hold its AccumulateGrad nodes' stream)
                seen.setdefault(name, {
                    "saved": tuple(None if t is None else t.detach()
                                   for t in ctx.saved_tensors),
                    "g": g.contiguous(),
                    **{a: getattr(ctx, a) for a in ("heads", "out_ch",
                                                    "num_rows")
                       if hasattr(ctx, a)}})
            return orig(ctx, g)
        return staticmethod(backward)

    for key, cls in classes.items():
        cls.backward = recording(key, originals[key])
    try:
        yield seen
    finally:
        for key, cls in classes.items():
            cls.backward = staticmethod(originals[key])


def check_backward_kernels(seen, n_nodes, n_graphs) -> list[dict]:
    """Each backward kernel against its plain version on the inputs and
    cotangents of the first training step, timed beside its bound."""
    from cgat_tpu_torch.ops.kernels import hyper_apply as hk
    from cgat_tpu_torch.ops.kernels import mh_network as mk
    from cgat_tpu_torch.ops.kernels import segment_attention as sk
    from cgat_tpu_torch.ops.kernels import segment_sum as ssk

    rows = []

    def row(name, fn, plain, outs, wants, shape, work, peak, **extra):
        if len(outs) != len(wants):
            fail(f"{name}: {len(outs)} outputs, {len(wants)} plain ones")
        checks = [compare(name, a, b) for a, b in zip(outs, wants)]
        b_ms, b_by = bound(*work, peak)
        rows.append({"name": name, "shape": shape, **checks_row(checks),
                     "ms": time_ms(fn), "device_ms": kernel_device_ms(fn),
                     "plain_ms": time_ms(plain),
                     "bound_ms": b_ms, "bound_by": b_by, **extra})

    with torch.no_grad():
        def seg_args(num_nodes):
            rec = seen[f"segment_attention_{num_nodes}"]
            alpha, m, ids, n_real, out, mx, den = rec["saved"]
            return alpha, m, ids, n_real, rec["g"], out, mx, den

        args, pool = seg_args(n_nodes), seg_args(n_graphs)
        e, hf = args[0].shape
        real = int(args[3])
        row("segment_attention_bwd", lambda: sk.segment_attention_bwd(*args),
            lambda: sk.segment_attention_bwd_plain(*args),
            sk.segment_attention_bwd(*args) + sk.segment_attention_bwd(*pool),
            sk.segment_attention_bwd_plain(*args)
            + sk.segment_attention_bwd_plain(*pool), [e, hf, n_nodes],
            work=roofline.segment_attention_bwd_work(e, real, hf, n_nodes),
            peak=F32_FLOPS,
            pool_ms=time_ms(lambda: sk.segment_attention_bwd(*pool)))

        rec = seen["mh_network"]
        x, h, win, wout = rec["saved"]
        heads = rec["heads"]
        args = (x, h, rec["g"], win, wout, heads)
        e, cat = x.shape
        hh, hf = win.shape[0], wout.shape[0]
        hid = hh // heads
        # the same four products as bf16 cuBLAS calls: an informative
        # yardstick (four calls, not one), never called by the port
        g3 = rec["g"].view(e, heads, hf // heads)
        h3 = h.view(e, heads, hid)
        dpre = torch.randn(e, hh, device=x.device).to(x.dtype)

        def cublas():
            torch.matmul(g3.transpose(0, 1), wout.view(heads, -1, hid))
            torch.matmul(dpre, win)
            torch.matmul(dpre.T, x)
            torch.matmul(g3.permute(1, 2, 0), h3.transpose(0, 1))
        row("mh_network_bwd", lambda: mk.mh_network_bwd(*args),
            lambda: mk.mh_network_bwd_plain(*args), mk.mh_network_bwd(*args),
            mk.mh_network_bwd_plain(*args), [e, cat, hh, hf],
            work=roofline.mh_network_bwd_work(e, cat, heads, hid,
                                              hf // heads),
            peak=BF16_TENSOR_FLOPS,
            deterministic=deterministic(
                "mh_network_bwd", lambda: mk.mh_network_bwd(*args)),
            cublas_ms=time_ms(cublas),
            cublas_device_ms=kernel_device_ms(cublas),
            cublas_what="the same four products as bf16 cuBLAS calls "
                        "(torch.matmul)",
            device_split=kernel_device_ms(lambda: mk.mh_network_bwd(*args),
                                          split=True))

        rec = seen["hyper_apply"]
        hidden, k, bias, xh = rec["saved"]
        o = rec["out_ch"]
        g = rec["g"]
        b, c = hidden.shape
        i = xh.shape[1]
        args = (hidden, k, bias, xh, g, o)
        work = hyper_work(b, c, i, o)
        yard = hyper_yardsticks(*args)
        cublas = yard["hyper_apply_bwd_dhdx"]
        row("hyper_apply_bwd_dhdx", lambda: hk.hyper_apply_bwd_dhdx(*args),
            lambda: hk.hyper_apply_bwd_dhdx_plain(*args),
            hk.hyper_apply_bwd_dhdx(*args),
            hk.hyper_apply_bwd_dhdx_plain(*args), [b, c, i, o],
            work=work["hyper_apply_bwd_dhdx"], peak=BF16_TENSOR_FLOPS,
            deterministic=deterministic(
                "hyper_apply_bwd_dhdx",
                lambda: hk.hyper_apply_bwd_dhdx(*args)),
            cublas_ms=time_ms(cublas),
            cublas_device_ms=kernel_device_ms(cublas),
            cublas_what="addmm for P, the g product and the sum over o, "
                        "and [dP | g] @ K materialised (bf16 cuBLAS and "
                        "PyTorch calls)",
            device_split=kernel_device_ms(
                lambda: hk.hyper_apply_bwd_dhdx(*args), split=True))
        args = (hidden, xh, g, o)
        cublas_dk = yard["hyper_apply_bwd_dk"]
        row("hyper_apply_bwd_dk", lambda: hk.hyper_apply_bwd_dk(*args),
            lambda: hk.hyper_apply_bwd_dk_plain(*args),
            hk.hyper_apply_bwd_dk(*args), hk.hyper_apply_bwd_dk_plain(*args),
            [b, c, i, o], work=work["hyper_apply_bwd_dk"],
            peak=BF16_TENSOR_FLOPS,
            deterministic=deterministic(
                "hyper_apply_bwd_dk", lambda: hk.hyper_apply_bwd_dk(*args)),
            cublas_ms=time_ms(cublas_dk),
            cublas_device_ms=kernel_device_ms(cublas_dk),
            cublas_what="dP materialised, dP^T @ hidden and dP's column "
                        "sums (bf16 cuBLAS and PyTorch calls)")

        def segsum_args(num_rows):
            rec = seen[f"gather_{num_rows}"]
            sorted_idx, perm, offn = rec["saved"]
            vals = rec["g"] if perm is None else rec["g"][perm]
            return vals, sorted_idx, offn, num_rows

        args = segsum_args(n_nodes)
        pool = segsum_args(n_graphs)
        e, f = args[0].shape
        lib_out = torch.zeros((n_nodes, f), dtype=args[0].dtype,
                              device=args[0].device)
        lib_idx = args[1].long()
        row("segment_sum", lambda: ssk.segment_sum(*args),
            lambda: ssk.segment_sum_plain(args[0], args[1], n_nodes),
            [ssk.segment_sum(*args), ssk.segment_sum(*pool)],
            [ssk.segment_sum_plain(args[0], args[1], n_nodes),
             ssk.segment_sum_plain(pool[0], pool[1], n_graphs)],
            [e, f, n_nodes], work=roofline.segment_sum_work(e, f, n_nodes),
            peak=F32_FLOPS,
            library_ms=time_ms(lambda: lib_out.index_add_(0, lib_idx,
                                                          args[0])),
            library_device_ms=kernel_device_ms(
                lambda: lib_out.index_add_(0, lib_idx, args[0])),
            pool_ms=time_ms(lambda: ssk.segment_sum(*pool)),
            deterministic=deterministic(
                "segment_sum", lambda: (ssk.segment_sum(*args),
                                        ssk.segment_sum(*pool))))
    report(rows)
    return rows


def edge_launches(n: int) -> dict[str, int]:
    """Kernel launches a rank makes in one training step under edge = 2
    with an ``n``-layer default model: a node layer runs the MH kernel on
    its local and its halo block (4), the pair path (#1 twice), its
    hypernetwork (4); the crystal pool completes its softmax across the
    ranks with collectives around #8 (no #1); the backward adds the halo
    block's destination gather to the two node gathers (3 segment sums a
    layer), and the pool sums its numerator and denominator with #8 and
    its two gathers (the crystal features, the max) take #8 as their
    backward (4)."""
    return {"mh_network": 4 * n, "segment_attention": 2 * n,
            "hyper_apply": 4 * n, "mh_network_bwd": 4 * n,
            "segment_attention_bwd": 2 * n, "hyper_apply_bwd_dhdx": 4 * n,
            "hyper_apply_bwd_dk": 4 * n, "segment_sum": 3 * n + 4}


def check_pair_path(model, graphs) -> dict:
    """Phase 2's pair-path row: #1 on each block, the f32 merge and #2 on
    each block against the merged arrays (``SegmentAttentionPair``), held
    against the plain pair function and its autograd gradient at edge
    shard 0's shapes of an edge = 2 collate of ``graphs``, with layer 0's
    MH kernels on the real local and halo edge features (the halo block's
    sources from shard 1 as the exchange would deliver them); two
    launches must give the same bits."""
    from cgat_tpu_torch.data import collate
    from cgat_tpu_torch.ops.attention import edge_softmax_aggregate_pair
    from cgat_tpu_torch.ops.kernels.segment_attention import \
        segment_attention_pair_plain
    from cgat_tpu_torch.parallel import local_batch, stack_batches

    S = 2
    whole = collate(graphs, num_graphs=N_GRAPHS, num_comp_slots=8,
                    max_nbr=24, orig_fea=200, edge_shards=S).to("cuda")
    b = local_batch(stack_batches([whole]), 0, 0, S)
    n_loc = b.nodes.shape[0]
    node = model.graphs[0].Node
    with torch.no_grad():
        x_all = model.embedding(whole.nodes)
        x = x_all[:n_loc]
        send = whole.halo_send_idx.long()
        # rows shard 1 sends shard 0 (row 1*S + 0 of the send table)
        table = torch.cat([x, x[send[0]], x_all[n_loc:][send[S]]])
        dst = b.edge_dst
        dst_h = b.halo_dst
        m_cat = torch.cat([x[dst.long()], model.nbr_embedding(b.edge_shell),
                           x[b.edge_src.long()]], -1)
        m_cat_h = torch.cat([x[dst_h.long()],
                             model.nbr_embedding(b.halo_shell),
                             table[b.halo_src_ext.long()]], -1)
        leaves = [node.MH_A(m_cat, flat=True), node.MH_M(m_cat, flat=True),
                  node.MH_A(m_cat_h, flat=True),
                  node.MH_M(m_cat_h, flat=True)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn(n_loc, leaves[0].shape[1], generator=gen,
                    device="cuda").to(torch.bfloat16)
    args = (dst, b.edge_mask, dst_h, b.halo_mask)

    def run(fn, grad=True):
        xs = [t.detach().clone().requires_grad_(grad) for t in leaves]
        kw = ({"offn_l": b.edge_dst_offn, "offn_h": b.halo_dst_offn}
              if fn is edge_softmax_aggregate_pair else {})
        out = fn(xs[0], xs[1], args[0], args[1], xs[2], xs[3], args[2],
                 args[3], n_loc, **kw)
        if not grad:
            return [out]
        return [out.detach()] + list(torch.autograd.grad(out, xs, g))

    got = run(edge_softmax_aggregate_pair)
    want = run(segment_attention_pair_plain)
    names = ("out", "dalpha_l", "dm_l", "dalpha_h", "dm_h")
    checks = [compare(f"pair path {n}", a, w)
              for n, a, w in zip(names, got, want)]
    deterministic("pair path", lambda: run(edge_softmax_aggregate_pair))
    e_l, e_h = int(b.edge_mask.sum()), int(b.halo_mask.sum())
    hf = leaves[0].shape[1]
    work = roofline.pair_work(e_l, e_h, hf, n_loc)
    fb, fby = bound(*work["pair"], F32_FLOPS)
    bb, bby = bound(*work["pair_bwd"], F32_FLOPS)
    row = {"shape": {"local_rows": int(leaves[0].shape[0]),
                     "halo_rows": int(leaves[2].shape[0]),
                     "real_local": e_l, "real_halo": e_h, "hf": hf,
                     "nodes": n_loc},
           **checks_row(checks), "tolerance": KERNEL_TOL,
           "norm_tolerance": NORM_TOL, "deterministic": True,
           "fwd_ms": time_ms(lambda: run(edge_softmax_aggregate_pair,
                                         grad=False)),
           "fwd_plain_ms": time_ms(lambda: run(segment_attention_pair_plain,
                                               grad=False)),
           "fwd_and_bwd_ms": time_ms(lambda: run(edge_softmax_aggregate_pair)),
           "fwd_and_bwd_plain_ms": time_ms(
               lambda: run(segment_attention_pair_plain)),
           "fwd_bound_ms": fb, "fwd_bound_by": fby,
           "bwd_bound_ms": bb, "bwd_bound_by": bby}
    print(f"[kernels] pair path (#1 x2, f32 merge, #2 x2) at shard 0 of "
          f"edge = 2: {row['shape']}; max_abs_err {row['max_abs_err']:.3e}, "
          f"norm-wise {row['rel_norm_err']:.3e} (tol {KERNEL_TOL} x "
          f"max|plain|, {NORM_TOL}); forward {row['fwd_ms']:.4f} ms (plain "
          f"{row['fwd_plain_ms']:.4f}, bound {fb:.4f} {fby}), forward and "
          f"backward {row['fwd_and_bwd_ms']:.4f} ms (plain "
          f"{row['fwd_and_bwd_plain_ms']:.4f}, backward bound {bb:.4f} "
          f"{bby}); two launches bit-identical")
    return row


def train(cfg, state_dict) -> tuple[list[dict], dict, dict]:
    """Phase 4: checked and timed training steps; returns the backward
    kernels' rows, the step statistics and the launch counts of the
    training run."""
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.training import Trainer, TrainerConfig

    graphs = random_graphs(100, N_TRAIN_GRAPHS, n_atoms_range=(8, 16),
                           max_nbr=24, full_degree=True)
    tcfg = TrainerConfig(batch_size=N_GRAPHS, moment_dtype="bfloat16")
    trainer = Trainer(tcfg, cfg, graphs, device="cuda")
    trainer.init_state(state_dict)
    loader = trainer.loader(trainer.train_graphs, shuffle=True)
    batches = iter(loader)
    want = scaled((PER_FORWARD, 1), (PER_BACKWARD, 1))

    def next_batch():
        nonlocal batches
        try:
            return next(batches)
        except StopIteration:
            batches = iter(loader)
            return next(batches)

    def step(check: bool, seen=None) -> dict:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        batch_cpu = next_batch()
        t.append(time.perf_counter())
        batch = batch_cpu.to("cuda")
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss, _ = trainer.forward_loss(batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        trainer.backward(loss)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        res = {"batch": batch_cpu, "loss": loss.detach()}
        if check:
            grads = [p.grad for p in trainer.model.parameters()
                     if p.grad is not None]
            norms = torch.stack(torch._foreach_norm(grads))
            if not (torch.isfinite(loss) and torch.isfinite(norms).all()):
                fail(f"non-finite loss {float(loss)} or grads")
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        trainer.apply_update()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        names = ("collate_ms", "to_card_ms", "forward_ms", "backward_ms",
                 None, "optimizer_ms")
        res.update({k: (b - a) * 1e3 for k, a, b in zip(names, t[:-1], t[1:])
                    if k is not None})
        return res

    torch.cuda.reset_peak_memory_stats()
    launches = scaled()
    steps = []
    with capture_backward_inputs() as seen:
        for i in range(N_CHECKED_STEPS):
            counters.reset()
            steps.append(step(True))
            got = launch_counts()
            if got != want:
                fail(f"train step {i}: kernel launches {got} != {want}")
            launches = scaled((launches, 1), (got, 1))
            print(f"[train] step {i}: loss {float(steps[-1]['loss']):.5f}, "
                  f"launches {got}")
    counters.reset()
    timed = [step(False) for _ in range(N_TIMED_STEPS)]
    got = launch_counts()
    if got != scaled((want, N_TIMED_STEPS)):
        fail(f"{N_TIMED_STEPS} timed training steps launched {got}")
    launches = scaled((launches, 1), (got, 1))
    n_steps = N_CHECKED_STEPS + N_TIMED_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # the first step's loss against the port's own bf16 step on the CPU
    t0 = time.perf_counter()
    cpu = Trainer(tcfg, cfg, graphs, device="cpu")
    cpu.init_state(state_dict)
    with torch.no_grad():
        want_loss = float(cpu.forward_loss(steps[0]["batch"])[0])
    cpu_s = time.perf_counter() - t0
    got_loss = float(steps[0]["loss"])
    if not abs(got_loss - want_loss) <= MODEL_RTOL * 2 * abs(want_loss):
        fail(f"first step loss {got_loss} on the card vs {want_loss} on the "
             f"CPU")
    print(f"[train] first step loss: card {got_loss:.6f}, CPU bf16 "
          f"{want_loss:.6f} (rtol {MODEL_RTOL}, atol {MODEL_RTOL} x |loss|); "
          f"the CPU trainer and forward took {cpu_s:.1f} s")

    keys = ("collate_ms", "to_card_ms", "forward_ms", "backward_ms",
            "optimizer_ms")
    split = {k: float(np.median([s[k] for s in timed])) for k in keys}
    step_ms = [sum(s[k] for k in keys) for s in timed]
    stats = {"steps": n_steps, "crystals_per_step": N_GRAPHS,
             "step_ms_median": float(np.median(step_ms)),
             "step_ms_min": float(np.min(step_ms)), **split,
             "first_loss_card": got_loss, "first_loss_cpu": want_loss,
             "peak_memory_gib": peak_gib,
             "losses": [float(s["loss"]) for s in steps + timed]}

    batch = next_batch().to("cuda")

    def one_step():
        loss, _ = trainer.forward_loss(batch)
        trainer.backward(loss)
        trainer.apply_update()

    one_step()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    per_name = device_ms(one_step, 3)
    stats.update(device_step_ms=wall, device_busy_ms=None,
                 device_idle_share=None, device_events=None,
                 top_device_ms=None)
    if per_name:
        busy = sum(v[0] for v in per_name.values())
        stats.update(device_busy_ms=busy, device_idle_share=1.0 - busy / wall,
                     device_events=sum(v[1] for v in per_name.values()),
                     top_device_ms=[[k[:70], v[0], v[1]] for k, v in sorted(
                         per_name.items(), key=lambda kv: -kv[1][0])[:12]])
    print(f"[train] {N_TIMED_STEPS} timed steps of {N_GRAPHS} crystals: "
          f"median {stats['step_ms_median']:.2f} ms (min "
          f"{stats['step_ms_min']:.2f}): collate {split['collate_ms']:.2f}, "
          f"to card {split['to_card_ms']:.2f}, forward "
          f"{split['forward_ms']:.2f}, backward {split['backward_ms']:.2f}, "
          f"optimizer {split['optimizer_ms']:.2f} ms; peak device memory "
          f"{peak_gib:.2f} GiB")
    if per_name:
        print(f"[train] one step on a resident batch, no syncs in between: "
              f"median {wall:.2f} ms of 5, device busy {busy:.2f} ms in "
              f"{stats['device_events']:.0f} device events, idle share "
              f"{stats['device_idle_share']:.3f}")
        for name, ms, count in stats["top_device_ms"]:
            print(f"[train]   {ms:8.4f} ms  {count:5.0f} x  {name}")
    else:
        print("[train] device busy time: not measured (the profiler "
              "recorded no device events)")
    rows = check_backward_kernels(seen, int(steps[0]["batch"].num_node_slots),
                                  N_GRAPHS)
    return rows, stats, launches



def cli_call(name: str, main, argv: list[str], want: dict[str, int],
             phase: int = 5) -> tuple[dict[str, int], str]:
    """One CLI entry point in this process: counts set to 0 just before,
    read just after and held to ``want``; returns them and its stdout."""
    progress(f"phase {phase}: {name}")
    counters.reset()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    except BaseException:
        print(out.getvalue()[-4000:])
        raise
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    if rc != 0:
        fail(f"{name} exited with {rc}")
    if got != want:
        fail(f"{name}: kernel launches {got} != {want}")
    print(f"[cli] {name}: exit 0 in {seconds:.1f} s, launches {got}")
    return got, out.getvalue()


def finite_metrics(path: str) -> list[dict]:
    recs = [json.loads(line) for line in open(path).read().splitlines()]
    if not recs or not all(math.isfinite(v) for r in recs
                           for v in r.values()):
        fail(f"{path}: missing or non-finite metrics")
    return recs


def cli_steps(argv: list[str], epochs) -> tuple[int, int]:
    """What ``cli.train argv`` does in ``epochs``: the training steps it
    takes, each counting one step's launches (eager or replayed), and the
    batch shape signatures among them (one CUDA graph each; one optimizer
    phase)."""
    import argparse

    from cgat_tpu_torch.cli import common as cli_common
    from cgat_tpu_torch.training import Trainer
    from cgat_tpu_torch.training.dispatch import signature

    p = argparse.ArgumentParser()
    cli_common.add_trainer_args(p)
    cli_common.add_model_args(p)
    cli_common.add_device_arg(p)
    tcfg, mcfg = cli_common.configs_from_args(p.parse_args(argv))
    with contextlib.redirect_stdout(io.StringIO()):
        probe = Trainer(tcfg, mcfg, device="cuda")
    k = tcfg.steps_per_dispatch
    loader = probe.train_loader()
    sigs, steps = set(), 0
    for e in epochs:
        loader.set_epoch(e)
        for b in loader:
            sigs.add(signature(b.map(lambda t: t[0]) if k > 1 else b))
            steps += k
    return steps, len(sigs)


def eager_step(trainer, batch) -> dict:
    """One eager training step of ``trainer`` on a batch on the card: the
    work a CUDA graph of the step captures, which ``train_step`` replays;
    returns its metrics."""
    loss, metrics = trainer.forward_loss(batch)
    trainer.backward(loss)
    trainer.apply_update()
    return {k: v.detach() for k, v in metrics.items()}


def cli(tmp: str) -> tuple[dict, dict]:
    """Phase 5: prepare -> train -> evaluate -> predict -> resume through
    the CLIs' ``main``; returns the phase's numbers and every kernel's
    launches in it."""
    from cgat_tpu_torch import native
    from cgat_tpu_torch.cli import evaluate as cli_evaluate
    from cgat_tpu_torch.cli import predict as cli_predict
    from cgat_tpu_torch.cli import prepare as cli_prepare
    from cgat_tpu_torch.cli import train as cli_train
    from cgat_tpu_torch.data.dataset import load_prepared, split_dataset
    from cgat_tpu_torch.data.featurizer import periodic_neighbors
    from cgat_tpu_torch.data.structures import random_structures
    from cgat_tpu_torch.training import CheckpointManager, load_trainer

    stats: dict = {"structures": N_CLI_STRUCTURES}
    t0 = time.perf_counter()
    native.load()
    stats["native_build_s"] = time.perf_counter() - t0
    entries = random_structures(0, N_CLI_STRUCTURES)
    for i, s in enumerate(entries[:N_NATIVE_CHECKED]):
        nat = periodic_neighbors(s["lattice"], s["frac_coords"])
        ref = periodic_neighbors(s["lattice"], s["frac_coords"],
                                 use_native=False)
        if not (np.array_equal(nat[0], ref[0])
                and np.array_equal(nat[1], ref[1])
                and np.allclose(nat[2], ref[2], rtol=0, atol=1e-9)):
            fail(f"structure {i}: native kNN differs from the numpy oracle")
    with gzip.open(os.path.join(tmp, "structures.pickle.gz"), "wb") as f:
        pickle.dump(entries, f)
    zero = scaled()
    total = dict(zero)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    t0 = time.perf_counter()
    cli_call("cli.prepare", cli_prepare.main,
             ["--file", "structures.pickle.gz", "--source-dir", tmp,
              "--target-dir", tmp, "--target-file", "prepared.pickle.gz"],
             zero)
    stats["prepare_ms_per_structure"] = (
        (time.perf_counter() - t0) * 1e3 / N_CLI_STRUCTURES)
    data = os.path.join(tmp, "prepared.pickle.gz")
    n = len(load_prepared(data, target="e_above_hull"))
    _, val, test = split_dataset(n, seed=0)
    train_n = n - len(val) - len(test)
    steps, evals = train_n // N_GRAPHS, -(-len(val) // N_GRAPHS)
    print(f"[cli] {n} of {N_CLI_STRUCTURES} structures prepared (native kNN "
          f"built in {stats['native_build_s']:.1f} s, equal to numpy on the "
          f"first {N_NATIVE_CHECKED}), {stats['prepare_ms_per_structure']:.2f}"
          f" ms per structure; split {train_n}/{len(val)}/{len(test)}: "
          f"{steps} steps an epoch")

    def want(fwd: int, bwd: int) -> dict[str, int]:
        return scaled((PER_FORWARD, fwd), (PER_BACKWARD, bwd))

    logs = os.path.join(tmp, "logs")
    run = os.path.join(logs, "runs", "cli")
    argv = ["--data-path", data, "--target", "e_above_hull", "--smoke-test",
            "--ckpt-dir", logs, "--run-name", "cli"]
    # each training step a replay of its shape's CUDA graph (a shape's
    # first step eager, then captured), one step's launches either way
    taken, keys = cli_steps(argv, range(2))
    # epochs 0 and 1, validated after epoch 1 (every second epoch)
    add(cli_call("cli.train --smoke-test", cli_train.main, argv,
                 want(taken + evals, taken))[0])
    epochs = [r for r in finite_metrics(os.path.join(run, "metrics.jsonl"))
              if "train_loss" in r]
    counts, out = cli_call("cli.evaluate", cli_evaluate.main, [run],
                           want(-(-len(test) // N_GRAPHS), 0))
    add(counts)
    test_m = json.loads(out.strip().splitlines()[-1])
    if not all(math.isfinite(v) for v in test_m.values()):
        fail(f"cli.evaluate: non-finite metrics {test_m}")
    outputs = {}
    for flag in ("", "--embeddings"):
        path = os.path.join(tmp, f"predict{flag}.pickle.gz")
        add(cli_call(f"cli.predict {flag}".strip(), cli_predict.main,
                     [run, data, "--out", path] + ([flag] if flag else []),
                     want(-(-n // N_GRAPHS), 0))[0])
        with gzip.open(path, "rb") as f:
            outputs[flag or "pred"] = pickle.load(f)
    pred, emb = outputs["pred"]["pred"], outputs["--embeddings"]["embeddings"]
    if pred.shape != (n,) or not np.isfinite(pred).all():
        fail(f"cli.predict: predictions not finite with shape ({n},)")
    if emb.shape != (n, 640) or not np.isfinite(emb).all():
        fail(f"cli.predict --embeddings: embeddings not finite with shape "
             f"({n}, 640)")
    # epoch 2 only, not validated, in a new trainer with graphs of its own
    taken_2, keys_2 = cli_steps(argv, [2])
    counts, out = cli_call("cli.train --ckp", cli_train.main,
                           ["--ckp", run, "--epochs", "3"],
                           want(taken_2, taken_2))
    add(counts)
    resumed = [r for r in finite_metrics(os.path.join(run, "metrics.jsonl"))
               if "train_loss" in r][len(epochs):]
    if [r["epoch"] for r in resumed] != [2]:
        fail(f"the resumed run ran epochs {[r['epoch'] for r in resumed]}, "
             f"not [2]")

    for tag in ("best", "last"):
        trainer, meta = load_trainer(run, tag=tag, device="cuda")
        if not all(torch.isfinite(p).all() for p in trainer.model.parameters()):
            fail(f"checkpoint {tag}: non-finite weights")
    progress("phase 5: checkpoint save and load")
    ckpt = CheckpointManager(run)
    save_ms, load_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(trainer, epoch=meta["epoch"], val_mae=meta["val_mae"],
                  tag="timing")
        t1 = time.perf_counter()
        CheckpointManager.load_state(run, trainer, tag="timing")
        torch.cuda.synchronize()
        save_ms.append((t1 - t0) * 1e3)
        load_ms.append((time.perf_counter() - t1) * 1e3)
    size = os.path.getsize(os.path.join(ckpt.dir, "timing.pt"))
    stats.update(
        epochs=[{k: r[k] for k in ("epoch", "step", "epoch_time",
                                   "graphs_per_sec", "train_loss")}
                for r in epochs + resumed],
        test=test_m, checkpoint_mb=size / 2 ** 20,
        checkpoint_save_ms=float(np.median(save_ms)),
        checkpoint_load_ms=float(np.median(load_ms)), launches=total,
        data_path=data, prepared=n, steps_per_epoch=steps,
        val_batches=evals,
        test_batches=-(-len(test) // N_GRAPHS), graph_keys=[keys, keys_2])
    for r in stats["epochs"]:
        print(f"[cli] epoch {r['epoch']:.0f}: {r['epoch_time'] * 1e3:.0f} ms "
              f"wall, {r['graphs_per_sec']:.1f} graphs/s, train loss "
              f"{r['train_loss']:.5f}")
    print(f"[cli] cli.train captured {keys} step graphs in epochs 0 and 1, "
          f"the resumed run {keys_2} in epoch 2 (one a batch shape)")
    print(f"[cli] test {test_m}; checkpoint {stats['checkpoint_mb']:.1f} MiB: "
          f"save {stats['checkpoint_save_ms']:.1f} ms, load into the trainer "
          f"{stats['checkpoint_load_ms']:.1f} ms (medians of 3); best and "
          f"last load")
    return stats, total


def export(tmp, requests, card: str) -> tuple[dict, dict]:
    """Phase 9: ``cli.export`` on phase 5's run directory (its signatures
    the node buckets of phase 3's requests), ``load_artifact`` on the card,
    and phase 3's requests served from it: each signature's first request
    the eager warm-up and the capture, the rest replays, with exact
    launches (one forward's a request); the predictions agree with that
    run's trainer's own ``predict`` within the bf16 tolerance of phase 3's
    CPU check. Returns the phase's numbers and the launches of the served
    requests."""
    from cgat_tpu_torch.cli import export as cli_export
    from cgat_tpu_torch.data import pad_to_bucket
    from cgat_tpu_torch.serving import load_artifact
    from cgat_tpu_torch.training import load_trainer

    run = os.path.join(tmp, "logs", "runs", "cli")
    out = os.path.join(tmp, "artifact")
    buckets = sorted({pad_to_bucket(sum(g.n_atoms for g in r), 64)
                      for r in requests})
    t0 = time.perf_counter()
    _, text = cli_call("cli.export", cli_export.main,
                       [run, out, "--node-buckets", *map(str, buckets)],
                       scaled(), phase=9)
    export_s = time.perf_counter() - t0
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    if [s["num_node_slots"] for s in manifest["signatures"]] != buckets or \
            manifest["platforms"] != ["cuda", "cpu"]:
        fail(f"cli.export wrote signatures {manifest['signatures']} and "
             f"platforms {manifest['platforms']}")
    progress("phase 9: load_artifact and serve")
    counters.reset()
    t0 = time.perf_counter()
    server = load_artifact(out)
    load_s = time.perf_counter() - t0
    if server.device.type != "cuda" or server.graphs is None:
        fail("load_artifact did not serve on the card")
    ms, preds = [], []
    for graphs in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds.append(server.predict(graphs)[0])
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    want = scaled((PER_FORWARD, len(requests)))
    if launches != want or len(server.graphs.graphs) != len(buckets):
        fail(f"the artifact's {len(requests)} requests launched {launches}, "
             f"not {want}, or captured {len(server.graphs.graphs)} graphs "
             f"for {len(buckets)} signatures")
    with contextlib.redirect_stdout(io.StringIO()):
        trainer, meta = load_trainer(run, tag="best", device="cuda")
    errs = []
    for i, (graphs, got) in enumerate(zip(requests, preds)):
        ref = trainer.predict(graphs)
        scale = float(np.abs(ref).max())
        errs.append(float(np.abs(got - ref).max()))
        if got.shape != ref.shape or not np.isfinite(got).all() or \
                not np.allclose(got, ref, rtol=MODEL_RTOL,
                                atol=MODEL_RTOL * scale):
            fail(f"request {i}: the artifact's predictions differ from the "
                 f"trainer's by {errs[-1]:.3e} (max|pred| {scale:.3e})")
    stats = {"export_s": export_s, "load_s": load_s, "request_ms": ms,
             "signatures": buckets, "max_abs_diff_to_trainer": errs,
             "checkpoint_epoch": meta["epoch"], "cli_line": text.strip()}
    print(f"[export] {text.strip()} in {export_s:.2f} s; load_artifact on "
          f"the card {load_s:.2f} s; requests {[round(m, 2) for m in ms]} ms "
          f"(the first of each signature captures); launches {launches}; "
          f"predictions within {max(errs):.3e} of the trainer's own "
          f"predict (rtol {MODEL_RTOL}, atol {MODEL_RTOL} x max|pred|) "
          f"({card})")
    return stats, launches


def subset_prepared(prepared: dict, idx) -> dict:
    """The crystals ``idx`` of a prepared-dataset dict, in its layout."""
    idx = np.asarray(idx)
    return {"input": prepared["input"][:, idx],
            "batch_ids": [prepared["batch_ids"][i] for i in idx],
            "batch_comp": prepared["batch_comp"][idx],
            "target": {k: np.asarray(v)[idx]
                       for k, v in prepared["target"].items()},
            "comps": prepared["comps"][idx]}


def streaming(tmp, data, card: str) -> tuple[dict, dict]:
    """Phase 10: out-of-core training through the CLI. Phase 5's prepared
    crystals are split into N_SHARDS shards (its validation split apart,
    as ``--val-path``); ``cli.train --streaming --smoke-test`` trains 2
    epochs from them with single steps and with ``--steps-per-dispatch
    2``: finite metrics, the launches its steps and validation imply,
    fewer captures (one a batch shape of the stream) than steps, and its
    graphs/s beside phase 5's in-memory epochs. Returns the phase's
    numbers and the launches of both calls."""
    from cgat_tpu_torch.cli import train as cli_train
    from cgat_tpu_torch.data.dataset import split_dataset

    with gzip.open(data["data_path"], "rb") as f:
        prepared = pickle.load(f)
    n = len(prepared["batch_ids"])
    _, val, _ = split_dataset(n, seed=0)
    rest = sorted(set(range(n)) - set(val))
    shards, val_dir = os.path.join(tmp, "shards"), os.path.join(tmp, "val")
    os.makedirs(shards)
    os.makedirs(val_dir)
    for j, part in enumerate(np.array_split(rest, N_SHARDS)):
        with gzip.open(os.path.join(shards, f"shard_{j:03d}.pickle.gz"),
                       "wb") as f:
            pickle.dump(subset_prepared(prepared, part), f)
    with gzip.open(os.path.join(val_dir, "val.pickle.gz"), "wb") as f:
        pickle.dump(subset_prepared(prepared, sorted(val)), f)
    total = scaled()
    evals = -(-len(val) // N_GRAPHS)
    stats: dict = {"shards": N_SHARDS, "streamed": len(rest),
                   "val": len(val)}
    for k in (1, 2):
        name = f"stream_k{k}"
        argv = ["--streaming", "--data-path", shards, "--val-path", val_dir,
                "--target", "e_above_hull", "--smoke-test", "--ckpt-dir",
                os.path.join(tmp, "logs"), "--run-name", name]
        if k > 1:
            argv += ["--steps-per-dispatch", str(k)]
        steps, keys = cli_steps(argv, range(2))
        want = scaled((PER_FORWARD, steps + evals), (PER_BACKWARD, steps))
        counts, _ = cli_call(f"cli.train --streaming --steps-per-dispatch {k}",
                             cli_train.main, argv, want, phase=10)
        for w, v in counts.items():
            total[w] += v
        recs = finite_metrics(os.path.join(tmp, "logs", "runs", name,
                                           "metrics.jsonl"))
        epochs = [r for r in recs if "train_loss" in r]
        if [r["step"] for r in epochs] != [steps // 2, steps] or \
                not any("val_mae" in r for r in recs):
            fail(f"cli.train --streaming (K = {k}) logged steps "
                 f"{[r['step'] for r in epochs]}, not {[steps // 2, steps]}, "
                 f"or no validation")
        if keys >= steps:
            fail(f"cli.train --streaming (K = {k}) captured {keys} graphs in "
                 f"{steps} steps")
        stats[name] = {"steps": steps, "graph_keys": keys,
                       "epochs": [{f: r[f] for f in (
                           "epoch", "epoch_time", "graphs_per_sec",
                           "train_loss")} for r in epochs],
                       "val_mae": [r["val_mae"] for r in recs
                                   if "val_mae" in r]}
        for r in epochs:
            print(f"[streaming] K = {k}, epoch {r['epoch']:.0f}: "
                  f"{r['epoch_time'] * 1e3:.0f} ms wall, "
                  f"{r['graphs_per_sec']:.1f} graphs/s, train loss "
                  f"{r['train_loss']:.5f} ({keys} step graphs captured in "
                  f"{steps} steps; in memory, phase 5: "
                  f"{[round(e['graphs_per_sec'], 1) for e in data['epochs']]}"
                  f" graphs/s) ({card})")
    print(f"[streaming] {len(rest)} crystals in {N_SHARDS} shards, {len(val)} "
          f"validated; launches {total}")
    return stats, total


def check_hyper_kernels_at_edge_rows(rec) -> dict[str, dict]:
    """#5, #6 and #7 against their plain versions on one edge HNet's
    recorded inputs and cotangent (E rows), two launches bit-identical,
    timed beside their bounds and the yardsticks of phases 2 and 4. The
    plain versions hold P (E x 16,512) in f32, about 1.2 GB at E =
    18,432: one call at a time."""
    from cgat_tpu_torch.ops.kernels import hyper_apply as hk
    hidden, k, bias, x = rec["saved"]
    g, o = rec["g"], rec["out_ch"]
    b, c = hidden.shape
    i = x.shape[1]
    work = hyper_work(b, c, i, o)
    yard = hyper_yardsticks(hidden, k, bias, x, g, o)
    calls = {
        "hyper_apply": (lambda: (hk.hyper_apply(hidden, k, bias, x, o),),
                        lambda: (hk.hyper_apply_plain(hidden, k, bias, x,
                                                      o),)),
        "hyper_apply_bwd_dhdx": (
            lambda: hk.hyper_apply_bwd_dhdx(hidden, k, bias, x, g, o),
            lambda: hk.hyper_apply_bwd_dhdx_plain(hidden, k, bias, x, g, o)),
        "hyper_apply_bwd_dk": (
            lambda: hk.hyper_apply_bwd_dk(hidden, x, g, o),
            lambda: hk.hyper_apply_bwd_dk_plain(hidden, x, g, o))}
    rows = {}
    with torch.no_grad():
        for name, (fn, plain) in calls.items():
            checks = [compare(f"{name} (E rows)", a, p)
                      for a, p in zip(fn(), plain())]
            b_ms, b_by = bound(*work[name], BF16_TENSOR_FLOPS)
            r = rows[name] = {
                "shape": [b, c, i, o], **checks_row(checks),
                "deterministic": deterministic(f"{name} (E rows)", fn),
                "ms": time_ms(fn), "device_ms": kernel_device_ms(fn),
                "plain_ms": time_ms(plain, reps=3, windows=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "cublas_ms": time_ms(yard[name], reps=5),
                "cublas_device_ms": kernel_device_ms(yard[name], n_runs=3)}
            torch.cuda.empty_cache()
            print(f"[variants] {name} at {b} edge rows (C {c}, I {i}, O "
                  f"{o}): max_abs_err {r['max_abs_err']:.3e}, norm-wise "
                  f"{r['rel_norm_err']:.3e}, two launches bit-identical, "
                  f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), "
                  f"bound {b_ms:.4f} ms ({b_by}), plain "
                  f"{r['plain_ms']:.4f} ms, yardstick {r['cublas_ms']:.4f} "
                  f"ms (device {fmt_ms(r['cublas_device_ms'])})")
    return rows


def variant_steps(name, trainer, n_steps, want_fwd, want_bwd, seen=None
                  ) -> tuple[list[float], dict[str, int]]:
    """``n_steps`` training steps of ``trainer`` (``train_step``), each
    with a finite loss and its kernel launches (counts read just before
    the step and just after) held to ``want_fwd`` and ``want_bwd``, a
    step whose key is new (its eager first step, then the capture) and a
    replay alike. Returns the losses and the launches of all the
    steps."""
    loader = trainer.loader(trainer.train_graphs, shuffle=True)
    total = scaled()
    want = scaled((want_fwd, 1), (want_bwd, 1))
    losses = []
    with (capture_backward_inputs() if seen is not None
          else contextlib.nullcontext({})) as rec:
        for i, batch in zip(range(n_steps), loader):
            counters.reset()
            loss = trainer.train_step(batch)["loss"]
            torch.cuda.synchronize()
            got = launch_counts()
            if got != want:
                fail(f"{name}, step {i}: kernel launches {got} != {want}")
            if not torch.isfinite(loss):
                fail(f"{name}, step {i}: non-finite loss {float(loss)}")
            losses.append(float(loss))
            for k, v in got.items():
                total[k] += v
    if seen is not None:
        seen.update(rec)
    return losses, total


def variants(tmp, cfg, state_dict, data) -> tuple[dict, dict]:
    """Phase 6: the model variants and trainer options at full width.

    1. The hyper-edge model (``no_hyper=False``, seeded weights) in a
       ``Trainer`` at phase 4's shapes: checked steps with exact launches,
       its card busy time and device events a step, and #5, #6 and #7 held
       against their plain versions on an edge HNet's recorded inputs
       (E rows); its bf16 forward against the CPU's at 8 crystals.
    2. ``cli.train --hyper-edges --smoke-test`` on phase 5's prepared data,
       then ``cli.evaluate`` on its run, each with exact launches.
    3. Each variant of ``variant_launches``: ``N_VARIANT_STEPS`` steps of the
       reference-default model from phase 2's weights, each with a finite
       loss and exact launches.
    Returns the phase's numbers and every kernel's launches in it."""
    from cgat_tpu_torch.cli import evaluate as cli_evaluate
    from cgat_tpu_torch.cli import train as cli_train
    from cgat_tpu_torch.data import collate
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.models import CGAtNet
    from cgat_tpu_torch.training import Trainer, TrainerConfig

    total = scaled()

    def add(counts):
        for key, v in counts.items():
            total[key] += v

    stats: dict = {}
    (he_fwd, he_bwd), table = variant_launches(cfg.n_graph)
    graphs = random_graphs(100, N_TRAIN_GRAPHS, n_atoms_range=(8, 16),
                           max_nbr=24, full_degree=True)
    tcfg = TrainerConfig(batch_size=N_GRAPHS, moment_dtype="bfloat16")

    # 1. the hyper-edge model at phase 4's shapes
    progress("phase 6: hyper-edge model")
    hcfg = dataclasses.replace(cfg, no_hyper=False)
    trainer = Trainer(tcfg, hcfg, graphs, device="cuda")
    trainer.init_state()
    seen: dict = {}
    losses, counts = variant_steps("hyper-edge", trainer, N_CHECKED_STEPS,
                                   he_fwd, he_bwd, seen)
    add(counts)
    rows_seen = sorted(int(key.rsplit("_", 1)[1]) for key in seen
                       if key.startswith("hyper_apply_"))
    if not rows_seen or rows_seen[-1] < MIN_EDGE_ROWS:
        fail(f"no edge HNet backward of at least {MIN_EDGE_ROWS} rows was "
             f"recorded (row counts {rows_seen})")
    edge_rows = check_hyper_kernels_at_edge_rows(
        seen[f"hyper_apply_{rows_seen[-1]}"])
    seen.clear()
    batch = next(iter(trainer.loader(trainer.train_graphs,
                                     shuffle=True))).to("cuda")

    def one_step():
        loss, _ = trainer.forward_loss(batch)
        trainer.backward(loss)
        trainer.apply_update()

    torch.cuda.reset_peak_memory_stats()      # the steps', not the checks'
    one_step()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    per_name = device_ms(one_step, 3)
    wall = float(np.median(walls))
    busy = sum(v[0] for v in per_name.values()) if per_name else None
    events = sum(v[1] for v in per_name.values()) if per_name else None
    stats["hyper_edge"] = {
        "edge_slots": int(batch.num_edge_slots),
        "node_slots": int(batch.num_node_slots), "losses": losses,
        "step_ms": wall, "device_busy_ms": busy, "device_events": events,
        "device_idle_share": None if busy is None else 1.0 - busy / wall,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "top_device_ms": None if not per_name else [
            [k[:70], v[0], v[1]] for k, v in sorted(
                per_name.items(), key=lambda kv: -kv[1][0])[:8]],
        "edge_rows": edge_rows}
    print(f"[variants] hyper-edge model, {int(batch.num_node_slots)} node "
          f"and {int(batch.num_edge_slots)} edge slots: losses "
          f"{[round(v, 5) for v in losses]}; one step on a resident batch "
          f"{wall:.2f} ms, device busy {fmt_ms(busy)} in "
          f"{events if events is None else round(events)} device events")
    for name, ms, count in stats["hyper_edge"]["top_device_ms"] or []:
        print(f"[variants]   {ms:8.4f} ms  {count:5.0f} x  {name}")

    # its bf16 forward on the card against the CPU's, at a small batch
    small = random_graphs(7, N_CPU_CHECK_GRAPHS, n_atoms_range=(8, 16),
                          max_nbr=24, full_degree=True)
    sb = collate(small, max_nbr=24, node_bucket=64, orig_fea=200)
    cpu_model = CGAtNet(hcfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               trainer.model.state_dict().items()})
    trainer.model.eval()
    with torch.inference_mode():
        got = trainer.model(sb.to("cuda")).cpu()
        t0 = time.perf_counter()
        want = cpu_model.eval()(sb)
    cpu_s = time.perf_counter() - t0
    trainer.model.train()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not torch.allclose(
            got, want, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale):
        fail(f"hyper-edge model, card vs CPU forward: max abs diff "
             f"{err:.3e} (max|out| {scale:.3e})")
    stats["hyper_edge"].update(cpu_check_abs_err=err, cpu_check_s=cpu_s)
    print(f"[variants] hyper-edge model, card vs CPU bf16 forward on "
          f"{N_CPU_CHECK_GRAPHS} crystals: max abs diff {err:.3e}, max|out| "
          f"{scale:.3e} (rtol {MODEL_RTOL}, atol {MODEL_RTOL} x max|out|); "
          f"the CPU forward took {cpu_s:.1f} s")
    del trainer, cpu_model, batch
    torch.cuda.empty_cache()

    # 2. the CLIs with --hyper-edges on phase 5's prepared data
    evals_val = data["val_batches"]

    def want(fwd_n, bwd_n):
        return scaled((he_fwd, fwd_n), (he_bwd, bwd_n))

    logs = os.path.join(tmp, "logs")
    run = os.path.join(logs, "runs", "hyper_edges")
    argv = ["--data-path", data["data_path"], "--target", "e_above_hull",
            "--smoke-test", "--hyper-edges", "--ckpt-dir", logs,
            "--run-name", "hyper_edges"]
    steps, _ = cli_steps(argv, range(2))
    add(cli_call("cli.train --hyper-edges --smoke-test", cli_train.main,
                 argv, want(steps + evals_val, steps), phase=6)[0])
    finite_metrics(os.path.join(run, "metrics.jsonl"))
    counts, out = cli_call("cli.evaluate (hyper edges)", cli_evaluate.main,
                           [run], want(data["test_batches"], 0), phase=6)
    add(counts)
    stats["hyper_edge_cli_test"] = json.loads(out.strip().splitlines()[-1])
    if not all(math.isfinite(v) for v in stats["hyper_edge_cli_test"].values()):
        fail(f"cli.evaluate --hyper-edges: non-finite metrics "
             f"{stats['hyper_edge_cli_test']}")

    # 3. the other variants from phase 2's weights
    with open(os.path.join(tmp, f"{PLUGIN}.py"), "w") as fh:
        fh.write(PLUGIN_SOURCE)
    sys.path.insert(0, tmp)
    try:
        stats["variants"] = {}
        for name, mkw, tkw, fwd, bwd in table:
            progress(f"phase 6: {name}")
            vcfg = dataclasses.replace(cfg, **mkw)
            sd = state_dict if vcfg.update_edges else {
                k: v for k, v in state_dict.items() if ".Edge." not in k}
            t0 = time.perf_counter()
            trainer = Trainer(dataclasses.replace(tcfg, **tkw), vcfg, graphs,
                              device="cuda")
            trainer.init_state(sd)
            losses, counts = variant_steps(name, trainer, N_VARIANT_STEPS,
                                           fwd, bwd)
            add(counts)
            if tkw.get("version") and type(trainer.model).__module__ != PLUGIN:
                fail(f"--version built {type(trainer.model).__module__}")
            keys = len(trainer.step_graphs.graphs)
            stats["variants"][name] = {"losses": losses, "graph_keys": keys,
                                       "s": time.perf_counter() - t0}
            per_step = {k: v for k, v in scaled((fwd, 1), (bwd, 1)).items()
                        if v}
            print(f"[variants] {name}: {N_VARIANT_STEPS} steps ({keys} step "
                  f"graphs captured), losses "
                  f"{[round(v, 5) for v in losses]}, launches a step "
                  f"{per_step}")
            del trainer
            torch.cuda.empty_cache()
    finally:
        sys.path.remove(tmp)
    return stats, total


def kernel_events(per_name: dict) -> dict[str, float]:
    """Device events a run of each entry's kernels (``REPLAY_KERNELS``)
    in a ``device_ms`` result."""
    def named(k, pat):
        return any(p in k for p in ((pat,) if isinstance(pat, str) else pat))
    return {w: round(sum(v[1] for k, v in per_name.items() if named(k, pat)),
                     6) for w, pat in REPLAY_KERNELS.items()}


def events_a_call(prof: dict, calls: dict) -> dict[str, float]:
    """Device events a wrapper call of each kernel that ``calls`` (wrapper
    calls a run of an eager path, exact) shows launched, from its
    profile; each must be a whole number."""
    events = kernel_events(prof)
    per_call = {k: events[k] / c for k, c in calls.items() if c}
    if any(v < 1 or v != round(v) for v in per_call.values()):
        fail(f"device events a call {per_call} are not whole numbers")
    return per_call


def replayed_launches(prof: dict, per_call: dict) -> dict[str, float]:
    """Wrapper calls a run of a replayed path stands for: each kernel's
    device events over its events a call (a kernel not in ``per_call``
    counts its events, which must then be 0)."""
    return {k: v / per_call.get(k, 1) for k, v in kernel_events(prof).items()}


def timed_ms(fn, n: int) -> list[float]:
    """Host-clock ms of ``n`` calls of ``fn``, each ended by a
    synchronise."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def fused_against_foreach(tcfg, params, grads) -> dict[str, int]:
    """The fused AdamW pass against the ``_foreach`` sequence
    (``AdamW.update_plain``) on ``make_optimizer``'s flat layout from the
    same parameters, at one real step's gradients 20 times over, with the
    first moment in bf16 and in f32: p, mu and nu the same bits after 1
    and after 20 updates. Returns the updates checked a dtype."""
    from cgat_tpu_torch.training import make_optimizer

    checked = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(tcfg, moment_dtype=dtype)
        pair = []
        for plain in (False, True):
            ps = [p.detach().clone().requires_grad_() for p in params]
            opt = make_optimizer(cfg, ps)
            if plain:
                opt.inner.update = opt.inner.update_plain
            pair.append((ps, opt))
        for i in range(N_FUSED_CHECKED):
            for ps, opt in pair:
                for p, g in zip(ps, grads):
                    p.grad = g
                opt.step()
            if i in (0, N_FUSED_CHECKED - 1):
                torch.cuda.synchronize()
                a, b = (opt.inner for _, opt in pair)
                if not all(torch.equal(x, y) for x, y in zip(
                        [*a.params, *a.mu, *a.nu],
                        [*b.params, *b.mu, *b.nu])):
                    fail(f"the fused AdamW pass and the _foreach sequence "
                         f"differ after {i + 1} updates ({dtype} mu)")
        checked[dtype] = N_FUSED_CHECKED
    return checked


def flat_against_plain(tcfg, eager, batch) -> dict:
    """Flat AdamW (``make_optimizer``'s, as in every AdamW run) and AdamW
    on the parameters as they are (bf16 first moment both) from the same
    parameters and the same gradients of one real step: the same bits
    after one update (parameters and state); the fused pass against the
    ``_foreach`` sequence (:func:`fused_against_foreach`); then each
    optimizer's host ms to issue an update and wall ms with it done, its
    device events a step (``multi_tensor_apply`` launches among them) and
    the fused pass's device ms beside its bound, at most ``SHARE_LIMIT``
    of it, and its launches an eager update; the flat layout's
    ``_foreach`` sequence (the fused pass's plain version) beside them."""
    from cgat_tpu_torch.ops.kernels import adamw
    from cgat_tpu_torch.training import make_optimizer
    from cgat_tpu_torch.training.flatten import FlatOptimizer
    from cgat_tpu_torch.training.optim import AdamW

    loss, _ = eager.forward_loss(batch)
    eager.backward(loss)
    params = list(eager.model.parameters())
    grads = [None if p.grad is None else p.grad.clone() for p in params]
    runs = {}
    for flat in (False, True):
        ps = [p.detach().clone().requires_grad_() for p in params]
        opt = (make_optimizer(tcfg, ps) if flat else
               AdamW(ps, tcfg.learning_rate, weight_decay=tcfg.weight_decay,
                     mu_dtype=torch.bfloat16))
        if isinstance(opt, FlatOptimizer) != flat:
            fail(f"make_optimizer gave {type(opt).__name__} for AdamW")
        for p, g in zip(ps, grads):
            p.grad = g
        opt.step()
        runs["flat" if flat else "plain"] = ps, opt
    torch.cuda.synchronize()
    (pp, popt), (fp, fopt) = runs["plain"], runs["flat"]
    pstate, fstate = popt.state_dict(), fopt.state_dict()
    if not (all(torch.equal(a, b) for a, b in zip(pp, fp))
            and all(torch.equal(a, b) for name in ("mu", "nu")
                    for a, b in zip(pstate[name], fstate[name]))):
        fail("flat and plain AdamW differ after one update from the same "
             "gradients")
    res = {"tensors": len(params), "bit_equal": True,
           "fused_vs_foreach_updates": fused_against_foreach(tcfg, params,
                                                              grads)}
    ps = [p.detach().clone().requires_grad_() for p in params]
    foreach = make_optimizer(tcfg, ps)
    foreach.inner.update = foreach.inner.update_plain
    for p, g in zip(ps, grads):
        p.grad = g
    runs["foreach"] = ps, foreach
    n = sum(p.numel() for p in params)
    res["bound_ms"], res["bound_by"] = bound(
        *roofline.adamw_work(n, fopt.inner.mu[0].element_size()),
        roofline.PEAKS["adamw"])
    for key, (ps, opt) in runs.items():
        counters.reset()
        opt.step()
        fused_launches = adamw.stats()["launches"]
        issue = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            issue.append((time.perf_counter() - t0) * 1e3)
        wall = timed_ms(opt.step, 10)
        per_name = device_ms(opt.step, 3)
        res[key] = {
            "inner_tensors": (len(ps) if key == "plain"
                              else len(opt.layout.inner)),
            "host_issue_ms_median": float(np.median(issue)),
            "wall_ms_median": float(np.median(wall)),
            "device_busy_ms": sum(v[0] for v in per_name.values()),
            "device_events": sum(v[1] for v in per_name.values()),
            "multi_tensor_apply": sum(v[1] for k, v in per_name.items()
                                      if "multi_tensor_apply" in k),
            "fused_device_ms": sum(v[0] for k, v in per_name.items()
                                   if FUSED_ADAMW in k),
            "fused_launches": fused_launches}
    res["share"] = res["bound_ms"] / res["flat"]["fused_device_ms"]
    if res["share"] > SHARE_LIMIT:
        fail(f"the fused AdamW pass reads {res['share']:.3f} of its bound")
    eager.opt.zero_grad()
    return res


def prefetched_steps(trainer, card: str) -> dict:
    """The replayed step with its groups' collate and copy, over one epoch
    of N_DISPATCH_LOOP + 1 groups (``trainer.grouped_loader``), iterated
    inline and through ``PrefetchLoader`` (which collates the next groups
    on a host thread, into pageable memory, while the card works), in
    turns (inline, prefetched, prefetched, inline): each group's ms a step
    from the end of the one before, the first group of each run left out
    (the prefetcher's start)."""
    from cgat_tpu_torch.data.prefetch import PrefetchLoader
    from cgat_tpu_torch.data.synthetic import random_graphs

    graphs = random_graphs(300, N_GRAPHS * N_DISPATCH * (N_DISPATCH_LOOP + 1),
                           n_atoms_range=(8, 16), max_nbr=24,
                           full_degree=True)
    loader = trainer.grouped_loader(graphs)
    runs = {"inline": [], "prefetch": []}
    for epoch, name in enumerate(("inline", "prefetch", "prefetch",
                                  "inline")):
        it = PrefetchLoader(loader) if name == "prefetch" else loader
        it.set_epoch(epoch)
        per_step = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for group in it:
            trainer.train_group(group)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            per_step.append((t1 - t0) * 1e3 / N_DISPATCH)
            t0 = t1
        runs[name] += per_step[1:]
    res = {f"{name}_ms_{stat}": float(fn(v)) for name, v in runs.items()
           for stat, fn in (("median", np.median), ("min", np.min))}
    res["groups"] = len(loader)
    print(f"[dispatch] replayed step with its groups' collate and copy over "
          f"{len(loader)} groups of {N_DISPATCH}: inline median "
          f"{res['inline_ms_median']:.2f} ms (min {res['inline_ms_min']:.2f}),"
          f" through the PrefetchLoader median {res['prefetch_ms_median']:.2f}"
          f" ms (min {res['prefetch_ms_min']:.2f}); unpinned copies ({card})")
    return res


def dropout_groups(tcfg, cfg, state_dict, graphs, per_call, plain_losses,
                   card: str) -> dict:
    """Phase 7's dropout groups: two ``dropout=DROPOUT`` trainers from one
    state take the same K = 4 groups, one eagerly step by step and one
    through ``train_group`` (replays after each shape's first step): the
    losses must be the same bits and differ from the dropout-free
    model's on the same groups; a replayed dropout step counts and
    launches exactly what an eager one launches (device events by kernel
    name: the dropout kernel once a node layer forward and once
    backward); eager and replayed step times, busy ms, idle share."""
    from cgat_tpu_torch.training import Trainer

    progress("phase 7: dropout groups")
    n = cfg.n_graph
    dcfg = dataclasses.replace(cfg, dropout=DROPOUT)
    eager = Trainer(tcfg, dcfg, graphs, device="cuda")
    eager.init_state(state_dict)
    graph = Trainer(tcfg, dcfg, graphs, device="cuda")
    graph.init_state(state_dict)
    loader = graph.grouped_loader(graph.train_graphs)
    got = {"eager": [], "graph": []}
    for epoch in range(N_DISPATCH_CHECKED):
        loader.set_epoch(epoch)
        group = next(iter(loader))
        gdev = group.to("cuda")
        got["eager"] += [float(eager_step(eager, gdev.map(
            lambda t, i=i: t[i]))["loss"]) for i in range(N_DISPATCH)]
        got["graph"] += [float(m["loss"]) for m in graph.train_group(group)]
    keys = len(graph.step_graphs.graphs)
    if got["eager"] != got["graph"] or not all(map(math.isfinite,
                                                   got["graph"])):
        fail(f"replayed dropout steps' losses {got['graph']} differ from "
             f"the eager dropout steps' {got['eager']}")
    if keys >= len(got["graph"]):
        fail(f"no dropout step replayed ({keys} keys captured)")
    if got["graph"] == plain_losses:
        fail("dropout changed no loss")
    batch = gdev.map(lambda t: t[0])
    d_want = scaled(({**PER_FORWARD, "mh_network": 0, "segment_attention": 1,
                      "dropout": n}, 1), (dropout_backward(n), 1))
    counters.reset()
    eager_prof = device_ms(lambda: eager_step(eager, batch), 3)
    calls = {k: v / 3 for k, v in launch_counts().items()}
    if calls != d_want:
        fail(f"eager dropout steps launched {calls} a step, not {d_want}")
    d_per_call = {**per_call, **events_a_call(eager_prof, calls)}
    counters.reset()
    replay_prof = device_ms(lambda: graph.train_step(batch), 3)
    counted = {k: v / 3 for k, v in launch_counts().items()}
    if counted != d_want:
        fail(f"a replayed dropout step counted {counted} launches, not "
             f"{d_want}")
    replayed = replayed_launches(replay_prof, d_per_call)
    if replayed != d_want:
        fail(f"a replayed dropout step launched {replayed}, not {d_want}")
    res = {"losses": got["graph"], "graph_keys": keys,
           "replay_launches": {k: int(v) for k, v in replayed.items()}}
    for name, fn, prof in (
            ("eager", lambda: eager_step(eager, batch), eager_prof),
            ("graph", lambda: graph.train_step(batch), replay_prof)):
        walls = timed_ms(fn, N_DISPATCH_TIMED)
        busy = sum(v[0] for v in prof.values())
        med = float(np.median(walls))
        res[name] = {"step_ms_median": med,
                     "step_ms_min": float(np.min(walls)),
                     "device_busy_ms": busy,
                     "device_idle_share": 1.0 - busy / med,
                     "device_events": sum(v[1] for v in prof.values())}
    print(f"[dispatch] dropout {DROPOUT}, {len(got['graph'])} steps in "
          f"groups of {N_DISPATCH} ({keys} step graphs captured): replayed "
          f"losses equal the eager dropout steps' bit for bit "
          f"{[round(v, 5) for v in got['graph']]}; a replayed dropout step "
          f"launches {res['replay_launches']}")
    for name in ("eager", "graph"):
        r = res[name]
        print(f"[dispatch] dropout {name} step on a resident batch: median "
              f"{r['step_ms_median']:.2f} ms, min {r['step_ms_min']:.2f} ms "
              f"of {N_DISPATCH_TIMED}; device busy {r['device_busy_ms']:.2f} "
              f"ms in {r['device_events']:.0f} device events, idle share "
              f"{r['device_idle_share']:.3f} ({card})")
    return res


def dispatch(tmp, cfg, state_dict, data, card: str) -> tuple[dict, dict]:
    """Phase 7: ``steps_per_dispatch`` as CUDA graphs of the training step
    at full width (phase 4's model, traffic and AdamW with a bf16 first
    moment, flat as every AdamW; ``TrainerConfig(steps_per_dispatch=4)``).

    1. Two trainers from one state take the same groups of 4 batches,
       one step by one step eagerly (``eager_step``) and one group by one
       group (``train_group``: graph replays after each shape's first,
       eager, step): the losses must be the same bits; the largest
       parameter difference is printed.
    2. Flat and plain AdamW take one update from the same gradients: the
       same bits; the fused pass and the ``_foreach`` sequence the same
       bits over 20 updates, mu in bf16 and in f32; their host ms, device
       events and ``multi_tensor_apply`` launches a step, and the fused
       pass's device ms beside its bound.
    3. The launches a replayed step: its counts (its capture's, added by
       the replay) and each kernel's device events from the profiler,
       divided by its events a call in an eager step, must be 10/6/20
       forward and 10/6/20/20/11 backward; its optimizer is the fused pass
       alone, 1 to 3 ``multi_tensor_apply`` launches, which
       ``fused_stats`` counts over the model's parameters.
    4. Eager and replayed steps on a resident batch (median and minimum
       of ``N_DISPATCH_TIMED``), and each path's ms a step over groups
       collated on the host; the card's busy ms, idle share and device
       events a step on each path; capture seconds per shape; peak
       memory.
    5. ``cli.train --steps-per-dispatch 2 --smoke-test`` on phase 5's data:
       finite metrics, and one step's launches a step, eager or replayed,
       and one forward's a validation batch.
    Returns the phase's numbers and the launches a replayed step."""
    from cgat_tpu_torch.cli import train as cli_train
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.training import Trainer, TrainerConfig
    from cgat_tpu_torch.training.optim import fused_stats

    allocated = settled_allocated()
    torch.cuda.reset_peak_memory_stats()
    graphs = random_graphs(100, N_TRAIN_GRAPHS, n_atoms_range=(8, 16),
                           max_nbr=24, full_degree=True)
    tcfg = TrainerConfig(batch_size=N_GRAPHS, moment_dtype="bfloat16",
                         steps_per_dispatch=N_DISPATCH)
    eager = Trainer(tcfg, cfg, graphs, device="cuda")
    eager.init_state(state_dict)
    graph = Trainer(tcfg, cfg, graphs, device="cuda")
    graph.init_state(state_dict)
    loader = graph.grouped_loader(graph.train_graphs)
    epoch = 0

    def next_group():
        nonlocal epoch
        loader.set_epoch(epoch)
        epoch += 1
        return next(iter(loader))

    def eager_group(gdev):
        return [eager_step(eager, gdev.map(lambda t: t[i]))
                for i in range(N_DISPATCH)]

    # 1. graph replays against eager steps on the same groups
    progress("phase 7: graph against eager steps")
    got = {"eager": [], "graph": []}
    for _ in range(N_DISPATCH_CHECKED):
        group = next_group()
        gdev = group.to("cuda")
        got["eager"] += [m["loss"] for m in eager_group(gdev)]
        got["graph"] += [m["loss"] for m in graph.train_group(group)]
    losses = {k: [float(x) for x in v] for k, v in got.items()}
    with torch.no_grad():
        param_diff = max(float((a - b).abs().max()) for a, b in zip(
            eager.model.parameters(), graph.model.parameters()))
    if losses["eager"] != losses["graph"] or not all(
            map(math.isfinite, losses["graph"])):
        fail(f"graph-replayed losses {losses['graph']} differ from the "
             f"eager steps' {losses['eager']} (max parameter difference "
             f"{param_diff:.3e})")
    stats: dict = {"steps_per_dispatch": N_DISPATCH,
                   "checked_steps": len(losses["graph"]),
                   "losses": losses["graph"],
                   "max_param_diff": param_diff}
    print(f"[dispatch] {len(losses['graph'])} steps in groups of "
          f"{N_DISPATCH}: graph-replayed losses equal the eager steps' bit "
          f"for bit {[round(v, 5) for v in losses['graph']]}, max parameter "
          f"difference {param_diff:.3e} ({card})")

    # 2. flat against plain AdamW
    progress("phase 7: flat optimizer")
    batch = gdev.map(lambda t: t[0])
    stats["optimizer"] = opt = flat_against_plain(tcfg, eager, batch)
    for key in ("plain", "flat", "foreach"):
        r = opt[key]
        print(f"[dispatch] AdamW {key} over {r['inner_tensors']} tensors: "
              f"host issue {r['host_issue_ms_median']:.2f} ms, wall "
              f"{r['wall_ms_median']:.2f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms in {r['device_events']:.0f} "
              f"events ({r['multi_tensor_apply']:.0f} multi_tensor_apply), "
              f"the fused pass {r['fused_device_ms']:.4f} ms in "
              f"{r['fused_launches']} launches (bound {opt['bound_ms']:.4f} "
              f"ms, {opt['bound_by']}) a step ({card})")
    print(f"[dispatch] flat and plain AdamW (bf16 first moment) give the "
          f"same bits after one update of {opt['tensors']} parameter "
          f"tensors; the fused pass and the _foreach sequence the same "
          f"bits after 1 and {N_FUSED_CHECKED} updates at the step's "
          f"gradients, mu in bf16 and in f32")

    # 3. the launches of a replayed step, from the profiler
    progress("phase 7: launches under replay")
    counters.reset()
    eager_prof = device_ms(lambda: eager_step(eager, batch), 3)
    calls = {k: v / 3 for k, v in launch_counts().items()}
    want = scaled((PER_FORWARD, 1), (PER_BACKWARD, 1))
    if calls != want:
        fail(f"eager steps launched {calls} a step, not {want}")
    if not eager_prof:
        fail("the profiler recorded no device events")
    per_call = events_a_call(eager_prof, calls)
    counters.reset()
    replay_prof = device_ms(lambda: graph.train_step(batch), 3)
    fused = {k: v / 3 for k, v in fused_stats().items()}
    counted = {k: v / 3 for k, v in launch_counts().items()}
    if counted != want:
        fail(f"a replayed step counted {counted} launches, not {want}")
    replayed = replayed_launches(replay_prof, per_call)
    if replayed != want:
        fail(f"a replayed step launched {replayed}, not {want}")
    stats["replay_launches"] = {k: int(v) for k, v in replayed.items()}
    stats["device_events_a_call"] = per_call
    print(f"[dispatch] a replayed step launches {stats['replay_launches']} "
          f"(device events by kernel name, {per_call} a call)")
    # the optimizer of a replayed step: the fused pass alone, counted
    n_params = sum(p.numel() for p in graph.model.parameters())
    mta = sum(v[1] for k, v in replay_prof.items()
              if "multi_tensor_apply" in k)
    if not (1 <= mta <= 3 and fused == {"launches": mta,
                                        "elements": n_params}):
        fail(f"a replayed step's optimizer made {mta} multi_tensor_apply "
             f"launches and counted {fused}, not 1 to 3 fused launches "
             f"over its {n_params} parameters")
    stats["replay_optimizer"] = {"multi_tensor_apply": mta, **fused}
    print(f"[dispatch] a replayed step's optimizer: {mta:.0f} "
          f"multi_tensor_apply launches, the fused AdamW pass counting "
          f"{fused['launches']:.0f} launches over {fused['elements']:.0f} "
          f"elements ({n_params} parameters)")

    stats["dropout"] = dropout_groups(tcfg, cfg, state_dict, graphs, per_call,
                                      losses["graph"], card)

    # 4. step times, busy time, events, capture, memory
    progress("phase 7: timing")
    walls = {"eager": timed_ms(lambda: eager_step(eager, batch),
                               N_DISPATCH_TIMED),
             "graph": timed_ms(lambda: graph.train_step(batch),
                               N_DISPATCH_TIMED)}
    for name, prof in (("eager", eager_prof), ("graph", replay_prof)):
        busy = sum(v[0] for v in prof.values())
        med = float(np.median(walls[name]))
        stats[name] = {
            "step_ms_median": med, "step_ms_min": float(np.min(walls[name])),
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / med,
            "device_events": sum(v[1] for v in prof.values()),
            "top_device_ms": [[k[:70], v[0], v[1]] for k, v in sorted(
                prof.items(), key=lambda kv: -kv[1][0])[:8]]}
    for name, tr in (("eager", eager), ("graph", graph)):
        per_step = []
        for _ in range(N_DISPATCH_LOOP):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group = next_group()
            if name == "graph":
                tr.train_group(group)
            else:
                eager_group(group.to("cuda"))
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) * 1e3 / N_DISPATCH)
        stats[name].update(loop_ms_median=float(np.median(per_step)),
                           loop_ms_min=float(np.min(per_step)))
    stats["prefetch"] = prefetched_steps(graph, card)
    stats["capture_s"] = {str(k[0][0][0]): s for k, s in
                          graph.step_graphs.capture_s.items()}
    stats["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("eager", "graph"):
        r = stats[name]
        print(f"[dispatch] {name} step on a resident batch: median "
              f"{r['step_ms_median']:.2f} ms, min {r['step_ms_min']:.2f} ms "
              f"of {N_DISPATCH_TIMED}; device busy {r['device_busy_ms']:.2f} "
              f"ms in {r['device_events']:.0f} device events, idle share "
              f"{r['device_idle_share']:.3f}; with the groups' collate and "
              f"copy {r['loop_ms_median']:.2f} ms a step (min "
              f"{r['loop_ms_min']:.2f}, {N_DISPATCH_LOOP} groups) ({card})")
        for k, ms, count in r["top_device_ms"]:
            print(f"[dispatch]   {ms:8.4f} ms  {count:5.0f} x  {k}")
    print(f"[dispatch] capture s by node slots {stats['capture_s']}; peak "
          f"device memory {stats['peak_memory_gib']:.2f} GiB ({card})")
    del eager, graph, tr, gdev, batch, got
    stats["left_after_drop_bytes"] = settled_allocated() - allocated
    print(f"[dispatch] both trainers dropped (the card's one side stream "
          f"stays): {stats['left_after_drop_bytes']} bytes stay allocated")

    # 5. the CLI with --steps-per-dispatch 2
    argv = ["--data-path", data["data_path"], "--target", "e_above_hull",
            "--smoke-test", "--steps-per-dispatch", "2", "--ckpt-dir",
            os.path.join(tmp, "logs"), "--run-name", "dispatch"]
    # 2 epochs; each step one step's launches, eager or replayed
    steps, keys = cli_steps(argv, range(2))
    cli_want = scaled((PER_FORWARD, steps + data["val_batches"]),
                      (PER_BACKWARD, steps))
    counts, _ = cli_call("cli.train --steps-per-dispatch 2 --smoke-test",
                         cli_train.main, argv, cli_want, phase=7)
    recs = [r for r in finite_metrics(os.path.join(
        tmp, "logs", "runs", "dispatch", "metrics.jsonl"))
        if "train_loss" in r]
    if [r["step"] for r in recs] != [steps // 2, steps]:
        fail(f"cli.train --steps-per-dispatch 2 logged steps "
             f"{[r['step'] for r in recs]}, not {[steps // 2, steps]}")
    stats["cli"] = {"steps": steps, "graph_keys": keys,
                    "epochs": [{k: r[k] for k in ("epoch", "epoch_time",
                                                  "graphs_per_sec",
                                                  "train_loss")}
                               for r in recs]}
    for r in stats["cli"]["epochs"]:
        print(f"[dispatch] cli epoch {r['epoch']:.0f}: "
              f"{r['epoch_time'] * 1e3:.0f} ms wall, "
              f"{r['graphs_per_sec']:.1f} graphs/s, train loss "
              f"{r['train_loss']:.5f} ({keys} step graphs captured)")
    return stats, counts


def parallel_graphs():
    """Phase 8's traffic: phase 4's kind of crystals, 64 a replica batch,
    enough for N_PARALLEL_STEPS groups of 2 replicas."""
    from cgat_tpu_torch.data.synthetic import random_graphs
    return random_graphs(200, 2 * N_GRAPHS * N_PARALLEL_STEPS,
                         n_atoms_range=(8, 16), max_nbr=24, full_degree=True)


def _parallel_rank(rank: int, n: int, port: int, spec: dict) -> None:
    """One rank of a phase-8 world (spawned): a ``Trainer`` with
    ``n_devices`` n and ``edge_shards`` S takes N_PARALLEL_STEPS steps on
    the rank's part of each group; its losses, step times and kernel
    launches a step go to ``spec["out"]`` + rank."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch.distributed as dist
    from cgat_tpu_torch.models import CGATConfig
    from cgat_tpu_torch.parallel import collectives, init_distributed
    from cgat_tpu_torch.training import Trainer, TrainerConfig

    init_distributed("cuda", backend=spec["backend"])
    t = Trainer(TrainerConfig(n_devices=n, edge_shards=spec["edge_shards"],
                              batch_size=N_GRAPHS, moment_dtype="bfloat16"),
                CGATConfig(compute_dtype="bfloat16"), mean=spec["mean"],
                std=spec["std"], device="cuda")
    t.init_state(torch.load(spec["state_dict"]))
    rec = {"losses": [], "step_ms": [], "launches": [],
           "backend": t.mesh.backend, "device": str(t.device)}
    for i, group in enumerate(t.mesh_loader(parallel_graphs(),
                                            shuffle=False)):
        if i == N_PARALLEL_STEPS:
            break
        batch = t.rank_batch(group)
        torch.cuda.synchronize()
        counters.reset()
        before = dict(collectives.calls)
        t0 = time.perf_counter()
        m = t.train_step(batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["collectives"] = {k: v - before[k]
                              for k, v in collectives.calls.items()}
        rec["launches"].append(launch_counts())
        rec["losses"].append(float(m["loss"]))
    rec["replayed"] = t.step_graphs is not None
    if spec["edge_shards"] > 1:
        rec["dropout_twice"] = dropout_twice(t, spec["state_dict"], batch)
    torch.save(rec, f"{spec['out']}{rank}")
    dist.destroy_process_group()


def dropout_twice(t, state_path: str, batch) -> dict:
    """A ``dropout=0.1`` model's forward and backward on this rank's part
    of an edge-sharded group, twice from the same weights and step: the
    global loss and the world's summed gradient must have the same bits
    (the halo layer's softmax and sums and the sharded pool go through
    the segment-sum kernel with their gather plans, so nothing sums with
    atomics). Returns the check and the first run's launches."""
    from cgat_tpu_torch.models import CGATConfig, CGAtNet
    from cgat_tpu_torch.models.cgat import DropoutKey
    from cgat_tpu_torch.parallel import (global_loss_and_metrics,
                                         reduce_gradients)
    mesh = t.mesh
    model = CGAtNet(CGATConfig(compute_dtype="bfloat16", dropout=DROPOUT))
    model.load_state_dict(torch.load(state_path), strict=True)
    model = model.to(t.device).train()
    key = DropoutKey((0, mesh.dp.index, mesh.edge.index),
                     torch.zeros((), dtype=torch.int64, device=t.device))
    runs, launches = [], None
    for _ in range(2):
        counters.reset()
        model.zero_grad(set_to_none=True)
        out = model(batch, edge_group=mesh.edge, dropout_key=key)
        loss, _ = global_loss_and_metrics(out, batch, t.mean, t.std,
                                          t.criterion, mesh)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        reduce_gradients(grads, mesh.world)
        torch.cuda.synchronize()
        launches = launches or launch_counts()
        runs.append((loss.detach().clone(),
                     torch.cat([g.reshape(-1) for g in grads])))
    return {"same_bits": bool(torch.equal(runs[0][0], runs[1][0])
                              and torch.equal(runs[0][1], runs[1][1])),
            "loss": float(runs[0][0]),
            "grad_norm": float(torch.linalg.vector_norm(runs[0][1])),
            "max_abs_grad_diff": float((runs[0][1] - runs[1][1]).abs()
                                       .max()),
            "launches": launches}


def one_process_losses(cfg, state_dict, mean, std, dp: int, shards: int
                       ) -> list[float]:
    """The losses of one process on the card taking the steps a dp x
    ``shards`` world takes: each step's loss the global masked mean over
    the group's dp replica batches (collated whole, not edge-sharded),
    its gradient, and AdamW (eager steps)."""
    from cgat_tpu_torch.parallel import ParallelLoader
    from cgat_tpu_torch.training import Trainer, TrainerConfig

    t = Trainer(TrainerConfig(batch_size=N_GRAPHS, moment_dtype="bfloat16"),
                cfg, mean=mean, std=std, device="cuda")
    t.init_state(state_dict)
    losses = []
    for i, group in enumerate(ParallelLoader(parallel_graphs(), N_GRAPHS, dp,
                                             max_nbr=24, num_comp_slots=12)):
        if i == N_PARALLEL_STEPS:
            break
        group = group.to("cuda")
        out = torch.stack([t.model(group.map(lambda x: x[d]))
                           for d in range(dp)])
        loss = t.criterion(out[..., 0], out[..., 1],
                           (group.target - mean) / std, group.graph_mask)
        t.backward(loss)
        t.apply_update()
        losses.append(loss.detach().item())
    return losses


def exchange_stats(shards: int = 2) -> dict:
    """The boundary exchange of the first edge = 2 group: rows a rank sends
    a layer (every slot of the all_to_all, the padded self slot included),
    the real boundary rows among them, and their bytes in bf16 at 128
    features; the backward sends as many rows back."""
    from cgat_tpu_torch.data import collate
    group = parallel_graphs()[:N_GRAPHS]
    b = collate(group, num_graphs=N_GRAPHS, num_comp_slots=12, max_nbr=24,
                orig_fea=200, edge_shards=shards)
    H = b.halo_send_idx.shape[1]
    cap_h = b.halo_mask.shape[0] // shards
    real = [int(torch.unique(b.halo_src_ext[d * cap_h:(d + 1) * cap_h][
        b.halo_mask[d * cap_h:(d + 1) * cap_h]]).numel())
        for d in range(shards)]
    return {"halo_slots": H, "rows_per_rank_layer": shards * H,
            "bytes_per_rank_layer": shards * H * 128 * 2,
            "real_rows_received_per_rank_layer": real,
            "local_edge_slots_per_shard": b.edge_mask.shape[0] // shards,
            "halo_edge_slots_per_shard": cap_h,
            "real_halo_edges_per_shard": [
                int(b.halo_mask[d * cap_h:(d + 1) * cap_h].sum())
                for d in range(shards)]}


def run_world(tmp, n: int, shards: int, backend: str, state_path: str,
              mean: float, std: float) -> list[dict]:
    """Start an ``n``-rank world of ``_parallel_rank`` on this host (the
    kernels already built) and return each rank's record."""
    from cgat_tpu_torch.parallel.distributed import free_port
    out = os.path.join(tmp, f"world-{n}-{shards}-{backend}-rank")
    spec = {"edge_shards": shards, "backend": backend, "mean": mean,
            "std": std, "state_dict": state_path, "out": out}
    torch.multiprocessing.spawn(_parallel_rank, args=(n, free_port(), spec),
                                nprocs=n, join=True)
    return [torch.load(f"{out}{r}") for r in range(n)]


def rel_diff(got: list[float], want: list[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def parallel(tmp, cfg, state_dict, card: str) -> tuple[dict, dict]:
    """Phase 8: the data-parallel and edge-sharded trainer at full width.
    (b) dp = 2 and (c) edge = 2 as two gloo ranks sharing the card (eager
    steps, gloo's collectives staged through the host) against one
    process on the same groups, with each rank's kernel launches a step
    exact and (c)'s pair-path launches and exchange sizes; (a) a one-rank
    NCCL world through the parallel step, replayed with its collectives
    in the graph, against the one-card trainer; (d) dp = 2 over NCCL on
    two cards, replayed, or a line saying it was skipped."""
    import torch.distributed as dist
    from cgat_tpu_torch.data import collate
    from cgat_tpu_torch.parallel import collectives, init_distributed
    from cgat_tpu_torch.parallel.distributed import free_port
    from cgat_tpu_torch.training import Trainer, TrainerConfig

    graphs = parallel_graphs()
    ys = np.asarray([g.target for g in graphs], np.float64)
    mean, std = float(ys.mean()), float(ys.std(ddof=1))
    state_path = os.path.join(tmp, "parallel_weights.pt")
    torch.save(state_dict, state_path)
    torch.cuda.empty_cache()
    stats = {"card": card, "crystals_per_replica": N_GRAPHS,
             "steps": N_PARALLEL_STEPS}
    n_layers = cfg.n_graph
    want_dp = scaled((PER_FORWARD, 1), (PER_BACKWARD, 1))
    want_edge = scaled((edge_launches(n_layers), 1))
    launches = {}
    for label, n, shards, want in (("dp2_gloo", 2, 1, want_dp),
                                   ("edge2_gloo", 2, 2, want_edge)):
        progress(f"phase 8: {label}")
        t0 = time.perf_counter()
        ranks = run_world(tmp, n, shards, "gloo", state_path, mean, std)
        wall = time.perf_counter() - t0
        ref = one_process_losses(cfg, state_dict, mean, std, n // shards,
                                 shards)
        for r, rec in enumerate(ranks):
            if rec["backend"] != "gloo" or rec["replayed"]:
                fail(f"{label} rank {r}: {rec['backend']}, replayed "
                     f"{rec['replayed']}")
            if rec["losses"] != ranks[0]["losses"]:
                fail(f"{label}: ranks disagree on the losses")
            for i, got in enumerate(rec["launches"]):
                if got != want:
                    fail(f"{label} rank {r} step {i}: launches {got} != "
                         f"{want}")
        diff = rel_diff(ranks[0]["losses"], ref)
        if not diff <= MODEL_RTOL:
            fail(f"{label}: losses {ranks[0]['losses']} vs one process "
                 f"{ref} (largest relative difference {diff:.3e})")
        if shards > 1:
            twice = [rec["dropout_twice"] for rec in ranks]
            if not all(d["same_bits"] for d in twice):
                fail(f"{label}: a dropout={DROPOUT} step taken twice from "
                     f"the same state differs: {twice}")
            stats["edge2_dropout_twice"] = twice
            print(f"[parallel] {label}: a dropout={DROPOUT} step twice from "
                  f"the same state, each rank: the same bits in the loss "
                  f"and the summed gradient (loss {twice[0]['loss']:.6f}, "
                  f"|grad| {twice[0]['grad_norm']:.6f}); a rank's launches "
                  f"{ {k: v for k, v in twice[0]['launches'].items() if v} }")
        stats[label] = {"losses": ranks[0]["losses"], "one_process": ref,
                        "max_rel_diff": diff,
                        "step_ms": [rec["step_ms"] for rec in ranks],
                        "world_s": wall, "devices": [rec["device"]
                                                     for rec in ranks],
                        "collectives_per_step": ranks[0]["collectives"],
                        "launches_per_rank_step": want}
        if shards > 1:
            # the layers' #1 and #2 launches are the pair path's (the pool
            # takes #8): what rank 0 counted in its last step
            stats[label]["pair_launches_per_rank_step"] = {
                k: ranks[0]["launches"][-1][k]
                for k in ("segment_attention", "segment_attention_bwd")}
        launches[label] = want
        print(f"[parallel] {label}: losses {ranks[0]['losses']} vs one "
              f"process {ref}: largest relative difference {diff:.3e} (tol "
              f"{MODEL_RTOL}); step ms by rank "
              f"{[[round(x, 2) for x in rec['step_ms']] for rec in ranks]}"
              f" (eager, gloo staged through the host); launches a rank "
              f"and step {want}; world {wall:.1f} s")
    stats["exchange"] = exchange_stats()
    print(f"[parallel] edge2 exchange: {stats['exchange']}")

    # (a) a world of one rank under NCCL against the one-card trainer, on
    # same-shape batches, so that the steps after the first replay
    progress("phase 8: one-rank NCCL world")
    n_slots = 1024
    batches = [collate(graphs[i * N_GRAPHS:(i + 1) * N_GRAPHS],
                       num_graphs=N_GRAPHS, num_node_slots=n_slots,
                       num_edge_slots=n_slots * 24, num_comp_slots=12,
                       max_nbr=24, orig_fea=200)
               for i in range(2)]
    order = [batches[i % 2] for i in range(N_PARALLEL_REPLAYS + 1)]
    tcfg = TrainerConfig(batch_size=N_GRAPHS, moment_dtype="bfloat16")

    def run(trainer):
        losses, ms = [], []
        for b in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(b)["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    one = Trainer(tcfg, cfg, mean=mean, std=std, device="cuda")
    one.init_state(state_dict)
    one_losses, one_ms = run(one)
    del one
    torch.cuda.empty_cache()
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    init_distributed("cuda")
    try:
        rank = Trainer(TrainerConfig(n_devices=1, batch_size=N_GRAPHS,
                                     moment_dtype="bfloat16"),
                       cfg, mean=mean, std=std, device="cuda")
        rank.init_state(state_dict)
        if rank.mesh is None or rank.mesh.backend != "nccl":
            fail("the one-rank world is not an NCCL mesh")
        before = dict(collectives.calls)
        rank_losses, rank_ms = run(rank)
        issued = {k: v - before[k] for k, v in collectives.calls.items()}
        keys = len(rank.step_graphs.graphs)
        # the host issues a step's collectives in its eager first step and
        # in its capture, never in a replay
        if issued["all_reduce"] == 0 or issued["all_reduce"] % (2 * keys):
            fail(f"the one-rank NCCL world issued {issued} collectives in "
                 f"{len(order)} steps of {keys} graph keys")
        b = order[-1].to("cuda")
        per_name = device_ms(lambda: rank.train_step(b), 2)
        nccl = {k[:60]: v for k, v in per_name.items()
                if "nccl" in k.lower()}
        del rank
    finally:
        dist.destroy_process_group()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)
    diff = rel_diff(rank_losses, one_losses)
    if not diff <= MODEL_RTOL:
        fail(f"one-rank NCCL losses {rank_losses} vs one card "
             f"{one_losses} (largest relative difference {diff:.3e})")
    replayed = len(order) - keys
    stats["nccl_one_rank"] = {
        "losses": rank_losses, "one_card": one_losses, "max_rel_diff": diff,
        "graph_keys": keys, "replayed_steps": replayed,
        "collectives_issued": issued,
        "replayed_step_ms": rank_ms[keys:], "one_card_step_ms": one_ms[keys:],
        "replayed_step_ms_median": float(np.median(rank_ms[keys:])),
        "one_card_step_ms_median": float(np.median(one_ms[keys:])),
        "nccl_device_events": nccl}
    print(f"[parallel] one-rank NCCL world: {replayed} of {len(order)} steps "
          f"replayed ({keys} keys), losses {rank_losses} vs one card "
          f"{one_losses}: largest relative difference {diff:.3e}; replayed "
          f"step median {stats['nccl_one_rank']['replayed_step_ms_median']:.2f}"
          f" ms vs one card {stats['nccl_one_rank']['one_card_step_ms_median']:.2f}"
          f" ms; collectives issued from the host {issued} (each key's "
          f"eager step and capture, none in a replay); NCCL device events "
          f"in a replay: {nccl or 'none (a one-rank in-place all-reduce '
                                  'launches nothing)'}")

    if torch.cuda.device_count() >= 2:
        progress("phase 8: dp2 over NCCL")
        ranks = run_world(tmp, 2, 1, "nccl", state_path, mean, std)
        ref = one_process_losses(cfg, state_dict, mean, std, 2, 1)
        diff = rel_diff(ranks[0]["losses"], ref)
        if not diff <= MODEL_RTOL or not all(r["replayed"] for r in ranks):
            fail(f"dp2 over NCCL: losses {ranks[0]['losses']} vs {ref}")
        stats["dp2_nccl"] = {"losses": ranks[0]["losses"], "one_process": ref,
                             "max_rel_diff": diff,
                             "step_ms": [r["step_ms"] for r in ranks]}
        print(f"[parallel] dp2 over NCCL: {stats['dp2_nccl']}")
    else:
        stats["dp2_nccl"] = "skipped: one card"
        print("[parallel] (d) dp = 2 over NCCL on two cards: skipped, "
              f"{torch.cuda.device_count()} card")
    return stats, launches


def gp_head(tmp, model, cfg, state_dict, data, card: str
            ) -> tuple[dict, dict]:
    """Phase 11: the GP head on the frozen reference-default backbone (phase
    4's config and weights, bf16 compute) over a pool of ``N_GP_GRAPHS``
    crystals, at the reference GP's settings (``GP_INDUCING`` inducing
    points, ``GP_BATCH`` crystals a step).

    (a) #1, #3 and #5 against their plain versions at a GP batch's shapes
        (phase 2's checks on the bf16 ``model``), the same bits twice.
    (b) ``fit_gp_streaming`` for ``GP_EPOCHS`` epochs of 4 steps: exact
        launches (the inducing batch's forward, then each step's, eager
        or replayed: 10/6/20 each, no backward kernel); then
        ``GP_CHECKED`` batches twice through a ``GPFit``
        whose steps replay and one whose steps are eager on the card: the
        same losses and parameters bit for bit; a replayed step's device
        events by kernel name (10/6/20 forward, no backward kernel); step
        ms replayed and eager, busy ms, idle share, capture s, peak
        memory, and what stays allocated once the fits are dropped.
    (c) On a ``GP_CHECK_POOL``-crystal pool, one batch an epoch: the
        on-the-fly history equals ``Trainer.embeddings`` + ``fit_gp``'s
        within GP_RTOL / GP_ATOL (``tests/test_gp.py``'s check).
    (d) ``cli.train_gp`` on phase 5's run, precomputed and ``--on-the-fly``:
        exit 0, a finite val MAE, exact launches, wall s.
    Returns the phase's numbers and the wrapper launches of (b)'s fit."""
    from cgat_tpu_torch.cli import train_gp as cli_train_gp
    from cgat_tpu_torch.data.dataset import (GraphLoader, load_dataset_dir,
                                             split_dataset)
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.training import Trainer, TrainerConfig, load_trainer
    from cgat_tpu_torch.training.dispatch import signature
    from cgat_tpu_torch.uncertainty import gp

    def signatures(graphs, batch_size, epochs, **kw) -> tuple[int, int]:
        """Batch shapes and steps of ``fit_gp_streaming``'s loader."""
        loader = GraphLoader(graphs, min(batch_size, len(graphs)),
                             shuffle=True, seed=0, **kw)
        keys, steps = set(), 0
        for e in range(epochs):
            loader.set_epoch(e)
            for b in loader:
                keys.add(signature(b))
                steps += 1
        return len(keys), steps

    def forwards(k: int) -> dict[str, int]:
        return scaled((PER_FORWARD, k))

    stats: dict = {"pool": N_GP_GRAPHS, "batch": GP_BATCH,
                   "inducing": GP_INDUCING}
    pool = random_graphs(500, N_GP_GRAPHS, n_atoms_range=(8, 16),
                         max_nbr=24, full_degree=True)
    loader = GraphLoader(pool, GP_BATCH, shuffle=True, seed=0, max_nbr=24,
                         node_bucket=64)

    # (a) the forward kernels at a GP batch's shapes
    progress("phase 11: kernels at a GP batch")
    first = next(iter(loader)).to("cuda")
    stats["batch_shapes"] = {"node_slots": int(first.num_node_slots),
                             "edge_slots": int(first.num_edge_slots)}
    stats["kernels"] = {r["name"]: {k: r[k] for k in (
        "shape", "max_abs_err", "rel_norm_err", "ms", "device_ms",
        "plain_ms", "bound_ms", "bound_by", "deterministic")}
        for r in check_kernels(model, first)}
    del first

    # (b) the on-the-fly fit, and its step replayed against eager
    progress("phase 11: on-the-fly fit")
    trainer = Trainer(TrainerConfig(batch_size=GP_BATCH), cfg, mean=0.0,
                      std=1.0, device="cuda")
    backbone = trainer.init_state(state_dict).eval()
    y = np.asarray([g.target for g in pool], np.float32)
    mean, std = float(y.mean()), float(y.std(ddof=1))
    keys, steps = signatures(pool, GP_BATCH, GP_EPOCHS, max_nbr=24,
                             node_bucket=64)
    # cuBLAS keeps a workspace for each stream it ran on, for the process:
    # cleared here and after the fits, so that the second reading counts
    # the fits' memory alone
    torch._C._cuda_clearCublasWorkspaces()
    allocated = settled_allocated()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    params, history = gp.fit_gp_streaming(
        backbone, pool, mean=mean, std=std, num_inducing=GP_INDUCING,
        epochs=GP_EPOCHS, batch_size=GP_BATCH, seed=0, max_nbr=24,
        node_bucket=64, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = launch_counts()
    if fit_launches != forwards(1 + steps):
        fail(f"fit_gp_streaming ({keys} batch shapes in {steps} steps) "
             f"launched {fit_launches}, not {forwards(1 + steps)}")
    if not (np.isfinite(history).all()
            and all(torch.isfinite(t).all() for _, t in params.named())):
        fail(f"fit_gp_streaming: non-finite history {history} or params")
    stats["fit"] = {"history": history, "steps": steps, "graph_keys": keys,
                    "s": fit_s, "launches": fit_launches}
    print(f"[gp] fit_gp_streaming: {steps} steps of {GP_BATCH} crystals "
          f"({keys} batch shapes, each eager then captured) in {fit_s:.2f} "
          f"s, -ELBO by epoch {[round(v, 5) for v in history]}, launches "
          f"{ {k: v for k, v in fit_launches.items() if v} } (the inducing "
          f"batch's forward, then 1 a step)")
    del params

    progress("phase 11: replayed against eager GP steps")
    inducing = gp.inducing_embeddings(backbone, pool[:GP_INDUCING],
                                      max_nbr=24, node_bucket=64)
    fits = {}
    for name in ("graph", "eager"):
        fits[name] = gp.GPFit(gp.init_gp(inducing.cpu().numpy(),
                                         device="cuda"), gp.GPConfig(), 1e-2,
                              gp.streaming_elbo(backbone, mean, std,
                                                len(pool)),
                              torch.device("cuda"))
    fits["eager"].graphs = None
    loader.set_epoch(0)
    batches = [b.to("cuda") for b, _ in zip(loader, range(GP_CHECKED))]
    losses = {name: [float(f.step(b)) for b in batches + batches]
              for name, f in fits.items()}
    if losses["graph"] != losses["eager"]:
        fail(f"replayed GP steps' losses {losses['graph']} differ from the "
             f"eager steps' {losses['eager']}")
    for (name, a), (_, b) in zip(fits["graph"].params.named(),
                                 fits["eager"].params.named()):
        if not torch.equal(a, b):
            fail(f"GP parameter {name}: replayed and eager steps differ")
    batch = batches[0]
    want = forwards(1)
    counters.reset()
    eager_prof = device_ms(lambda: fits["eager"].step(batch), 3)
    calls = {k: v / 3 for k, v in launch_counts().items()}
    if calls != want:
        fail(f"an eager GP step launched {calls}, not {want}")
    per_call = events_a_call(eager_prof, calls)
    counters.reset()
    replay_prof = device_ms(lambda: fits["graph"].step(batch), 3)
    counted = {k: v / 3 for k, v in launch_counts().items()}
    if counted != want:
        fail(f"a replayed GP step counted {counted} launches, not {want}")
    replayed = replayed_launches(replay_prof, per_call)
    if replayed != want:
        fail(f"a replayed GP step launched {replayed}, not {want}")
    stats["step"] = {"losses": losses["graph"],
                     "replay_launches": {k: int(v)
                                         for k, v in replayed.items()},
                     "capture_s": list(fits["graph"].graphs.capture_s
                                       .values())}
    for name, prof in (("eager", eager_prof), ("graph", replay_prof)):
        walls = timed_ms(lambda: fits[name].step(batch), 10)
        busy = sum(v[0] for v in prof.values())
        med = float(np.median(walls))
        stats["step"][name] = {
            "step_ms_median": med, "step_ms_min": float(np.min(walls)),
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / med,
            "device_events": sum(v[1] for v in prof.values()),
            "top_device_ms": [[k[:70], v[0], v[1]] for k, v in sorted(
                prof.items(), key=lambda kv: -kv[1][0])[:6]]}
    stats["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del fits, batches, batch, inducing
    stats["left_after_drop_bytes"] = settled_allocated() - allocated
    torch._C._cuda_clearCublasWorkspaces()
    stats["left_without_cublas_workspaces_bytes"] = (settled_allocated()
                                                     - allocated)
    launched = {k: v for k, v in stats["step"]["replay_launches"].items()
                if v}
    print(f"[gp] {2 * GP_CHECKED} GP steps replayed equal eager steps on the "
          f"card bit for bit; a replayed step launches {launched} and no "
          f"backward kernel (the backbone is frozen); capture s "
          f"{[round(v, 3) for v in stats['step']['capture_s']]}")
    for name in ("eager", "graph"):
        r = stats["step"][name]
        print(f"[gp] {name} step of {GP_BATCH} crystals: median "
              f"{r['step_ms_median']:.2f} ms, min {r['step_ms_min']:.2f} ms; "
              f"device busy {r['device_busy_ms']:.2f} ms in "
              f"{r['device_events']:.0f} device events, idle share "
              f"{r['device_idle_share']:.3f} ({card})")
        for k, ms, count in r["top_device_ms"]:
            print(f"[gp]   {ms:8.4f} ms  {count:5.0f} x  {k}")
    print(f"[gp] peak device memory {stats['peak_memory_gib']:.2f} GiB; "
          f"{stats['left_after_drop_bytes']} bytes stay allocated once the "
          f"fits are dropped, "
          f"{stats['left_without_cublas_workspaces_bytes']} once cuBLAS's "
          f"workspaces are cleared ({card})")

    # (c) on the fly against precomputed embeddings, one batch an epoch
    progress("phase 11: on-the-fly against precomputed")
    small = pool[:GP_CHECK_POOL]
    ys = y[:GP_CHECK_POOL]
    m_c, s_c = float(ys.mean()), float(ys.std(ddof=1))
    emb = trainer.embeddings(small)
    kw = dict(num_inducing=GP_INDUCING, epochs=GP_CHECK_EPOCHS,
              batch_size=GP_BATCH, seed=0, verbose=False)
    _, h_pre = gp.fit_gp(emb, (ys - m_c) / s_c, device="cuda", **kw)
    _, h_fly = gp.fit_gp_streaming(backbone, small, mean=m_c, std=s_c,
                                   max_nbr=24, node_bucket=64, **kw)
    if not np.allclose(h_fly, h_pre, rtol=GP_RTOL, atol=GP_ATOL):
        fail(f"on-the-fly history {h_fly} vs precomputed {h_pre} (rtol "
             f"{GP_RTOL}, atol {GP_ATOL})")
    diff = float(np.max(np.abs(np.subtract(h_fly, h_pre))))
    stats["fly_vs_precomputed"] = {"on_the_fly": h_fly, "precomputed": h_pre,
                                   "max_abs_diff": diff}
    print(f"[gp] on a {GP_CHECK_POOL}-crystal pool, one batch an epoch: the "
          f"on-the-fly history {[round(v, 6) for v in h_fly]} equals the "
          f"precomputed one within {diff:.3e} (rtol {GP_RTOL}, atol "
          f"{GP_ATOL})")
    del trainer, backbone, emb

    # (d) cli.train_gp on phase 5's run, both modes
    run = os.path.join(tmp, "logs", "runs", "cli")
    with contextlib.redirect_stdout(io.StringIO()):
        probe, _ = load_trainer(run, device="cuda")
    tcfg = probe.cfg
    del probe
    graphs = load_dataset_dir(data["data_path"], fea_path=tcfg.fea_path,
                              max_neighbor_number=tcfg.max_nbr,
                              target=tcfg.target)
    tr, va, _ = split_dataset(len(graphs), seed=0)
    _, gp_steps = signatures([graphs[i] for i in tr], GP_BATCH,
                             GP_CLI_EPOCHS, max_nbr=tcfg.max_nbr,
                             node_bucket=tcfg.node_bucket,
                             num_comp_slots=tcfg.num_comp_slots)
    batches_of = lambda n: -(-n // tcfg.batch_size)
    stats["cli"] = {}
    for mode, flags, fwd in (
            ("precomputed", [], batches_of(len(graphs))),
            ("on_the_fly", ["--on-the-fly"],
             1 + gp_steps + batches_of(len(va)))):
        out = os.path.join(tmp, f"gp_{mode}.pickle.gz")
        t0 = time.perf_counter()
        counts, _ = cli_call(f"cli.train_gp {' '.join(flags)}".strip(),
                             cli_train_gp.main,
                             ["--cgat-model", run, "--epochs",
                              str(GP_CLI_EPOCHS), "--out", out, *flags],
                             forwards(fwd), phase=11)
        wall = time.perf_counter() - t0
        with gzip.open(out, "rb") as f:
            saved = pickle.load(f)
        if not (math.isfinite(saved["val_mae"])
                and np.isfinite(saved["history"]).all()
                and saved["params"].inducing.shape[1] == cfg.embedding_dim):
            fail(f"cli.train_gp {mode}: val MAE {saved['val_mae']}, history "
                 f"{saved['history']}, inducing "
                 f"{saved['params'].inducing.shape}")
        stats["cli"][mode] = {"s": wall, "val_mae": saved["val_mae"],
                              "history": saved["history"],
                              "launches": counts}
        print(f"[gp] cli.train_gp {mode}: {wall:.1f} s, val MAE "
              f"{saved['val_mae']:.5f}, last -ELBO "
              f"{saved['history'][-1]:.5f} ({card})")
    return stats, fit_launches


def al_pool(root: str) -> tuple[str, float]:
    """Phase 12's pool: AL_POOL prototype crystals (ids "i,1") through the
    port's featuriser, in AL_SHARDS shards; returns the directory and the
    featurisation seconds."""
    from cgat_tpu_torch.data.featurizer import build_dataset_prepare
    from cgat_tpu_torch.data.structures import random_structures
    from cgat_tpu_torch.tools import shards

    structures = random_structures(1200, AL_POOL)
    for i, e in enumerate(structures):
        e["data"]["id"] = f"{i},1"
    t0 = time.perf_counter()
    prepared = build_dataset_prepare(structures, progress=False)
    prepare_s = time.perf_counter() - t0
    if len(prepared["batch_ids"]) != AL_POOL:
        fail(f"phase 12: {len(prepared['batch_ids'])} of {AL_POOL} "
             f"structures prepared")
    pool = os.path.join(root, "pool")
    size = AL_POOL // AL_SHARDS
    for s in range(AL_SHARDS):
        shards.save_pickle(shards.select_entries(
            prepared, range(s * size, (s + 1) * size)),
            shards.shard_path(s, pool))
    return pool, prepare_s


def pool_and_sample_ids(pool: str, sample_path: str) -> tuple[list, list]:
    from cgat_tpu_torch.tools import shards
    left = [b for _, p in shards.iter_shards(pool)
            for b in shards.entry_ids(shards.load_pickle(p))]
    return left, shards.entry_ids(shards.load_pickle(sample_path))


def al_cpu_check(run: str, shard0: str, csv_path: str, card: str) -> dict:
    """Round 1's pool errors on the card (its CSV for shard 0) against the
    same run's f32 forward on the CPU over that shard (the plain
    versions), computed as ``calculate_errors`` does; within MODEL_RTOL
    and MODEL_RTOL x max|per-atom prediction|, as check_against_cpu."""
    from cgat_tpu_torch.data.dataset import load_prepared
    from cgat_tpu_torch.models import CGAtNet
    from cgat_tpu_torch.tools import shards
    from cgat_tpu_torch.training import load_trainer

    with contextlib.redirect_stdout(io.StringIO()):
        trainer, _ = load_trainer(run, device="cpu")
    f32 = CGAtNet(dataclasses.replace(trainer.model_cfg,
                                      compute_dtype="float32"))
    f32.load_state_dict(trainer.model.state_dict(), strict=True)
    trainer.model = f32.eval()
    data = shards.load_pickle(shard0)
    graphs = load_prepared(data, max_neighbor_number=trainer.cfg.max_nbr,
                           target=trainer.cfg.target)
    t0 = time.perf_counter()
    pred = trainer.predict(graphs) / np.asarray([g.n_atoms for g in graphs])
    cpu_s = time.perf_counter() - t0
    want = np.abs(pred - np.asarray(data["target"][trainer.cfg.target],
                                    np.float64).reshape(-1))
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if [r["batch_ids"] for r in rows] != shards.entry_ids(data):
        fail("phase 12: round 1's error CSV does not list shard 0's ids")
    got = np.asarray([float(r["errors"]) for r in rows])
    scale = float(np.abs(pred).max())
    err = float(np.abs(got - want).max())
    if not (np.isfinite(got).all() and np.allclose(
            got, want, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale)):
        fail(f"phase 12: round 1's pool errors on the card vs the CPU f32 "
             f"forward: max abs diff {err:.3e} (max|prediction| "
             f"{scale:.3e})")
    print(f"[al] round 1's pool errors over shard 0 ({len(rows)} crystals) "
          f"on the card vs the same run's f32 forward on the CPU: max abs "
          f"diff {err:.3e}, max|per-atom prediction| {scale:.3e} (rtol "
          f"{MODEL_RTOL}, atol {MODEL_RTOL} x max); the CPU took "
          f"{cpu_s:.1f} s ({card})")
    return {"crystals": len(rows), "max_abs_diff": err,
            "max_abs_prediction": scale, "cpu_s": cpu_s}


def active_learning(tmp: str, card: str) -> tuple[dict, dict]:
    """Phase 12: three active-learning rounds of the reference-default
    model (bf16, batch 64, AL_EPOCHS epochs a round) through
    ``cgat_tpu_torch.tools``, on a pool of AL_POOL prototype crystals in
    AL_SHARDS shards: a Metropolis initial sample of AL_INITIAL; round 1
    ranks the pool by error, round 2 by an SVGP's predictive std on the
    sample's frozen embeddings (AL_GP), round 3 by error from round 2's
    weights (``pretrained_run``); each absorbs AL_NEW. Then
    ``tools.embeddings`` over the final sample and ``tools.tsne``'s CLI on
    the card. Checks: the sample and pool sizes after every step, no id in
    both; round 1's pool errors against the CPU's f32 forward; every
    kernel launched in the phase, each backward kernel in every round's
    training; the card's allocated memory after rounds 2 and 3 (trainers
    and GP fit dropped) within AL_MEMORY_TOL of round 1's. Returns the
    phase's numbers and each kernel's launches in it."""
    from cgat_tpu_torch.models import CGATConfig
    from cgat_tpu_torch.tools import embeddings, errors, loop, shards
    from cgat_tpu_torch.tools import tsne
    from cgat_tpu_torch.training import TrainerConfig
    from cgat_tpu_torch.uncertainty import gp

    root = os.path.join(tmp, "al")
    pool, prepare_s = al_pool(root)
    al = os.path.join(root, "al_pool")
    sample_path = os.path.join(root, "sample.pickle.gz")
    stats: dict = {"pool": AL_POOL, "shards": AL_SHARDS,
                   "prepare_s": prepare_s,
                   "prepare_ms_per_structure": prepare_s / AL_POOL * 1e3,
                   "rounds": []}
    total = scaled()

    def counted(fn):
        """Run ``fn`` with the counts set to 0 just before and read just
        after (added to the phase's); returns its result, seconds and
        launches."""
        counters.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = fn()
        torch.cuda.synchronize()
        got = launch_counts()
        for k, v in got.items():
            total[k] += v
        return out, time.perf_counter() - t0, got

    def sizes(want_sample: int, step: str) -> None:
        left, taken = pool_and_sample_ids(al, sample_path)
        if (len(taken), len(left)) != (want_sample, AL_POOL - want_sample) \
                or set(left) & set(taken) or len(set(taken)) != len(taken):
            fail(f"phase 12 {step}: sample {len(taken)} (want "
                 f"{want_sample}), pool {len(left)} (want "
                 f"{AL_POOL - want_sample}), "
                 f"{len(set(left) & set(taken))} ids in both")

    progress("phase 12: initial sample")
    t0 = time.perf_counter()
    first = loop.initial_sample(pool, al, AL_INITIAL, method="metropolis",
                                seed=1)
    shards.save_pickle(first, sample_path)
    stats["initial_sample_s"] = time.perf_counter() - t0
    sizes(AL_INITIAL, "initial sample")

    # each stage of a round, timed and counted from inside the round
    stage: dict = {}
    originals = {name: getattr(loop, name) for name in (
        "calculate_errors", "_score_pool_by_gp_std", "get_highest_errors")}
    fit_gp = gp.fit_gp

    def staged(name, fn):
        def run(*args, **kwargs):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "absorb" and stage.get("snapshot"):
                # round 1's shard 0 as it was scored, for the CPU check
                shutil.copyfile(shards.shard_path(0, al), stage["snapshot"])
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage[f"{name}_s"] = time.perf_counter() - t0
            stage[f"{name}_launches"] = {
                k: v - before[k] for k, v in launch_counts().items()}
            return out
        return run

    loop.calculate_errors = staged("score", originals["calculate_errors"])
    loop._score_pool_by_gp_std = staged("score",
                                        originals["_score_pool_by_gp_std"])
    loop.get_highest_errors = staged("absorb",
                                     originals["get_highest_errors"])
    gp.fit_gp = staged("gp_fit", fit_gp)
    cfg = CGATConfig(compute_dtype="bfloat16")
    memory = []
    run_dirs = []
    try:
        for r, (acq, pretrained) in enumerate(
                (("error", False), ("gp_std", False), ("error", True)), 1):
            progress(f"phase 12: round {r} ({acq}"
                     f"{', from round 2' if pretrained else ''})")
            stage.clear()
            if r == 1:
                stage["snapshot"] = os.path.join(root, "round1_shard0.pkl")
            tcfg = TrainerConfig(batch_size=N_GRAPHS, epochs=AL_EPOCHS,
                                 target="e_above_hull",
                                 ckpt_dir=os.path.join(root, "logs"),
                                 run_name=f"round{r}")
            (run, new), secs, got = counted(
                lambda: loop.active_learning_round(
                    al, sample_path, trainer_cfg=tcfg, model_cfg=cfg,
                    n_new=AL_NEW, acquisition=acq,
                    pretrained_run=run_dirs[-1] if pretrained else None,
                    gp_kwargs=AL_GP, device="cuda"))
            run_dirs.append(run)
            if new is None or len(new["batch_ids"]) != AL_NEW:
                fail(f"phase 12 round {r}: absorbed "
                     f"{None if new is None else len(new['batch_ids'])}")
            sizes(AL_INITIAL + r * AL_NEW, f"round {r}")
            train = {k: v - stage["score_launches"][k]
                     - stage["absorb_launches"][k] for k, v in got.items()}
            missing = [k for k in PER_BACKWARD if not train[k]]
            if missing:
                fail(f"phase 12 round {r}: no {missing} launch in the "
                     f"round's training ({train})")
            rec = {"acquisition": acq, "pretrained": pretrained,
                   "s": secs, "train_s": secs - stage["score_s"]
                   - stage["absorb_s"], "score_s": stage["score_s"],
                   "absorb_s": stage["absorb_s"],
                   "gp_fit_s": stage.get("gp_fit_s"),
                   "sample": AL_INITIAL + r * AL_NEW,
                   "pool": AL_POOL - AL_INITIAL - r * AL_NEW,
                   "train_launches": train,
                   "score_launches": stage["score_launches"]}
            if r == 1:
                stats["cpu_check"] = al_cpu_check(
                    run, stage["snapshot"], errors.error_csv_path(0, al),
                    card)
            rec["allocated_bytes"] = settled_allocated()
            memory.append(rec["allocated_bytes"])
            if memory[-1] - memory[0] > AL_MEMORY_TOL:
                fail(f"phase 12 round {r}: {memory[-1]} bytes allocated "
                     f"with its trainers and GP fit dropped, "
                     f"{memory[-1] - memory[0]} above round 1's")
            stats["rounds"].append(rec)
            gp_part = ("" if rec["gp_fit_s"] is None else
                       f", of it the GP fit {rec['gp_fit_s']:.2f}")
            print(f"[al] round {r} ({acq}"
                  f"{', from round 2' if pretrained else ''}): {secs:.1f} s "
                  f"(train {rec['train_s']:.1f}, score "
                  f"{rec['score_s']:.1f}{gp_part}, absorb "
                  f"{rec['absorb_s']:.2f}); sample "
                  f"{rec['sample']}, pool {rec['pool']}; "
                  f"{rec['allocated_bytes']} bytes allocated after it "
                  f"({card})")
    finally:
        for name, fn in originals.items():
            setattr(loop, name, fn)
        gp.fit_gp = fit_gp

    progress("phase 12: embeddings and t-SNE")
    emb_dir = os.path.join(root, "embeddings")
    _, emb_s, _ = counted(lambda: embeddings.calculate_embeddings(
        run_dirs[-1], sample_path, emb_dir, device="cuda"))
    out_csv = os.path.join(root, "tsne.csv")
    n_final = AL_INITIAL + 3 * AL_NEW
    rc, tsne_s, got = counted(lambda: tsne.main(
        [os.path.join(emb_dir, os.path.basename(sample_path)), "--target",
         "e_above_hull", "--out", out_csv, "--device", "cuda"]))
    with open(out_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    coords = np.asarray([[float(r["x"]), float(r["y"])] for r in rows])
    if rc != 0 or len(rows) != n_final or not np.isfinite(coords).all() \
            or any(got.values()):
        fail(f"phase 12: tools.tsne exited {rc}, {len(rows)} rows (want "
             f"{n_final}), finite {np.isfinite(coords).all()}, launches "
             f"{got}")
    stats.update(embeddings_s=emb_s, tsne_s=tsne_s, tsne_points=n_final,
                 memory_after_round_bytes=memory,
                 memory_above_round1_bytes=[m - memory[0] for m in memory],
                 launches=dict(total))
    missing = [k for k, v in total.items() if not v and k in
               {**PER_FORWARD, **PER_BACKWARD}]
    if missing:
        fail(f"phase 12: {missing} never launched in the phase")
    print(f"[al] tools.embeddings over the {n_final}-crystal sample "
          f"{emb_s:.1f} s; tools.tsne on the card {tsne_s:.1f} s ({n_final} "
          f"points); memory after each round above round 1's "
          f"{stats['memory_above_round1_bytes']} bytes (tol "
          f"{AL_MEMORY_TOL}); launches in the phase "
          f"{ {k: v for k, v in total.items() if v} } ({card})")
    return stats, dict(total)


def tools(tmp, data, rows, disp, card) -> tuple[dict, dict]:
    """Phase 13: the tools of slices 8c and 9 on phase 5's data and run, at
    full width.

    (a) ``tools.ensemble train`` of two seeds with phase 5's flags: each
        member's exact launches (its steps and evaluation batches) and
        the card's allocated bytes after each (member 2
        within 4 MiB of member 1); ``predict`` and ``summarize`` (finite
        columns, a nonzero spread); ``soup``, whose weights must be the
        f64 mean of the members' cast to f32 bit for bit, and
        ``cli.predict`` on it.
    (b) Phase 5's run exported to a reference ``.ckpt`` and imported
        back: the same state dict bit for bit, the normalisation rounded
        to f32 (the reference's Parameters), and the same predictions on
        the card bit for bit (the imported run's model in phase 5's
        compute dtype: an import computes in f32, as in cgat_tpu).
    (c) ``cli.train --smoke-test --profile-epoch 0`` and a second run with
        ``--profile-epoch 1``, every batch one shape (``TRACE_BUCKET``
        node slots): a capturing epoch and a replay-only one. Each writes
        one trace under ``<run>/profile`` that must hold each kernel's
        device events in the counts its epoch's steps imply (phase 7's
        events a call) and one ``train_step`` span a step.
    (d) ``utils.roofline``'s ``measure_*`` at the main path's shapes: each
        bound equal to the bound phases 2 and 4 printed, each share of a
        roofline at most ``SHARE_LIMIT``.
    (e) ``tools.step_trace --iters 10 --k 1``: its categories add up to
        its total, within ``STEP_TRACE_TOL`` of phase 7's busy ms a
        replayed step.
    Returns the phase's numbers and every kernel's launches in its CLI
    calls (a), (b) and (c)."""
    from cgat_tpu_torch.cli import predict as cli_predict
    from cgat_tpu_torch.cli import train as cli_train
    from cgat_tpu_torch.data.dataset import load_prepared
    from cgat_tpu_torch.tools import ensemble, import_torch, step_trace
    from cgat_tpu_torch.training import (CheckpointManager, Trainer,
                                         load_trainer)
    from cgat_tpu_torch.utils.profiling import trace_files, trace_kernels

    zero = scaled()
    total = dict(zero)
    stats: dict = {}
    phase_t0 = time.perf_counter()

    def want(fwd: int, bwd: int) -> dict[str, int]:
        return scaled((PER_FORWARD, fwd), (PER_BACKWARD, bwd))

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    logs = os.path.join(tmp, "logs")
    base = ["--data-path", data["data_path"], "--target", "e_above_hull",
            "--smoke-test"]
    evals = data["val_batches"]
    batches = -(-data["prepared"] // N_GRAPHS)

    # (a) the ensemble: each member's launches and the memory after it
    progress("phase 13: tools.ensemble train")
    t0 = time.perf_counter()
    members = []
    real_main = cli_train.main

    def member_main(argv):
        seed = argv[argv.index("--seed") + 1]
        steps, keys = cli_steps(base + ["--seed", seed], range(2))
        counters.reset()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = real_main(argv)
        torch.cuda.synchronize()
        got = launch_counts()
        if got != want(steps + evals, steps):
            fail(f"ensemble member {seed}: launches {got} != "
                 f"{want(steps + evals, steps)}")
        add(got)
        members.append({"seed": int(seed), "graph_keys": keys,
                        "allocated": settled_allocated()})
        return rc

    cli_train.main = member_main
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            ensemble.main(["train", "--seeds", *map(str, ENSEMBLE_SEEDS),
                           "--ckpt-dir", logs, "--", *base])
    finally:
        cli_train.main = real_main
    grew = members[1]["allocated"] - members[0]["allocated"]
    if len(members) != len(ENSEMBLE_SEEDS) or abs(grew) > \
            ENSEMBLE_MEMORY_TOL:
        fail(f"ensemble members {members}: allocated after member 2 "
             f"{grew} bytes above member 1 (at most "
             f"{ENSEMBLE_MEMORY_TOL})")
    stats["ensemble"] = {"members": members,
                         "train_s": time.perf_counter() - t0}
    out = os.path.join(tmp, "ensemble")
    counts, _ = cli_call("tools.ensemble predict", ensemble.main,
                         ["predict", "--ckpt-dir", logs, "--out-dir", out,
                          "--data", data["data_path"]],
                         want(len(ENSEMBLE_SEEDS) * batches, 0), phase=13)
    add(counts)
    _, printed = cli_call("tools.ensemble summarize", ensemble.main,
                          ["summarize", "--out-dir", out], zero, phase=13)
    # one dataset, named after the prepared file
    summary, = [os.path.join(d, "ensemble.csv") for d in
                glob.glob(os.path.join(out, "*"))]
    with open(summary) as f:
        cols = np.asarray([[float(v) for v in r]
                           for r in list(csv.reader(f))[1:]])
    if cols.shape != (data["prepared"], 3) or not np.isfinite(cols).all() \
            or not (cols[:, 1] > 0).any():
        fail(f"ensemble.csv: shape {cols.shape}, finite "
             f"{np.isfinite(cols).all()}, spread max {cols[:, 1].max()}")
    stats["ensemble"]["summary"] = {"mae_of_mean": printed.strip(),
                                    "spread_mean": float(cols[:, 1].mean())}
    soup_run = os.path.join(logs, "runs", "soup")
    cli_call("tools.ensemble soup", ensemble.main,
             ["soup", "--ckpt-dir", logs, "--out-run", soup_run], zero,
             phase=13)
    soup_sd, soup_meta = CheckpointManager.load(soup_run, map_location="cpu")
    member_sds = [CheckpointManager.load(
        os.path.join(logs, "runs", ensemble.member_run_name("ens_", s)),
        map_location="cpu")[0] for s in ENSEMBLE_SEEDS]
    for k, v in soup_sd.items():
        mean64 = sum(m[k].double() for m in member_sds) / len(member_sds)
        if not torch.equal(v, mean64.float()):
            fail(f"soup: {k} is not the f64 mean of the members' cast to "
                 f"f32")
    path = os.path.join(tmp, "soup_predict.pickle.gz")
    counts, _ = cli_call("cli.predict (soup)", cli_predict.main,
                         [soup_run, data["data_path"], "--out", path],
                         want(batches, 0), phase=13)
    add(counts)
    with gzip.open(path, "rb") as f:
        pred = pickle.load(f)["pred"]
    if pred.shape != (data["prepared"],) or not np.isfinite(pred).all():
        fail("cli.predict on the soup: predictions not finite")
    stats["ensemble"]["soup_members"] = soup_meta["soup_members"]
    print(f"[tools] ensemble of seeds {list(ENSEMBLE_SEEDS)}: "
          f"{[m['graph_keys'] for m in members]} step graphs, exact "
          f"launches, allocated after member 2 {grew:+d} bytes from member "
          f"1; ensemble.csv finite, mean spread "
          f"{stats['ensemble']['summary']['spread_mean']:.4f}; the soup is "
          f"the members' f64 mean to the bit, its predictions finite")

    # (b) export phase 5's run, import it back
    progress("phase 13: import_torch --export, import")
    run = os.path.join(logs, "runs", "cli")
    ckpt = os.path.join(tmp, "cli.ckpt")
    imported = os.path.join(logs, "runs", "imported")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        import_torch.main([run, "--export", "--out", ckpt])
        import_torch.main([ckpt, "--out", imported])
    round_trip_s = time.perf_counter() - t0
    sd0, meta0 = CheckpointManager.load(run, map_location="cpu")
    sd1, meta1 = CheckpointManager.load(imported, map_location="cpu")
    # the reference keeps mean and std as f32 Parameters
    norm = [float(np.float32(meta0[k])) for k in ("mean", "std")]
    if sorted(sd0) != sorted(sd1) or not all(
            torch.equal(v, sd1[k]) for k, v in sd0.items()) \
            or norm != [meta1["mean"], meta1["std"]]:
        fail(f"export then import changed the weights or the normalisation "
             f"({meta0['mean']}, {meta0['std']} -> {meta1['mean']}, "
             f"{meta1['std']})")
    graphs = load_prepared(data["data_path"], target="e_above_hull")
    counters.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        t_orig, _ = load_trainer(run, device="cuda")
        want_pred = t_orig.predict(graphs)
        t_imp, _ = load_trainer(imported, device="cuda")
        cfg = dataclasses.replace(
            t_imp.model_cfg, compute_dtype=t_orig.model_cfg.compute_dtype)
        if cfg != t_orig.model_cfg:
            fail(f"the imported model config {t_imp.model_cfg} differs from "
                 f"the run's {t_orig.model_cfg} beyond its compute dtype")
        served = Trainer(t_imp.cfg, cfg, mean=t_imp.mean, std=t_imp.std,
                         device="cuda")
        served.init_state(t_imp.model.state_dict())
        got_pred = served.predict(graphs)
    counts = launch_counts()
    if counts != want(2 * batches, 0):
        fail(f"the two runs' predictions launched {counts}, not "
             f"{want(2 * batches, 0)}")
    add(counts)
    if not np.array_equal(got_pred, want_pred):
        fail(f"the imported run's predictions differ from the run's: max "
             f"{np.abs(got_pred - want_pred).max():.3e}")
    del t_orig, t_imp, served
    stats["import_export"] = {"tensors": len(sd0), "round_trip_s":
                              round_trip_s, "compute_dtype_imported":
                              meta1["model_config"]["compute_dtype"]}
    print(f"[tools] phase 5's run exported to a reference .ckpt and imported "
          f"back in {round_trip_s:.1f} s: {len(sd0)} tensors equal bit for "
          f"bit, the normalisation rounded to f32 as the reference stores "
          f"it; {len(got_pred)} predictions on the card equal bit for bit")

    # (c) a capturing and a replay-only profiled epoch
    per_call = disp["device_events_a_call"]
    per_step = {k: (PER_FORWARD.get(k, 0) + PER_BACKWARD.get(k, 0))
                * per_call.get(k, 1) for k in REPLAY_KERNELS}
    stats["trace"] = {}
    for epoch in (0, 1):
        name = f"trace{epoch}"
        argv = base + ["--node-bucket", str(TRACE_BUCKET), "--ckpt-dir",
                       logs, "--run-name", name, "--profile-epoch",
                       str(epoch)]
        steps, keys = cli_steps(argv, range(2))
        if keys != 1:
            fail(f"{name}: {keys} batch shapes, not 1")
        t0 = time.perf_counter()
        counts, _ = cli_call(f"cli.train --profile-epoch {epoch}",
                             cli_train.main, argv,
                             want(steps + evals, steps), phase=13)
        train_s = time.perf_counter() - t0
        add(counts)
        files = trace_files(os.path.join(logs, "runs", name, "profile"))
        if len(files) != 1:
            fail(f"{name}: {len(files)} traces under its profile directory")
        per_name = trace_kernels(files[0])
        got = kernel_events(per_name)
        n = steps // 2
        expect = {k: float(v * n) for k, v in per_step.items()}
        spans = per_name.get("span:train_step", [0.0, 0])[1]
        if got != expect or spans != n:
            fail(f"{name}: device events {got} and {spans} train_step spans "
                 f"in the trace, not {expect} and {n}")
        stats["trace"][name] = {
            "epoch": epoch, "captures": epoch == 0, "steps": n,
            "kernel_events": got, "train_s": train_s,
            "trace_mb": os.path.getsize(files[0]) / 2 ** 20,
            "device_ms": sum(v[0] for k, v in per_name.items()
                             if not k.startswith("span:"))}
        print(f"[tools] cli.train --profile-epoch {epoch} "
              f"({'capturing' if epoch == 0 else 'replay-only'}): one trace "
              f"of {stats['trace'][name]['trace_mb']:.1f} MiB, {n} "
              f"train_step spans, device events {got}, "
              f"{stats['trace'][name]['device_ms']:.2f} ms of device time")

    # (d) the roofline at the main path's shapes
    progress("phase 13: roofline")
    printed = {r["name"]: r for r in rows}
    measured = {
        **roofline.measure_kernels(),
        **roofline.measure_mh_kernels(
            fwd_rows=printed["mh_network"]["shape"][0],
            bwd_rows=printed["mh_network_bwd"]["shape"][0]),
        **roofline.measure_hyper_kernels(
            fwd_rows=printed["hyper_apply"]["shape"][0],
            bwd_rows=printed["hyper_apply_bwd_dhdx"]["shape"][0])}
    for k, r in measured.items():
        if k in printed and r["bound_ms"] != printed[k]["bound_ms"]:
            fail(f"roofline: {k}'s bound {r['bound_ms']} != the "
                 f"{printed[k]['bound_ms']} of its phase")
        if r["share"] > SHARE_LIMIT:
            fail(f"roofline: {k} reads {r['share']:.3f} of its roofline")
        print(f"[tools] roofline {k} {r['shape']}: device {r['device_ms']:.4f}"
              f" ms ({r['events_a_call']:.2f} events a call seen), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bytes_share']:.3f} of {roofline.HBM_BYTES_PER_S:.3g} B/s,"
              f" {r['ops_share']:.3f} of {roofline.PEAKS[r['kernel']]:.3g} "
              f"op/s "
              f"({card})")
    stats["roofline"] = measured

    # (e) the step trace
    progress("phase 13: tools.step_trace")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        step_trace.main(["--iters", "10", "--k", "1"])
    text = out.getvalue()
    res = json.loads(text[text.index("{\n"):])
    busy = disp["graph"]["device_busy_ms"]
    cats = {k: v["ms"] for k, v in res["categories"].items()}
    total_ms = res["device_ms_per_step"]
    if not math.isclose(sum(cats.values()), total_ms, rel_tol=1e-9) \
            or abs(total_ms - busy) > STEP_TRACE_TOL * busy:
        fail(f"step_trace: categories {cats} sum to {sum(cats.values())}, "
             f"total {total_ms} ms against phase 7's busy {busy} ms")
    stats["step_trace"] = {k: res[k] for k in (
        "device_ms_per_step", "events_per_step", "categories")}
    stats["step_trace"]["top_events"] = res["top_events"][:12]
    print(f"[tools] step_trace: {total_ms:.3f} ms of device time a replayed "
          f"step in {res['events_per_step']:.0f} events (phase 7: "
          f"{busy:.3f} ms) ({card})")
    print(json.dumps({"step_trace_categories_ms": cats}))
    stats["phase_s"] = time.perf_counter() - phase_t0
    print(f"[tools] phase 13 took {stats['phase_s']:.1f} s")
    return stats, total


def check_against_cpu(model, cpu_model, graphs, sig_nodes) -> float:
    """The card's forward vs the port's own bf16 forward on the CPU (plain
    versions), same weights, same batch."""
    from cgat_tpu_torch.data import collate
    batch = collate(graphs, num_graphs=N_GRAPHS, num_node_slots=sig_nodes,
                    num_edge_slots=sig_nodes * 24, num_comp_slots=8,
                    max_nbr=24, orig_fea=200)
    with torch.inference_mode():
        got = model(batch.to("cuda")).cpu()
        t0 = time.perf_counter()
        want = cpu_model(batch)
    cpu_s = time.perf_counter() - t0
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not torch.allclose(
            got, want, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale):
        fail(f"card vs CPU forward: max abs diff {err:.3e} "
             f"(max|out| {scale:.3e})")
    print(f"[serve] card vs CPU bf16 forward: max abs diff {err:.3e}, "
          f"max|out| {scale:.3e} (rtol {MODEL_RTOL}, atol {MODEL_RTOL} x "
          f"max|out|); the CPU forward took {cpu_s:.1f} s")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    from cgat_tpu_torch.data import collate, pad_to_bucket
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.models import CGATConfig, CGAtNet, init_state_dict

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
          f"{card}")

    progress("phase 1: build the kernels")
    build_kernels()

    progress("phase 2: check the forward kernels")
    cfg = CGATConfig(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    cpu_model = CGAtNet(cfg)
    state_dict = init_state_dict(cpu_model, seed=0)      # f32 weights
    cpu_model.load_state_dict(state_dict, strict=True)
    cpu_model.to_compute_dtype().eval()
    model = CGAtNet(cfg)
    model.load_state_dict(cpu_model.state_dict(), strict=True)
    model = model.to_compute_dtype().to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] reference-default CGAtNet, bf16, {n_params} parameters, "
          f"built in {time.perf_counter() - t0:.1f} s")

    requests = [random_graphs(seed, N_GRAPHS, n_atoms_range=(8, 16),
                              max_nbr=24, full_degree=True)
                for seed in range(N_REQUESTS)]
    n0 = pad_to_bucket(sum(g.n_atoms for g in requests[0]), 64)
    batch0 = collate(requests[0], num_graphs=N_GRAPHS, num_node_slots=n0,
                     num_edge_slots=n0 * 24, num_comp_slots=8, max_nbr=24,
                     orig_fea=200).to(device)
    rows = check_kernels(model, batch0)
    rows[[r["name"] for r in rows].index("segment_attention")]["layouts"] = \
        check_attention_layouts()
    dropout_row = check_dropout(cfg, int(batch0.num_edge_slots))
    pair_row = check_pair_path(model, requests[0])
    progress("phase 3: serve")
    launches, stats = serve(model, requests, card)
    stats["breakdown"] = breakdown(model, requests[1], rows)
    check_against_cpu(model, cpu_model, requests[0], n0)
    progress("phase 4: train")
    train_rows, train_stats, train_launches = train(cfg, state_dict)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        progress(f"phase 5: cli in {tmp}")
        cli_stats, cli_launches = cli(tmp)
        progress("phase 6: variants")
        var_stats, var_launches = variants(tmp, cfg, state_dict, cli_stats)
        progress("phase 7: dispatch")
        disp_stats, _ = dispatch(tmp, cfg, state_dict, cli_stats, card)
        progress("phase 8: parallel")
        par_stats, par_launches = parallel(tmp, cfg, state_dict, card)
        progress("phase 9: export")
        exp_stats, exp_launches = export(tmp, requests, card)
        progress("phase 10: streaming")
        stream_stats, stream_launches = streaming(tmp, cli_stats, card)
        progress("phase 11: gp")
        gp_stats, gp_launches = gp_head(tmp, model, cfg, state_dict,
                                        cli_stats, card)
        progress("phase 12: active learning")
        al_stats, al_launches = active_learning(tmp, card)
        progress("phase 13: tools")
        tools_stats, tools_launches = tools(tmp, cli_stats,
                                            rows + train_rows + [dropout_row],
                                            disp_stats, card)
    progress("phase 14: report")

    print(card_line())
    print(json.dumps({"serving": {"crystals_per_request": N_GRAPHS,
                                  "edge_slots": int(batch0.num_edge_slots),
                                  "node_slots": int(batch0.num_node_slots),
                                  **stats}}))
    print(json.dumps({"training": train_stats}))
    print(json.dumps({"cli": cli_stats}))
    print(json.dumps({"variants": var_stats}))
    print(json.dumps({"dispatch": disp_stats}))
    print(json.dumps({"parallel": par_stats}))
    print(json.dumps({"export": exp_stats}))
    print(json.dumps({"streaming": stream_stats}))
    print(json.dumps({"gp": gp_stats}))
    print(json.dumps({"active_learning": al_stats}))
    print(json.dumps({"tools": tools_stats}))
    # launches: a forward kernel's count on the serving path (3 requests),
    # a backward kernel's on the training path (13 steps); train_launches
    # is every kernel's count on the training path, cli_launches in the
    # cli phase, variants_launches in the variants phase's checked steps
    # and CLI calls, replay_launches in a replayed step of the dispatch
    # phase (from the profiler); edge_rows: #5 to #7 at the hyper-edge
    # model's edge rows; serve_replay_launches in a replayed request of
    # phase 3 (from the profiler), stream_launches its #1 device events
    # through the stream kernel, export_launches in phase 9's served
    # requests, streaming_launches in phase 10's two CLI calls
    edge_rows = var_stats["hyper_edge"]["edge_rows"]
    kernels = [{"name": r["name"], "route": "cuda",
                "source": f"cgat_tpu_torch/csrc/{SOURCES[r['name']]}.cu",
                "replaces": REPLACES[r["name"]],
                "launches": (launches if r["name"] in PER_FORWARD
                             else train_launches)[r["name"]],
                "train_launches": train_launches[r["name"]],
                "cli_launches": cli_launches[r["name"]],
                "variants_launches": var_launches[r["name"]],
                "replay_launches": disp_stats["replay_launches"][r["name"]],
                "serve_replay_launches": stats["replay_launches"].get(
                    r["name"], 0),
                "export_launches": exp_launches[r["name"]],
                "streaming_launches": stream_launches[r["name"]],
                "gp_launches": gp_launches[r["name"]],
                "al_launches": al_launches[r["name"]],
                "tools_launches": tools_launches[r["name"]],
                "parallel_launches": {k: v[r["name"]]
                                      for k, v in par_launches.items()},
                **({"stream_launches": stats["segment_attention_routes"][
                    "stream"]} if r["name"] == "segment_attention" else {}),
                **({"pair_launches": par_stats["edge2_gloo"][
                    "pair_launches_per_rank_step"][r["name"]],
                    "pair_path": pair_row}
                   if r["name"] in ("segment_attention",
                                    "segment_attention_bwd") else {}),
                "max_abs_err": r["max_abs_err"], "tolerance": KERNEL_TOL,
                "rel_norm_err": r["rel_norm_err"], "norm_tolerance": NORM_TOL,
                "checks": r["checks"],
                "ms": r["ms"], "device_ms": r["device_ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"),
                **{k: r[k] for k in ("cublas_ms", "cublas_device_ms",
                                     "library_device_ms",
                                     "deterministic", "device_split",
                                     "layouts")
                   if k in r},
                **({"edge_rows": edge_rows[r["name"]]}
                   if r["name"] in edge_rows else {})}
               for r in rows + train_rows]
    # the port's own kernel, on the dropout training step's path: its
    # launches (forward and backward, one C entry) in phase 6's dropout
    # steps and in a replayed dropout step of phase 7 (profiler)
    kernels.append({
        "name": "dropout", "route": "cuda",
        "source": f"cgat_tpu_torch/csrc/{SOURCES['dropout']}.cu",
        "replaces": REPLACES["dropout"],
        "launches": var_launches["dropout"],
        "replay_launches": disp_stats["dropout"]["replay_launches"][
            "dropout"],
        "al_launches": al_launches["dropout"],
        "tools_launches": tools_launches["dropout"],
        "masks_equal": dropout_row["masks_equal"],
        **{k: dropout_row[k] for k in (
            "shape", "max_abs_err", "rel_norm_err", "checks",
            "deterministic", "kept_share", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}})
    # the port's own optimizer pass, on every AdamW step's path: its
    # launches an eager update of phase 7's flat layout and of the
    # parameters as they are, and in a replayed step (``fused_stats``);
    # ms and device ms of the flat update, plain ms the device time of
    # the flat layout's _foreach sequence
    a_opt, a_replay = disp_stats["optimizer"], disp_stats["replay_optimizer"]
    kernels.append({
        "name": "adamw", "route": "cuda",
        "source": f"cgat_tpu_torch/csrc/{SOURCES['adamw']}.cu",
        "replaces": REPLACES["adamw"],
        "launches": a_opt["flat"]["fused_launches"],
        "inner_tensors": a_opt["flat"]["inner_tensors"],
        "launches_unflattened": a_opt["plain"]["fused_launches"],
        "unflattened_tensors": a_opt["plain"]["inner_tensors"],
        "replay_launches": a_replay["launches"],
        "replay_elements": a_replay["elements"],
        "replay_multi_tensor_apply": a_replay["multi_tensor_apply"],
        "bit_equal_updates": a_opt["fused_vs_foreach_updates"],
        "ms": a_opt["flat"]["wall_ms_median"],
        "device_ms": a_opt["flat"]["fused_device_ms"],
        "plain_ms": a_opt["foreach"]["device_busy_ms"],
        "plain_multi_tensor_apply": a_opt["foreach"]["multi_tensor_apply"],
        "bound_ms": a_opt["bound_ms"], "bound_by": a_opt["bound_by"],
        "share": a_opt["share"]})
    if not all(k["launches"] for k in kernels):
        fail(f"a kernel was never launched on its path: "
             f"{[k['name'] for k in kernels if not k['launches']]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    progress("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
