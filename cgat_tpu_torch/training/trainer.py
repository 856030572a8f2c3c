"""Single-device trainer, counterpart of ``Trainer`` in
``cgat_tpu/training/trainer.py`` (reference CGAT/lightning_module.py and
CGAT/train.py).

One step (``make_train_step`` there): the forward, the criterion on the
normalised target, the backward, the optimizer (``make_optimizer``: SGD,
Adam, AdamW or LAMB, only the output head's parameters under
``only_residual``, gradients averaged over ``acc_batches`` mini-steps),
then the damping projection. Under model dropout the masks are drawn on
the device from ``(seed, step, site)``, ``step`` the count of training
steps as a device int64 (``step_count``) that the step itself advances and
the checkpoint keeps, so a resumed run draws the same masks. The
learning rate is set per epoch from the cyclical or plateau schedule; the
normalisation mean and std come from the training split (torch's unbiased
std). Metrics: the loss on the normalised scale, MAE and RMSE of the
denormalised predictions against the raw targets. ``fit`` logs each epoch
to ``metrics.jsonl`` (and TensorBoard on request) and keeps the top-1
``val_mae`` checkpoint ``best`` and the crash-safe ``last``, from which
``resume_trainer`` continues a run exactly.

SGD, Adam and AdamW always run over the small parameters flattened
(``training/flatten.py``: the same bits, a fifth of the tensors), so
``flat_optimizer`` is kept for the JAX package's configs and has no
effect. On the card every training step is a replay of a CUDA graph of
the whole step, one per batch shape signature and optimizer phase
(``training/dispatch.py``), the counterpart of the JAX package's jitted
step, model dropout included (its masks come from the device step
count, so each replay draws new ones); on the CPU it is an eager step.
``steps_per_dispatch`` K groups K batches padded to one shape
(``parallel.ParallelLoader``) and runs them as K steps in one call
(``train_group``); the trajectory is that of K single steps, and every
step of a group advances the step count, as every step of the JAX
package's ``make_multi_step`` advances ``state.step`` (the training
loaders drop their partial tail, so no group holds an empty step).

``n_devices`` N > 1 or ``edge_shards`` S > 1, or a ``torch.distributed``
world already joined, make the trainer one rank of a dp x edge mesh
(``parallel/``): N ranks (0: the world's size), dp = N / S replicas, each
cut into S edge shards. Every rank builds the same weights and the same
shuffled order, collates its own replica (its edge shard of it) and takes
the parallel step (``parallel.make_parallel_train_step``: the global
masked-mean loss, its gradient summed over the world); under NCCL each
step replays its CUDA graph with the collectives inside, under gloo
(the CPU, or several ranks on one card) it is eager, since gloo's
collectives cannot be captured. Validation and embeddings run across the
mesh too. Rank 0 alone writes ``metrics.jsonl``, TensorBoard and the
checkpoints; a resume loads the same checkpoint on every rank.

``streaming`` trains out of core from the ``*.pickle.gz`` shards under
``data_path`` (``data/streaming.py``, one shard in host memory): the
normalisation and the static-shape bounds come from one cached scan of
the shards, ``val_path`` is required and the validation and test sets
are loaded in memory; the plain, grouped and mesh loaders each have their
streaming variant, in the same order after a resume. Every loader of
``fit``, ``evaluate_split``, ``predict`` and ``embeddings`` is wrapped in
``data.prefetch.PrefetchLoader``, which collates the next batches on a
host thread while the card works.

``profile_epoch`` N records epoch N's training steps as a
``torch.profiler`` trace under ``<run>/profile`` (``utils.profiling.trace``;
one file a rank, named by it), on every path: eager, replayed, grouped,
streaming and on a mesh. Each training step is an ``annotate`` span
``cgat.train_step`` in it (``utils/profiling.py`` lists the others).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import os
import shutil
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.batching import CrystalBatch
from ..data.dataset import GraphLoader, load_dataset_dir, split_dataset
from ..data.prefetch import PrefetchLoader
from ..data.streaming import StreamingGraphLoader, scan_shard_metadata
from ..device import resolve_device
from ..models.cgat import CGATConfig, CGAtNet, DropoutKey
from ..models.init import init_state_dict
from ..parallel import (ParallelLoader, StreamingParallelLoader,
                        init_distributed, local_batch, local_dp_rows,
                        make_mesh, make_parallel_embed_step,
                        make_parallel_eval_step, make_parallel_train_step)
from ..utils.profiling import ThroughputMeter, annotate, trace
from . import losses as L
from . import schedules
from .dispatch import StepGraphs
from .flatten import FlatLayout, FlatOptimizer
from .optim import LAMB, SGD, Adam, AdamW, MultiSteps, project_params

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainerConfig:
    """Optimisation, data and output flags: the JAX package's
    ``TrainerConfig`` (reference argparse, lightning_module.py:426-593 and
    train.py:82-131) less the attention backend, which the port has no
    counterpart for (the kernel is the only one). ``momentum`` is SGD's
    (``optax.sgd``'s trace decay); the other optimizers ignore it.
    ``version`` names a module whose ``CGAtNet`` class the trainer builds
    instead of the port's (the reference's ``--version`` plug-in)."""
    # data
    data_path: str = "data/"
    fea_path: str | None = None
    target: str = "e_above_hull_new"
    max_nbr: int = 24
    val_size: float = 0.1
    test_size: float = 0.1
    train_percentage: float = 0.0
    val_path: str | None = None
    test_path: str | None = None
    streaming: bool = False
    # optimisation
    batch_size: int = 64
    epochs: int = 390
    optim: str = "AdamW"            # SGD | Adam | AdamW | LAMB
    learning_rate: float = 0.000125
    momentum: float = 0.9
    weight_decay: float = 1e-6
    # dtype of Adam's and AdamW's first moment; the second is always f32
    moment_dtype: str = "float32"
    loss: str = "L1"                # L1 | L2
    robust_loss: bool = False
    clr: bool = True
    clr_period: int = 130
    acc_batches: int = 1
    only_residual: bool = False
    seed: int = 0
    check_val_every_n_epoch: int = 2
    # batching
    node_bucket: int = 64
    num_comp_slots: int | None = None
    # io: runs go to ckpt_dir/runs/run_name (a timestamped name by default)
    ckpt_dir: str = "tb_logs"
    run_name: str | None = None
    log_tensorboard: bool = False
    # refresh the crash-safe "last" checkpoint every N non-improving
    # validation epochs (1 = every one)
    last_ckpt_every: int = 1
    # observability
    profile_epoch: int = -1
    nan_guard: bool = True
    steps_per_dispatch: int = 1
    version: str = ""
    # the JAX package's flag; no effect here: make_optimizer flattens
    # wherever the update is elementwise
    flat_optimizer: bool = False
    # parallelism: ranks of the world (0: all it has) and edge shards a
    # replica
    n_devices: int = 1
    edge_shards: int = 1


def _check_config(cfg: TrainerConfig) -> None:
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be one of {list(_MOMENT_DTYPES)}")
    if cfg.n_devices < 0:
        raise ValueError(f"n_devices must be at least 0, not {cfg.n_devices}")
    for field in ("acc_batches", "steps_per_dispatch", "edge_shards"):
        if getattr(cfg, field) < 1:
            raise ValueError(f"{field} must be at least 1, not "
                             f"{getattr(cfg, field)}")


def make_optimizer(cfg: TrainerConfig, params):
    """The optimizer of the JAX package's ``make_optimizer``
    (lightning_module.py:306-355) over ``params``: SGD with momentum
    (weight decay in front only when it is not 0), Adam (coupled weight
    decay), AdamW or LAMB, with the first moment of Adam and AdamW in
    ``moment_dtype``; SGD, Adam and AdamW over the small parameters
    flattened (:class:`FlatOptimizer`, which makes them views into flat
    vectors: the same bits over a fifth of the tensors) whatever
    ``flat_optimizer`` says, except under ``only_residual``, as in the JAX
    package (LAMB's trust ratio is per tensor); wrapped in
    :class:`MultiSteps` when ``acc_batches`` is above 1. Under
    ``only_residual`` the caller passes the output head's parameters only
    (``multi_transform`` with ``set_to_zero`` for the rest: no update, no
    weight decay, no state)."""
    mu_dtype = _MOMENT_DTYPES[cfg.moment_dtype]
    lr, wd = cfg.learning_rate, cfg.weight_decay
    params = list(params)
    layout = None
    if cfg.optim in ("SGD", "Adam", "AdamW") and not cfg.only_residual:
        layout = FlatLayout(params)
    inner = params if layout is None else layout.inner
    if cfg.optim == "SGD":
        opt = SGD(inner, lr, momentum=cfg.momentum, weight_decay=wd)
    elif cfg.optim == "Adam":
        opt = Adam(inner, lr, weight_decay=wd, mu_dtype=mu_dtype)
    elif cfg.optim == "AdamW":
        opt = AdamW(inner, lr, weight_decay=wd, mu_dtype=mu_dtype)
    elif cfg.optim == "LAMB":
        opt = LAMB(inner, lr, weight_decay=wd)
    else:
        raise NameError("Only SGD, Adam, AdamW, LAMB are allowed as optim")
    if layout is not None:
        opt = FlatOptimizer(params, opt, layout)
    return MultiSteps(opt, cfg.acc_batches) if cfg.acc_batches > 1 else opt


def build_model(cfg: TrainerConfig, model_cfg: CGATConfig):
    """The port's ``CGAtNet``, or the ``CGAtNet`` class of the module
    ``cfg.version`` names (the reference's plug-in import,
    lightning_module.py:161-176)."""
    if cfg.version:
        return importlib.import_module(cfg.version).CGAtNet(model_cfg)
    return CGAtNet(model_cfg)


def _metrics(output, log_std, target, mask, mean, std, criterion):
    target_norm = (target - mean) / std
    loss = criterion(output, log_std, target_norm, mask)
    pred = output * std + mean
    return loss, {"loss": loss, "mae": L.l1(pred, target, mask),
                  "rmse": torch.sqrt(L.mse(pred, target, mask))}


def _load(cfg: TrainerConfig, path: str):
    return load_dataset_dir(path, fea_path=cfg.fea_path,
                            max_neighbor_number=cfg.max_nbr,
                            target=cfg.target)


class MetricsLogger:
    """``metrics.jsonl`` (one record per call: ``step``, ``time`` and the
    metrics as floats) and, on request, TensorBoard scalars (the reference
    used TensorBoardLogger, train.py:40)."""

    def __init__(self, log_dir: str, tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"warning: TensorBoard logging was asked for but "
                      f"torch.utils.tensorboard does not import ({e}); "
                      f"logging to {self.path} only", file=sys.stderr)
            else:
                self._tb = SummaryWriter(log_dir)

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def _inference(method):
    """A Trainer method run under ``torch.no_grad`` with the model in eval
    mode (no dropout), its mode restored after."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return method(self, *args, **kwargs)
        finally:
            self.model.train(was_training)
    return wrapped


def _world_size(cfg: TrainerConfig) -> int:
    """The ranks ``cfg`` asks for: ``n_devices``, or with 0 the joined
    world's (or the environment's) size."""
    if cfg.n_devices:
        return cfg.n_devices
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


class Trainer:
    """End-to-end trainer on one device (the CUDA card unless ``device``
    says otherwise; raises if there is none), or one rank of a parallel
    world (see the module's docstring; ``device`` then names the kind,
    and the rank's card is its ``LOCAL_RANK``). Without ``graphs`` it
    loads ``cfg.data_path``, unless ``mean`` and ``std`` are given (a
    model rebuilt for inference only); under ``cfg.streaming`` it scans
    the shards there instead and ignores ``graphs``."""

    def __init__(self, cfg: TrainerConfig, model_cfg: CGATConfig,
                 graphs=None, *, mean: float | None = None,
                 std: float | None = None, device=None):
        _check_config(cfg)
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        # the mesh when this trainer is one rank of a parallel world
        self.mesh = None
        n = _world_size(cfg)
        if n > 1 or cfg.edge_shards > 1 or dist.is_initialized():
            if n % cfg.edge_shards:
                raise ValueError(f"edge_shards={cfg.edge_shards} does not "
                                 f"divide the {n} ranks")
            have = (dist.get_world_size() if dist.is_initialized()
                    else int(os.environ.get("WORLD_SIZE", 1)))
            if have != n:
                raise ValueError(
                    f"n_devices={cfg.n_devices} asks for {n} ranks; the "
                    f"world has {have} (start the ranks with torchrun or "
                    f"cli.train --devices {n})")
            self.device = init_distributed(self.device)
            self.mesh = make_mesh(n // cfg.edge_shards, cfg.edge_shards)
            local_dp_rows(self.mesh)    # raises if an edge group straddles
        self.criterion = L.make_loss(cfg.loss, cfg.robust_loss)
        self.model: CGAtNet | None = None
        self.opt = None
        self.step = 0
        # the step count on the device, which dropout's masks are drawn
        # from (made with the model)
        self.step_count: torch.Tensor | None = None
        # the CUDA graphs of the step (dispatch.StepGraphs), made at the
        # first training step on the card
        self.step_graphs: StepGraphs | None = None
        self._plateau = None
        self._stream_meta = None
        if cfg.streaming:
            self._setup_streaming()
        elif graphs is not None:
            self._setup_data(graphs)
        elif mean is not None:
            self.mean, self.std = float(mean), float(std)
            self.train_graphs = self.val_graphs = self.test_graphs = []
        else:
            self._setup_data(_load(cfg, cfg.data_path))

    def _setup_data(self, graphs):
        """Split the graphs (or take the validation and test sets from
        their own paths) and take the normalisation from the training
        split."""
        cfg = self.cfg
        if cfg.val_path is None or cfg.test_path is None:
            tr, va, te = split_dataset(len(graphs), seed=cfg.seed,
                                       val_size=cfg.val_size,
                                       test_size=cfg.test_size,
                                       train_percentage=cfg.train_percentage)
            self.train_graphs = [graphs[i] for i in tr]
            self.val_graphs = [graphs[i] for i in va]
            self.test_graphs = [graphs[i] for i in te]
        else:
            self.train_graphs = list(graphs)
            self.val_graphs = _load(cfg, cfg.val_path)
            self.test_graphs = _load(cfg, cfg.test_path)
        ys = np.asarray([g.target for g in self.train_graphs], np.float64)
        # torch.std default is unbiased (ddof=1), lightning_module.py:124-126
        self.mean = float(ys.mean())
        self.std = float(ys.std(ddof=1)) if len(ys) > 1 else 1.0
        print(f"mean: {self.mean} std: {self.std}")

    def _setup_streaming(self):
        """Out of core: one cached scan of the training shards gives the
        normalisation and the static-shape bounds; the shards stay on
        disk, the validation and test sets load in memory from their own
        paths, and the composition slots are pinned dataset-wide."""
        cfg = self.cfg
        if cfg.val_path is None:
            raise ValueError("streaming=True requires --val-path (the "
                             "training shards are never all in memory, so "
                             "index-based splits cannot apply)")
        self._stream_meta = scan_shard_metadata(
            cfg.data_path, target=cfg.target, fea_path=cfg.fea_path,
            max_nbr=cfg.max_nbr)
        self.mean = self._stream_meta["mean"]
        self.std = self._stream_meta["std"]
        print(f"mean: {self.mean} std: {self.std} "
              f"({self._stream_meta['n_graphs']} streamed graphs)")
        self.train_graphs = []
        self.val_graphs = _load(cfg, cfg.val_path)
        self.test_graphs = _load(cfg, cfg.test_path) if cfg.test_path else []
        if cfg.num_comp_slots is None:
            self.cfg = dataclasses.replace(cfg, num_comp_slots=max(
                self._stream_meta["num_comp_slots"],
                max((g.comp_fea.shape[0]
                     for g in self.val_graphs + self.test_graphs),
                    default=1)))

    # ------------------------------------------------------------- state

    def init_state(self, state_dict: dict | None = None) -> CGAtNet:
        """Build the model with f32 master weights (seeded from ``cfg.seed``
        unless a ``state_dict`` is given) and a fresh optimizer; returns the
        model. Under ``only_residual`` every parameter outside
        ``output_nn`` is frozen (``requires_grad`` False: no gradient, no
        update, no optimizer state)."""
        model = build_model(self.cfg, self.model_cfg)
        if state_dict is None:
            state_dict = init_state_dict(model, seed=self.cfg.seed)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).train()
        params = list(self.model.parameters())
        if self.cfg.only_residual:
            for name, p in self.model.named_parameters():
                p.requires_grad_(name.startswith("output_nn."))
            params = [p for p in params if p.requires_grad]
        self.opt = make_optimizer(self.cfg, params)
        self.step = 0
        self.step_count = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        self.step_graphs = None
        self._parallel_step = None
        if self.mesh is not None:
            self._parallel_step = make_parallel_train_step(
                self.model, self.opt, self.criterion, self.mean, self.std,
                self.mesh, seed=self.cfg.seed)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"this model has {n_params:d} parameters")
        return self.model

    @property
    def is_main(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh is None or dist.get_rank() == 0

    def loader(self, graphs, *, shuffle: bool) -> GraphLoader:
        cfg = self.cfg
        return GraphLoader(graphs, cfg.batch_size, shuffle=shuffle,
                           seed=cfg.seed, max_nbr=cfg.max_nbr,
                           node_bucket=cfg.node_bucket,
                           num_comp_slots=cfg.num_comp_slots)

    def _streaming_loader(self) -> StreamingGraphLoader:
        """The shuffled stream of training batches over the shards."""
        cfg = self.cfg
        return StreamingGraphLoader(
            cfg.data_path, cfg.batch_size, target=cfg.target,
            fea_path=cfg.fea_path, shuffle=True, seed=cfg.seed,
            max_nbr=cfg.max_nbr, node_bucket=cfg.node_bucket,
            meta=self._stream_meta)

    def train_loader(self):
        """The training loader ``fit`` iterates (inside its prefetcher):
        a rank's groups on a mesh, groups of ``steps_per_dispatch``
        batches, or single batches; over the shards under
        ``cfg.streaming``, where every rank streams every shard and
        collates its own replica."""
        cfg, mesh = self.cfg, self.mesh
        if mesh is not None:
            if cfg.streaming:
                return StreamingParallelLoader(
                    self._streaming_loader(), mesh.dp.size,
                    edge_shards=mesh.edge.size, process_index=mesh.dp.index,
                    process_count=mesh.dp.size)
            return self.mesh_loader(self.train_graphs, shuffle=True)
        if cfg.steps_per_dispatch > 1:
            if cfg.streaming:
                return StreamingParallelLoader(self._streaming_loader(),
                                               cfg.steps_per_dispatch)
            return self.grouped_loader(self.train_graphs)
        if cfg.streaming:
            return self._streaming_loader()
        return self.loader(self.train_graphs, shuffle=True)

    def grouped_loader(self, graphs) -> ParallelLoader:
        """The shuffled training loader of groups of
        ``steps_per_dispatch`` batches padded to one shape."""
        cfg = self.cfg
        return ParallelLoader(graphs, cfg.batch_size, cfg.steps_per_dispatch,
                              shuffle=True, seed=cfg.seed, max_nbr=cfg.max_nbr,
                              node_bucket=cfg.node_bucket,
                              num_comp_slots=cfg.num_comp_slots)

    def mesh_loader(self, graphs, *, shuffle: bool,
                    drop_last: bool = True) -> ParallelLoader:
        """A rank's loader: groups of one batch a replica, this rank's
        replica collated (``process_index`` its dp index), in edge shards
        when the mesh has them; :meth:`rank_batch` takes its part."""
        cfg, mesh = self.cfg, self.mesh
        return ParallelLoader(graphs, cfg.batch_size, mesh.dp.size,
                              shuffle=shuffle, seed=cfg.seed,
                              max_nbr=cfg.max_nbr,
                              node_bucket=cfg.node_bucket,
                              num_comp_slots=cfg.num_comp_slots,
                              drop_last=drop_last,
                              edge_shards=mesh.edge.size,
                              process_index=mesh.dp.index,
                              process_count=mesh.dp.size)

    def rank_batch(self, group: CrystalBatch) -> CrystalBatch:
        """This rank's batch of a :meth:`mesh_loader` group, on its
        device."""
        mesh = self.mesh
        return local_batch(group, 0, mesh.edge.index,
                           mesh.edge.size).to(self.device)

    # -------------------------------------------------------------- step

    def forward_loss(self, batch: CrystalBatch):
        """The criterion and the metrics of one batch on the device. In
        training mode, model dropout draws its masks from ``cfg.seed`` and
        the device step count."""
        out = self.model(batch, dropout_key=DropoutKey((self.cfg.seed,),
                                                       self.step_count))
        return _metrics(out[:, 0], out[:, 1], batch.target, batch.graph_mask,
                        self.mean, self.std, self.criterion)

    def backward(self, loss) -> None:
        self.opt.zero_grad()
        loss.backward()

    def _update_on_device(self) -> None:
        self.opt.apply()
        project_params(self.model)
        self.step_count.add_(1)

    def _advance(self) -> None:
        """The host's part of a step: the optimizer's bookkeeping and the
        step count."""
        self.opt.advance()
        self.step += 1

    def apply_update(self) -> None:
        self._update_on_device()
        self._advance()

    def _step_on_device(self, batch: CrystalBatch) -> dict:
        """A step's work on the device, host state untouched (what a CUDA
        graph of the step captures)."""
        if self._parallel_step is not None:
            metrics = self._parallel_step(batch, self.step_count)
            self.step_count.add_(1)
            return metrics
        loss, metrics = self.forward_loss(batch)
        self.backward(loss)
        self._update_on_device()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch: CrystalBatch) -> dict:
        """One optimisation step; returns the step's metrics as device
        scalars (read them on the host only where needed). On a CUDA card
        a replay of the step's CUDA graph for the batch's shapes and the
        optimizer's phase (captured after the first, eager, step of each);
        on the CPU an eager step. On a rank of a
        parallel world ``batch`` is the rank's own (:meth:`rank_batch`),
        and the step is replayed under NCCL only: gloo's collectives
        cannot be captured."""
        with annotate("train_step"):
            batch = batch.to(self.device)
            if self.device.type == "cuda" \
                    and (self.mesh is None or self.mesh.backend == "nccl"):
                if self.step_graphs is None:
                    self.step_graphs = StepGraphs(self.device)
                metrics = self.step_graphs.run(self._step_on_device, batch,
                                               self.opt.phase)
                self._advance()
                return {k: v.clone() for k, v in metrics.items()}
            metrics = self._step_on_device(batch)
            self._advance()
            return metrics

    def train_group(self, group: CrystalBatch) -> list[dict]:
        """One step per batch of a stacked group (``grouped_loader``), in
        one call; returns each step's metrics as device scalars."""
        group = group.to(self.device)
        return [self.train_step(group.map(lambda t: t[i]))
                for i in range(group.target.shape[0])]

    # --------------------------------------------------------------- fit

    def fit(self, *, epochs: int | None = None, start_epoch: int = 0,
            best_val: float = float("inf"),
            plateau_state: dict | None = None,
            last_val_mae: float | None = None) -> list[dict]:
        """Train from ``start_epoch`` up to ``epochs`` (exclusive;
        ``cfg.epochs`` by default). Logs each epoch to
        ``ckpt_dir/runs/<run_name>/metrics.jsonl`` and keeps the top-1
        ``val_mae`` checkpoint ``best`` and the crash-safe ``last`` there.
        ``start_epoch``, ``best_val``, ``plateau_state`` and
        ``last_val_mae`` continue an interrupted run exactly (the
        reference's resume_from_checkpoint, train.py:64-76; see
        ``resume_trainer``). Returns one record of host metrics per epoch
        run, with the validation metrics on the epochs that validate."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        if self.model is None:
            self.init_state()
        run_name = cfg.run_name or \
            f"f-{cfg.seed}_t-{time.strftime('%Y-%m-%d_%H-%M-%S')}"
        log_dir = os.path.join(cfg.ckpt_dir, "runs", run_name)
        logger = MetricsLogger(log_dir, cfg.log_tensorboard) \
            if self.is_main else None
        ckpt = CheckpointManager(log_dir) if self.is_main else None
        if cfg.clr:
            sched = schedules.cyclical_lr(period=cfg.clr_period,
                                          cycle_mul=0.1, tune_mul=0.05)
            lr_of_epoch = lambda e, _: cfg.learning_rate * sched(e)
            self._plateau = None
        else:
            plateau = schedules.ReduceLROnPlateau()
            if plateau_state:
                plateau.__dict__.update(plateau_state)
            self._plateau = plateau
            lr_of_epoch = lambda e, m: cfg.learning_rate * (
                plateau.step(m) if m is not None else plateau.scale)
        grouped = cfg.steps_per_dispatch > 1 and self.mesh is None
        loader = PrefetchLoader(self.train_loader())
        history, val_mae, vals_since_last = [], last_val_mae, 0
        try:
            for epoch in range(start_epoch, epochs):
                loader.set_epoch(epoch)
                self.opt.lr = lr_of_epoch(epoch, val_mae)
                meter = ThroughputMeter()
                steps = []
                with trace(os.path.join(log_dir, "profile")
                           if epoch == cfg.profile_epoch else None):
                    for batch in loader:
                        if self.mesh is not None:
                            steps.append(self.train_step(
                                self.rank_batch(batch)))
                        elif grouped:
                            steps += self.train_group(batch)
                        else:
                            steps.append(self.train_step(batch))
                        meter.update(**loader.last_counts,
                                     steps=cfg.steps_per_dispatch
                                     if grouped else 1)
                if not steps:
                    raise RuntimeError("training split smaller than one "
                                       "batch")
                train_m = {k: float(torch.stack([m[k] for m in steps]).mean())
                           for k in steps[0]}
                if cfg.nan_guard and not all(
                        np.isfinite(v) for v in train_m.values()):
                    raise FloatingPointError(
                        f"non-finite training metrics at epoch {epoch}: "
                        f"{train_m}")
                rates = meter.rates()
                rec = {"epoch": epoch, "lr": self.opt.lr,
                       **{f"train_{k}": v for k, v in train_m.items()},
                       **rates}
                if logger is not None:
                    logger.log(self.step, epoch=epoch,
                               train_loss=train_m["loss"],
                               train_mae=train_m["mae"],
                               train_rmse=train_m["rmse"], **rates)
                if (epoch + 1) % cfg.check_val_every_n_epoch == 0 \
                        and self.val_graphs:
                    val = self.evaluate_split(self.val_graphs)
                    val_mae = val["mae"]
                    rec.update({f"val_{k}": v for k, v in val.items()})
                    if logger is not None:
                        logger.log(self.step, epoch=epoch,
                                   val_loss=val["loss"], val_mae=val["mae"],
                                   val_rmse=val["rmse"])
                    # best on improvement; last beside it for resume,
                    # copied when the two coincide, else every
                    # last_ckpt_every validations (the validation is
                    # global, so every rank takes the same branch)
                    if val_mae < best_val:
                        best_val = val_mae
                        if ckpt is not None:
                            ckpt.save(self, epoch=epoch, val_mae=val_mae,
                                      best_val=best_val)
                            ckpt.clone("best", "last")
                        vals_since_last = 0
                    else:
                        vals_since_last += 1
                        if vals_since_last >= cfg.last_ckpt_every:
                            if ckpt is not None:
                                ckpt.save(self, epoch=epoch,
                                          val_mae=val_mae, tag="last",
                                          best_val=best_val)
                            vals_since_last = 0
                history.append(rec)
        finally:
            if logger is not None:
                logger.close()
        self.last_log_dir = log_dir
        return history

    @_inference
    def evaluate_split(self, graphs) -> dict:
        """Masked-exact metrics over every graph: tail batches are padded,
        not dropped. Across the mesh on a rank of a parallel world."""
        if self.mesh is not None:
            return self.evaluate_split_parallel(graphs)
        loader = self.loader(graphs, shuffle=False)
        loader.drop_last = False
        loader = PrefetchLoader(loader)
        tot, n = None, 0.0
        for batch in loader:
            batch = batch.to(self.device)
            _, m = self.forward_loss(batch)
            k = float(batch.graph_mask.sum())
            m = {key: float(v) * k for key, v in m.items()}
            tot = m if tot is None else {key: tot[key] + m[key] for key in m}
            n += k
        if tot is None:
            return {"loss": float("nan"), "mae": float("nan"),
                    "rmse": float("nan")}
        return {k: v / n for k, v in tot.items()}

    @_inference
    def evaluate_split_parallel(self, graphs) -> dict:
        """:meth:`evaluate_split` across the mesh: every replica evaluates
        its own batches (the tail group padded with fully masked ones) and
        the sums are reduced over the world; the same on every rank."""
        step = make_parallel_eval_step(self.model, self.criterion,
                                       self.mean, self.std, self.mesh)
        tot = None
        for group in self.mesh_loader(graphs, shuffle=False,
                                      drop_last=False):
            m = step(self.rank_batch(group))
            tot = m if tot is None else {k: tot[k] + m[k] for k in m}
        if tot is None:
            return {"loss": float("nan"), "mae": float("nan"),
                    "rmse": float("nan")}
        n = float(tot.pop("n"))
        return {k: float(v) / n for k, v in tot.items()}

    @_inference
    def predict(self, graphs) -> np.ndarray:
        """Denormalised predictions in dataset order; the tail batch is
        padded, so every graph gets one."""
        loader = self.loader(graphs, shuffle=False)
        loader.drop_last = False
        loader = PrefetchLoader(loader)
        preds = []
        for batch in loader:
            batch = batch.to(self.device)
            out = self.model(batch)[:, 0] * self.std + self.mean
            preds.append(out[batch.graph_mask].cpu().numpy())
        return np.concatenate(preds) if preds else np.zeros((0,))

    @_inference
    def embeddings(self, graphs) -> np.ndarray:
        """Graph embeddings (n, embedding_dim) as f32, in dataset order
        (calculate_embeddings.py flow); across the mesh on a rank of a
        parallel world."""
        if self.mesh is not None:
            return self.embeddings_parallel(graphs)
        loader = self.loader(graphs, shuffle=False)
        loader.drop_last = False
        loader = PrefetchLoader(loader)
        out = []
        for batch in loader:
            batch = batch.to(self.device)
            e = self.model(batch, return_graph_embedding=True)
            out.append(e[batch.graph_mask].float().cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,))

    @_inference
    def embeddings_parallel(self, graphs) -> np.ndarray:
        """:meth:`embeddings` across the mesh: each replica embeds its own
        batches and the results are gathered over the dp axis, in dataset
        order, on every rank."""
        step = make_parallel_embed_step(self.model, self.mesh)
        out = []
        for group in self.mesh_loader(graphs, shuffle=False,
                                      drop_last=False):
            for rows in step(self.rank_batch(group)).cpu().numpy():
                out.append(rows[rows[:, -1] > 0, :-1])
        return np.concatenate(out) if out else np.zeros((0,))


class CheckpointManager:
    """Top-1 ``val_mae`` checkpointing (the reference's ModelCheckpoint,
    train.py:42-48) into ``<log_dir>/checkpoints``: ``{tag}.pt`` holds the
    f32 master weights, the optimizer's state and the step count
    (``torch.save``); ``{tag}.json`` the epoch, the validation numbers, the plateau state, the
    normalisation and both configs, so ``load_trainer`` rebuilds the run
    (lightning_module.py:413-424)."""

    def __init__(self, log_dir: str):
        self.dir = os.path.abspath(os.path.join(log_dir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)

    def save(self, trainer: Trainer, *, epoch: int, val_mae: float,
             tag: str = "best", best_val: float | None = None):
        path = os.path.join(self.dir, f"{tag}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": trainer.model.state_dict(),
                    "optimizer": trainer.opt.state_dict(),
                    "step": trainer.step}, tmp)
        os.replace(tmp, path)
        plateau = trainer._plateau
        meta = {
            "epoch": epoch, "val_mae": float(val_mae),
            "best_val": float(best_val if best_val is not None else val_mae),
            "plateau": dict(plateau.__dict__) if plateau is not None else None,
            "mean": trainer.mean, "std": trainer.std,
            "trainer_config": dataclasses.asdict(trainer.cfg),
            "model_config": dataclasses.asdict(trainer.model_cfg),
        }
        with open(os.path.join(self.dir, f"{tag}.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)

    def clone(self, src_tag: str, dst_tag: str):
        """Copy a checkpoint's files under another tag."""
        for ext in (".pt", ".json"):
            shutil.copyfile(os.path.join(self.dir, src_tag + ext),
                            os.path.join(self.dir, dst_tag + ext))

    @staticmethod
    def _resolve(ckpt_dir: str) -> str:
        d = ckpt_dir
        if os.path.isdir(os.path.join(d, "checkpoints")):
            d = os.path.join(d, "checkpoints")
        return os.path.abspath(d)

    @staticmethod
    def _read(ckpt_dir: str, tag: str, map_location):
        d = CheckpointManager._resolve(ckpt_dir)
        with open(os.path.join(d, f"{tag}.json")) as f:
            meta = json.load(f)
        payload = torch.load(os.path.join(d, f"{tag}.pt"),
                             map_location=map_location, weights_only=True)
        return payload, meta

    @staticmethod
    def load(ckpt_dir: str, tag: str = "best", map_location=None):
        """Returns (state_dict, meta). ``ckpt_dir`` is .../checkpoints or the
        run dir holding it; ``tag`` selects best|last."""
        payload, meta = CheckpointManager._read(ckpt_dir, tag, map_location)
        return payload["model"], meta

    @staticmethod
    def load_state(ckpt_dir: str, trainer: Trainer, tag: str = "last"):
        """Restore the full training state (weights, the optimizer's state
        and count, the step) into ``trainer``, whose model and optimizer are
        already built; tensors go to the trainer's device. Raises
        ``ValueError`` when the checkpoint's first moment has another dtype
        than ``trainer.cfg.moment_dtype``."""
        payload, _ = CheckpointManager._read(ckpt_dir, tag, trainer.device)
        trainer.opt.load_state_dict(payload["optimizer"])
        trainer.model.load_state_dict(payload["model"], strict=True)
        trainer.step = int(payload["step"])
        trainer.step_count.fill_(trainer.step)


def _config_from(cls, stored: dict):
    """A config dataclass from a checkpoint's JSON, keeping the fields
    ``cls`` has (JSON turns tuples into lists and, through ``default=str``,
    may store None as "None")."""
    kw = {k: (None if v == "None" else v) for k, v in stored.items()
          if k in cls.__dataclass_fields__}
    if "out_hidden" in kw:
        kw["out_hidden"] = tuple(kw["out_hidden"])
    return cls(**kw)


def load_trainer(run_dir: str, *, train: bool = False, graphs=None,
                 tag: str = "best", device=None, parallel: bool = False,
                 **overrides):
    """Rebuild a Trainer, its model loaded from a checkpoint
    (LightningModel.load, lightning_module.py:413-424). ``train`` loads the
    checkpoint's dataset when no ``graphs`` are given; ``overrides``
    replace TrainerConfig fields. The stored normalisation always wins.
    Returns ``(trainer, meta)``. Unless ``parallel`` (a resume, which runs
    on the ranks the config or ``overrides`` ask for), the trainer is one
    device's whatever ranks the checkpoint's run had."""
    device = resolve_device(device)
    if not parallel:
        overrides = {"n_devices": 1, "edge_shards": 1, **overrides}
    state_dict, meta = CheckpointManager.load(run_dir, tag=tag,
                                              map_location=device)
    tcfg = _config_from(TrainerConfig,
                        {**meta["trainer_config"], **overrides})
    mcfg = _config_from(CGATConfig, meta["model_config"])
    if train and graphs is None and not tcfg.streaming:
        graphs = _load(tcfg, tcfg.data_path)
    trainer = Trainer(tcfg, mcfg, graphs, mean=meta["mean"], std=meta["std"],
                      device=device)
    trainer.mean, trainer.std = meta["mean"], meta["std"]
    trainer.init_state(state_dict)
    return trainer, meta


def resume_trainer(run_dir: str, *, graphs=None, tag: str = "last",
                   device=None, **overrides):
    """Rebuild a Trainer with its full training state for an exact resume.

    Returns ``(trainer, meta)``; continue with
    ``trainer.fit(start_epoch=meta['epoch'] + 1, best_val=meta['best_val'],
    plateau_state=meta['plateau'], last_val_mae=meta['val_mae'])``, which
    reproduces the uninterrupted run (reference resume_from_checkpoint,
    train.py:64-76). A streaming run streams its shards again, in the
    same order."""
    trainer, meta = load_trainer(run_dir, train=graphs is None,
                                 graphs=graphs, tag=tag, device=device,
                                 parallel=True, **overrides)
    CheckpointManager.load_state(run_dir, trainer, tag=tag)
    return trainer, meta
