"""Single-device in-memory trainer, counterpart of ``Trainer`` in
``cgat_tpu/training/trainer.py`` (reference CGAT/lightning_module.py and
CGAT/train.py).

One step (``make_train_step`` there): the forward, the criterion on the
normalised target, the backward, AdamW, then the damping projection. The
learning rate is set per epoch from the cyclical or plateau schedule; the
normalisation mean and std come from the training split (torch's unbiased
std). Metrics: the loss on the normalised scale, MAE and RMSE of the
denormalised predictions against the raw targets.

Not ported yet, each named by the ``TrainerConfig`` field that asks for it
(which raises ``NotImplementedError``): checkpoints, metric logs and
TensorBoard, streaming and prefetch, ``steps_per_dispatch``,
``flat_optimizer``, the optimizers other than AdamW, ``only_residual``,
``acc_batches``, the parallel and edge-sharded trainers, model plug-ins and
profiling. ``fit`` keeps no checkpoint and returns the per-epoch metrics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.batching import CrystalBatch
from ..data.dataset import GraphLoader, split_dataset
from ..device import resolve_device
from ..models.cgat import CGATConfig, CGAtNet
from ..models.init import init_state_dict
from . import losses as L
from . import schedules
from .optim import AdamW, project_params

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainerConfig:
    """Optimisation and data flags: the JAX package's ``TrainerConfig``
    (reference argparse, lightning_module.py:426-593 and train.py:82-131)
    less the fields of what the port reads from elsewhere (the dataset
    paths and target: ``Trainer`` takes the graphs) or has no counterpart
    for (``momentum`` of SGD, the checkpoint naming, the attention backend:
    the kernel is the only one)."""
    # data (the graphs are passed to ``Trainer``)
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
    optim: str = "AdamW"
    learning_rate: float = 0.000125
    weight_decay: float = 1e-6
    # dtype of AdamW's first moment; the second moment is always f32
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
    # io
    ckpt_dir: str | None = None       # no checkpoints yet
    log_tensorboard: bool = False
    # observability
    profile_epoch: int = -1
    nan_guard: bool = True
    steps_per_dispatch: int = 1
    version: str = ""
    flat_optimizer: bool = False
    # parallelism
    n_devices: int = 1
    edge_shards: int = 1


# (field, the value the port runs, the slice of the port that brings the rest)
_NOT_PORTED = (
    ("streaming", False, "slice 5 (streaming and prefetch)"),
    ("val_path", None, "slice 3 (dataset loading)"),
    ("test_path", None, "slice 3 (dataset loading)"),
    ("optim", "AdamW", "slice 3 (SGD, Adam and LAMB)"),
    ("acc_batches", 1, "slice 3 (gradient accumulation)"),
    ("only_residual", False, "slice 3 (transfer learning)"),
    ("ckpt_dir", None, "slice 3 (checkpoints)"),
    ("log_tensorboard", False, "slice 3 (metric logs)"),
    ("profile_epoch", -1, "slice 9 (tracing)"),
    ("steps_per_dispatch", 1, "slice 3 (multi-step dispatch)"),
    ("version", "", "slice 3 (model plug-ins)"),
    ("flat_optimizer", False, "slice 3 (flat optimizer)"),
    ("n_devices", 1, "slice 4 (data parallel)"),
    ("edge_shards", 1, "slice 4 (edge sharding)"),
)


def _check_ported(cfg: TrainerConfig) -> None:
    for field, value, where in _NOT_PORTED:
        if getattr(cfg, field) != value:
            raise NotImplementedError(
                f"TrainerConfig.{field}={getattr(cfg, field)!r} is not ported "
                f"yet; it comes with {where}")
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be one of {list(_MOMENT_DTYPES)}")


def _metrics(output, log_std, target, mask, mean, std, criterion):
    target_norm = (target - mean) / std
    loss = criterion(output, log_std, target_norm, mask)
    pred = output * std + mean
    return loss, {"loss": loss, "mae": L.l1(pred, target, mask),
                  "rmse": torch.sqrt(L.mse(pred, target, mask))}


class Trainer:
    """End-to-end trainer on one device (the CUDA card unless ``device``
    says otherwise; raises if there is none)."""

    def __init__(self, cfg: TrainerConfig, model_cfg: CGATConfig,
                 graphs=None, *, device=None):
        _check_ported(cfg)
        if graphs is None:
            raise NotImplementedError("loading a dataset directory is not "
                                      "ported yet; it comes with slice 3")
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.criterion = L.make_loss(cfg.loss, cfg.robust_loss)
        self.model: CGAtNet | None = None
        self.opt: AdamW | None = None
        self._setup_data(graphs)

    def _setup_data(self, graphs):
        """Split the graphs and take the normalisation from the training
        split."""
        cfg = self.cfg
        tr, va, te = split_dataset(len(graphs), seed=cfg.seed,
                                   val_size=cfg.val_size,
                                   test_size=cfg.test_size,
                                   train_percentage=cfg.train_percentage)
        self.train_graphs = [graphs[i] for i in tr]
        self.val_graphs = [graphs[i] for i in va]
        self.test_graphs = [graphs[i] for i in te]
        ys = np.asarray([g.target for g in self.train_graphs], np.float64)
        # torch.std default is unbiased (ddof=1), lightning_module.py:124-126
        self.mean = float(ys.mean())
        self.std = float(ys.std(ddof=1)) if len(ys) > 1 else 1.0

    # ------------------------------------------------------------- state

    def init_state(self, state_dict: dict | None = None) -> CGAtNet:
        """Build the model with f32 master weights (seeded from ``cfg.seed``
        unless a ``state_dict`` is given) and a fresh optimizer; returns the
        model."""
        model = CGAtNet(self.model_cfg)
        if state_dict is None:
            state_dict = init_state_dict(model, seed=self.cfg.seed)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).train()
        self.opt = AdamW(self.model.parameters(), self.cfg.learning_rate,
                         weight_decay=self.cfg.weight_decay,
                         mu_dtype=_MOMENT_DTYPES[self.cfg.moment_dtype])
        return self.model

    def loader(self, graphs, *, shuffle: bool) -> GraphLoader:
        cfg = self.cfg
        return GraphLoader(graphs, cfg.batch_size, shuffle=shuffle,
                           seed=cfg.seed, max_nbr=cfg.max_nbr,
                           node_bucket=cfg.node_bucket,
                           num_comp_slots=cfg.num_comp_slots)

    # -------------------------------------------------------------- step

    def forward_loss(self, batch: CrystalBatch):
        """The criterion and the metrics of one batch on the device."""
        out = self.model(batch)
        return _metrics(out[:, 0], out[:, 1], batch.target, batch.graph_mask,
                        self.mean, self.std, self.criterion)

    def backward(self, loss) -> None:
        self.opt.zero_grad()
        loss.backward()

    def apply_update(self) -> None:
        self.opt.step()
        project_params(self.model)

    def train_step(self, batch: CrystalBatch) -> dict:
        """One optimisation step; returns the step's metrics as device
        scalars (read them on the host only where needed)."""
        batch = batch.to(self.device)
        loss, metrics = self.forward_loss(batch)
        self.backward(loss)
        self.apply_update()
        return {k: v.detach() for k, v in metrics.items()}

    # --------------------------------------------------------------- fit

    def fit(self, *, epochs: int | None = None) -> list[dict]:
        """Train ``epochs`` epochs (``cfg.epochs`` by default); returns one
        record of host metrics per epoch, with the validation metrics on the
        epochs that validate."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        if self.model is None:
            self.init_state()
        if cfg.clr:
            sched = schedules.cyclical_lr(period=cfg.clr_period,
                                          cycle_mul=0.1, tune_mul=0.05)
            lr_of_epoch = lambda e, _: cfg.learning_rate * sched(e)
        else:
            plateau = schedules.ReduceLROnPlateau()
            lr_of_epoch = lambda e, m: cfg.learning_rate * (
                plateau.step(m) if m is not None else plateau.scale)
        loader = self.loader(self.train_graphs, shuffle=True)
        history, val_mae = [], None
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            self.opt.lr = lr_of_epoch(epoch, val_mae)
            steps = [self.train_step(batch) for batch in loader]
            if not steps:
                raise RuntimeError("training split smaller than one batch")
            rec = {"epoch": epoch, "lr": self.opt.lr}
            rec.update({f"train_{k}": float(torch.stack(
                [m[k] for m in steps]).mean()) for k in steps[0]})
            if cfg.nan_guard and not all(
                    np.isfinite(v) for k, v in rec.items()
                    if k.startswith("train_")):
                raise FloatingPointError(
                    f"non-finite training metrics at epoch {epoch}: {rec}")
            if (epoch + 1) % cfg.check_val_every_n_epoch == 0 \
                    and self.val_graphs:
                val = self.evaluate_split(self.val_graphs)
                val_mae = val["mae"]
                rec.update({f"val_{k}": v for k, v in val.items()})
            history.append(rec)
        return history

    @torch.no_grad()
    def evaluate_split(self, graphs) -> dict:
        """Masked-exact metrics over every graph: tail batches are padded,
        not dropped."""
        loader = self.loader(graphs, shuffle=False)
        loader.drop_last = False
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

    @torch.no_grad()
    def predict(self, graphs) -> np.ndarray:
        """Denormalised predictions in dataset order; the tail batch is
        padded, so every graph gets one."""
        loader = self.loader(graphs, shuffle=False)
        loader.drop_last = False
        preds = []
        for batch in loader:
            batch = batch.to(self.device)
            out = self.model(batch)[:, 0] * self.std + self.mean
            preds.append(out[batch.graph_mask].cpu().numpy())
        return np.concatenate(preds) if preds else np.zeros((0,))
