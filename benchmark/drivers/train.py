"""Training through ``Trainer.train_step`` (on the card each step a replay
of its CUDA graph), fed by the trainer's own loader in the collate-ahead
``PrefetchLoader``, epoch after epoch as ``Trainer.fit`` iterates it
(``steps_per_dispatch`` 1; the learning rate of each epoch's cyclical
schedule set before it, each epoch's mean loss read after it; no
validation or checkpoint).

Set-up makes the pool and the weights from the seed and builds the
trainer, then drives it through ``common.set_up_sequence``: the first
steps through the window's call and feed, one step of every batch shape
the window's order holds within a generous bound (so the window captures
nothing), and the feed's next steps, which replay. The reference follows
every one of those steps."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from harness import checks, common, order, traffic, weights, yardsticks
from reference import model as ref_model
from reference import optim as ref_optim
from reference.precision import Precision

# the controls (precisions of the reference in the program's place) and
# the faults that calibrate.py reads
CONTROLS = ("float8",)
FAULTS = ("half_batch", "still")


def _program():
    from cgat_tpu_torch.data.batching import CrystalGraph, collate
    from cgat_tpu_torch.data.prefetch import PrefetchLoader
    from cgat_tpu_torch.models.cgat import CGATConfig
    from cgat_tpu_torch.training import Trainer, TrainerConfig
    from cgat_tpu_torch.training.schedules import cyclical_lr
    return dict(CrystalGraph=CrystalGraph, collate=collate,
                PrefetchLoader=PrefetchLoader, CGATConfig=CGATConfig,
                Trainer=Trainer, TrainerConfig=TrainerConfig,
                cyclical_lr=cyclical_lr)


def pool(cell) -> traffic.Crystals:
    return traffic.from_mix(cell.seed, cell.traffic,
                            cell.config["model"]["orig_elem_fea_len"])


class Plan:
    """The crystals of each step of the trainer's loader, worked out by
    the benchmark (``harness.order``) over the dataset of the mix (the
    pool repeated, ``traffic.dataset_rows``)."""

    def __init__(self, cell, crystals):
        t = cell.config["trainer"]
        self.batch = t["batch_size"]
        self.node_bucket = t["node_bucket"]
        self.crystals = crystals
        self.rows = traffic.dataset_rows(cell.traffic, len(crystals))
        self.train = order.training_split(len(self.rows), cell.program_seed,
                                          t["val_size"], t["test_size"])
        self.seed = cell.program_seed
        self._epochs: dict = {}
        self.per_epoch = len(self.train) // self.batch

    def positions(self, step: int) -> np.ndarray:
        """The step's crystals as positions in the training split."""
        e, b = divmod(step, self.per_epoch)
        if e not in self._epochs:
            self._epochs[e] = order.epoch_batches(len(self.train), self.batch,
                                                  self.seed, e)
        return self._epochs[e][b]

    def idx(self, step: int) -> np.ndarray:
        """The step's crystals as indices into the pool."""
        return self.rows[self.train[self.positions(step)]]

    def shapes(self, step: int) -> dict:
        return traffic.batch_shapes(self.crystals, self.idx(step),
                                    slots=self.batch,
                                    node_bucket=self.node_bucket)

    def normalisation(self) -> tuple[float, float]:
        ys = self.crystals.target[self.rows[self.train]].astype(np.float64)
        return float(ys.mean()), float(ys.std(ddof=1))


def build_trainer(cell, prog, crystals, plan: Plan):
    t, m = cell.config["trainer"], cell.config["model"]
    graphs = traffic.to_graphs(crystals, prog["CrystalGraph"], plan.rows)
    tcfg = prog["TrainerConfig"](
        batch_size=t["batch_size"], optim=t["optim"],
        learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
        moment_dtype=t["moment_dtype"], loss=t["loss"], clr=t["clr"],
        clr_period=t["clr_period"], node_bucket=t["node_bucket"],
        max_nbr=t["max_nbr"], val_size=t["val_size"],
        test_size=t["test_size"], seed=cell.program_seed)
    trainer = prog["Trainer"](tcfg, common.model_config(prog["CGATConfig"],
                                                        m),
                              graphs, device=cell.device)
    shapes = ref_model.param_shapes(m)
    sd = weights.make_weights(shapes, cell.seed, cell.device)
    trainer.init_state(sd)
    del sd
    return trainer, shapes


class Feed:
    """The trainer's loader in its ``PrefetchLoader``, as ``fit`` iterates
    it: each epoch's learning rate set before it, each epoch's mean loss
    read after it. ``next()`` gives (step, batch, real counts)."""

    def __init__(self, cell, prog, trainer):
        t = cell.config["trainer"]
        self.trainer = trainer
        self.loader = prog["PrefetchLoader"](trainer.train_loader())
        sched = prog["cyclical_lr"](period=t["clr_period"], cycle_mul=0.1,
                                    tune_mul=0.05) if t["clr"] else None
        self.lr = lambda e: t["learning_rate"] * (sched(e) if sched else 1.0)
        self.metrics: list = []
        self.epoch_losses: list = []
        self._it = self._gen()
        self.step = 0

    def _gen(self):
        for epoch in itertools.count():
            self.loader.set_epoch(epoch)
            self.trainer.opt.lr = self.lr(epoch)
            for batch in self.loader:
                yield batch, dict(self.loader.last_counts)
            if self.metrics:
                self.epoch_losses.append(float(torch.stack(
                    [m["loss"] for m in self.metrics]).mean()))
            self.metrics = []

    def next(self):
        batch, counts = next(self._it)
        self.step += 1
        return self.step - 1, batch, counts

    def close(self):
        self._it.close()


def adam_first_grad(nu: list, names: list) -> dict:
    """The first gradient's norm of each leaf from an Adam-type
    optimizer's second moment after one update: nu = (1 - b2) g^2."""
    return {n: float(torch.sqrt(v.double().sum() / (1 - 0.999)))
            for n, v in zip(names, nu)}


def run(cell) -> dict:
    ph = common.Phases(cell)
    prog = _program()
    dev = cell.device
    if torch.device(dev).type == "cuda":
        from cgat_tpu_torch.ops.kernels import build
        build.build()
    ph("imports and kernels")
    crystals = pool(cell)
    plan = Plan(cell, crystals)
    ph("crystals")
    trainer, shapes = build_trainer(cell, prog, crystals, plan)
    ph("trainer and weights")
    names = [n for n, _ in trainer.model.named_parameters()]
    feed = Feed(cell, prog, trainer)
    inner = feed.loader.inner
    bad_feed = []

    def take():
        s, batch, counts = feed.next()
        want = plan.shapes(s)
        if (counts["graphs"], counts["edges"]) != (want["n"], want["Er"]):
            bad_feed.append(s)
        return s, batch

    def step(batch):
        m = trainer.train_step(batch)
        feed.metrics.append(m)
        return m["loss"]

    def warm_batch(s):
        return prog["collate"]([trainer.train_graphs[j]
                                for j in plan.positions(s)],
                               max_nbr=inner.max_nbr,
                               node_bucket=inner.node_bucket,
                               num_graphs=inner.batch_size,
                               num_comp_slots=inner.num_comp_slots,
                               max_degree=inner.max_degree)

    rec = common.drive_set_up(
        plan, int(cell.traffic["checked_steps"]), common.planned_steps(cell),
        feed=take, warm_batch=warm_batch, step=step,
        params=lambda: dict(trainer.model.named_parameters()),
        first_grad=lambda: adam_first_grad(trainer.opt.state_dict()["nu"],
                                           names),
        graphs=lambda: common.graphs_held(trainer.step_graphs))
    common.sync(dev)
    ph("checked steps and warm-up")
    graphs_before = common.graphs_held(trainer.step_graphs)

    win, holder, steps = common.run_window(
        cell, take, step, "loader",
        lambda s: {**plan.shapes(s), "training": True})
    captures = common.graphs_held(trainer.step_graphs) - graphs_before
    peak = common.memory_peak(dev)
    feed.close()
    del trainer, feed
    common.release(dev)

    window_s = win.t_end - win.t_start
    out = {"metrics": {
        "train_graphs_per_s": {"value": plan.batch * win.n / window_s,
                               "unit": "graphs/s"},
        "setup_s": {"value": win.t_start - cell.t0, "unit": "s"}},
        "attempted": win.n, "failed": 0, "memory_peak_bytes": peak,
        "window_s": window_s,
        "notes": {"captures_in_window": captures, "bad_feed": bad_feed,
                  "set_up_steps": len(rec["seq"]),
                  "replayed_checked": rec["replayed"]}}
    if cell.trace:
        from harness import trace as tr
        out["view"] = tr.view_of(holder["prof"], steps, cell.config["model"])
        out["view"].extra["flops"] = sum(
            3 * yardsticks.model_flops(cell.config["model"], st)
            for st in steps)
    ref = reference(cell, crystals, plan, shapes, rec["seq"], rec["start"])
    out["numbers"] = checks.training_numbers(rec, ref)
    out["notes"].update(checks.training_notes(rec, ref))
    if bad_feed:
        out["numbers"]["feed_mismatch"] = float(len(bad_feed))
    return out


def reference(cell, crystals, plan: Plan, shapes: dict, seq: list,
              start: int, precision: str = "float32",
              fault: str | None = None) -> dict:
    """The plain reference over the plan's steps ``seq``: each step's
    loss, the first gradient's norm of each leaf, and each leaf's change
    over the steps from position ``start`` on. ``fault`` plants one of
    the faults a check must catch, in the reference put in the program's
    place: ``half_batch`` (the loss the mean over the first half of each
    batch) or ``still`` (no update)."""
    common.reference_mode()
    dev = cell.device
    t = cell.config["trainer"]
    P = weights.make_weights(shapes, cell.seed, dev)
    for v in P.values():
        v.requires_grad_(True)
    net = ref_model.CGAT(cell.config["model"], Precision(precision))
    opt = ref_optim.AdamW(P, t["learning_rate"] * _lr_scale(t, 0),
                          weight_decay=t["weight_decay"])
    mean, std = plan.normalisation()
    losses, grad, before = [], None, None
    for j, s in enumerate(seq):
        if j == start:
            before = common.snapshot(P)
        b = ref_model.make_batch(crystals, plan.idx(s), dev)
        keep = b.num_graphs // 2 if fault == "half_batch" else b.num_graphs
        loss = ref_model.l1_loss(net.forward(P, b), b, mean, std, keep)
        g = ref_optim.grads_of(loss, P)
        if grad is None:
            grad = {k: float(g[k].double().norm()) if k in g else 0.0
                    for k in P}
        if fault != "still":
            opt.step(g)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad": grad,
            "change": common.change_norms(P, before),
            "sizes": {k: v.numel() for k, v in P.items()}}


def numbers(cell, precision: str, fault: str | None = None) -> dict:
    """The cell's numbers of the reference in ``precision`` with ``fault``
    planted, put in the program's place, against the f32 reference, over
    the steps a run's set-up takes."""
    crystals = pool(cell)
    plan = Plan(cell, crystals)
    shapes = ref_model.param_shapes(cell.config["model"])
    seq, start = common.set_up_sequence(
        plan, int(cell.traffic["checked_steps"]), common.planned_steps(cell))
    ref = reference(cell, crystals, plan, shapes, seq, start)
    low = reference(cell, crystals, plan, shapes, seq, start, precision,
                    fault)
    return checks.training_numbers(low, ref)


def _lr_scale(t: dict, epoch: int) -> float:
    """The cyclical schedule's multiplier at ``epoch`` (the reference's
    ``cyclical_lr`` with the trainer's 0.1 floor)."""
    if not t["clr"]:
        return 1.0
    period, floor = t["clr_period"], 0.1
    cycle = np.floor(1 + epoch / period)
    x = abs(2 * (epoch / period - cycle) + 1)
    return floor + (1.0 - floor) * max(0.0, 1.0 - x)
