"""The GP head trained on the fly on the frozen backbone: ``GPFit.step``
over a ``GraphLoader``, composed as ``fit_gp_streaming`` composes them
(the ELBO of ``frozen_embed``'s embeddings of each batch, as
``streaming_elbo`` composes it; each batch collated inline and copied to
the card, on the card each step a replay of its CUDA graph, each epoch's
mean loss read after it). The backbone is the configuration's model with
seeded weights, loaded as ``cli.train_gp`` loads a run (a ``Trainer``,
f32 masters, bf16 compute, eval mode). The inducing points are the
frozen embeddings of a batch of distinct crystals of the pool, which the
dataset does not hold.

Set-up makes the pool and the weights, the backbone and the inducing
points, then drives the fit through ``common.set_up_sequence`` (the first
steps through the window's call and feed, one step of every batch shape
the window's order holds within a generous bound, the feed's next steps,
which replay). The reference follows every one of those steps, and the
backbone's embeddings of each step's batch and of the inducing rows are
compared with its own."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from harness import checks, common, order, traffic, weights, yardsticks
from reference import model as ref_model
from reference import optim as ref_optim
from reference import svgp
from reference.precision import Precision

# the controls calibrate.py reads: the backbone in float8 (below its
# bf16), the SVGP in TF32 (below its f32), and both at once; the faults
CONTROLS = ("float8+tf32", "float8", "tf32")
FAULTS = ("half_batch", "still")


def _program():
    from cgat_tpu_torch.data.batching import CrystalGraph
    from cgat_tpu_torch.data.dataset import GraphLoader
    from cgat_tpu_torch.models.cgat import CGATConfig
    from cgat_tpu_torch.training import Trainer, TrainerConfig
    from cgat_tpu_torch.training.dispatch import signature
    from cgat_tpu_torch.uncertainty import gp
    return dict(CrystalGraph=CrystalGraph, GraphLoader=GraphLoader,
                CGATConfig=CGATConfig, Trainer=Trainer,
                TrainerConfig=TrainerConfig, signature=signature, gp=gp)


def pool(cell) -> traffic.Crystals:
    return traffic.from_mix(cell.seed, cell.traffic,
                            cell.config["backbone"]["orig_elem_fea_len"])


class Plan:
    """The GP loader's batches over the dataset of the mix (the pool
    repeated, ``traffic.dataset_rows``) and the inducing rows, worked out
    by the benchmark."""

    def __init__(self, cell, crystals):
        g = cell.config["gp"]
        self.crystals = crystals
        self.batch = g["batch_size"]
        self.node_bucket = cell.config["trainer"]["node_bucket"]
        self.seed = cell.program_seed
        # the inducing rows are crystals of the pool that the dataset does
        # not hold: a batch of the source's millions holds one of them
        # about once in ten steps, where a small pool repeated would put
        # several in every batch (and the ELBO would then turn on how
        # alike the program embeds one crystal in two batches)
        perm = np.random.default_rng(cell.program_seed).permutation(
            len(crystals))
        self.inducing = perm[:g["num_inducing"]]
        others = np.sort(perm[g["num_inducing"]:])
        self.rows = others[traffic.dataset_rows(cell.traffic, len(others))]
        self.n = len(self.rows)
        self.per_epoch = self.n // self.batch
        self._epochs: dict = {}
        ys = crystals.target[self.rows].astype(np.float64)
        self.mean, self.std = float(ys.mean()), float(ys.std(ddof=1))

    def positions(self, step: int) -> np.ndarray:
        """The step's crystals as positions in the dataset."""
        e, b = divmod(step, self.per_epoch)
        if e not in self._epochs:
            self._epochs[e] = order.epoch_batches(self.n, self.batch,
                                                  self.seed, e)
        return self._epochs[e][b]

    def idx(self, step: int) -> np.ndarray:
        """The step's crystals as indices into the pool."""
        return self.rows[self.positions(step)]

    def shapes(self, step: int) -> dict:
        return traffic.batch_shapes(self.crystals, self.idx(step),
                                    slots=self.batch,
                                    node_bucket=self.node_bucket)


class Embeddings:
    """The ELBO of the on-the-fly step as ``streaming_elbo`` composes it,
    keeping the backbone's embeddings that the step computed: those of an
    eager step, and of each captured graph (its buffer, which a replay of
    that graph refills). ``last(batch)`` gives the real rows' embeddings
    of the step just taken on ``batch``."""

    def __init__(self, prog, model, plan: Plan, gcfg, capturing):
        self.gp, self.signature = prog["gp"], prog["signature"]
        self.model, self.plan, self.gcfg = model, plan, gcfg
        self.capturing = capturing
        self.eager = None
        self.captured: dict = {}

    def elbo_of(self, params, batch):
        gp = self.gp
        x = gp.frozen_embed(self.model, batch)
        if self.capturing():
            self.captured[self.signature(batch)] = x
        else:
            self.eager = x
        return gp.elbo(params, x, (batch.target - self.plan.mean)
                       / self.plan.std, self.plan.n, self.gcfg,
                       mask=batch.graph_mask)

    def last(self, batch, replayed: bool):
        x = self.captured[self.signature(batch)] if replayed else self.eager
        return x[batch.graph_mask].detach().clone()


def run(cell) -> dict:
    ph = common.Phases(cell)
    prog = _program()
    gp = prog["gp"]
    dev = torch.device(cell.device)
    if dev.type == "cuda":
        from cgat_tpu_torch.ops.kernels import build
        build.build()
    m, t, g = cell.config["backbone"], cell.config["trainer"], \
        cell.config["gp"]
    ph("imports and kernels")
    crystals = pool(cell)
    plan = Plan(cell, crystals)
    members = traffic.to_graphs(crystals, prog["CrystalGraph"])
    graphs = [members[i] for i in plan.rows]
    tcfg = prog["TrainerConfig"](batch_size=t["batch_size"],
                                 node_bucket=t["node_bucket"],
                                 max_nbr=t["max_nbr"],
                                 moment_dtype=t["moment_dtype"],
                                 seed=cell.program_seed)
    trainer = prog["Trainer"](
        tcfg, common.model_config(prog["CGATConfig"], m), mean=plan.mean,
        std=plan.std, device=dev)
    shapes = ref_model.param_shapes(m)
    sd = weights.make_weights(shapes, cell.seed, dev)
    trainer.init_state(sd)
    del sd
    model = trainer.model
    ph("crystals, backbone and weights")

    # fit_gp_streaming's composition
    gcfg = gp.GPConfig(zero_mean=g["zero_mean"], jitter=g["jitter"])
    model.eval()
    inducing = gp.inducing_embeddings(
        model, [members[i] for i in plan.inducing], max_nbr=t["max_nbr"],
        node_bucket=t["node_bucket"], num_comp_slots=None)
    cuda = dev.type == "cuda"
    emb = Embeddings(prog, model, plan, gcfg,
                     lambda: cuda and torch.cuda.is_current_stream_capturing())
    fit = gp.GPFit(gp.init_gp(inducing.cpu().numpy(), gcfg, dev), gcfg,
                   g["learning_rate"], emb.elbo_of, dev)
    loader = prog["GraphLoader"](graphs, min(g["batch_size"], plan.n),
                                 shuffle=True, seed=cell.program_seed,
                                 max_nbr=t["max_nbr"],
                                 node_bucket=t["node_bucket"],
                                 num_comp_slots=None)
    history, losses = [], []
    ph("inducing points")

    def batches():
        for epoch in itertools.count():
            loader.set_epoch(epoch)
            for batch in loader:
                yield batch
            if losses:
                history.append(float(torch.stack(losses).mean()))
            losses.clear()

    it = batches()
    counter = itertools.count()
    take = lambda: (next(counter), next(it))
    trained = [k for k, _ in fit.params.named()
               if not (g["zero_mean"] and k == "mean_const")]
    prog_emb = [inducing.detach().clone()]

    def step(batch):
        held = common.graphs_held(fit.graphs)
        batch = batch.to(dev)
        losses.append(fit.step(batch))
        if collecting:
            prog_emb.append(emb.last(batch, bool(held) and
                                     common.graphs_held(fit.graphs) == held))
        return losses[-1]

    def warm_batch(s):
        warm = prog["GraphLoader"]([graphs[i] for i in plan.positions(s)],
                                   loader.batch_size, shuffle=False,
                                   max_nbr=loader.max_nbr,
                                   node_bucket=loader.node_bucket,
                                   num_comp_slots=loader.num_comp_slots)
        return next(iter(warm))

    collecting = True
    rec = common.drive_set_up(
        plan, int(cell.traffic["checked_steps"]), common.planned_steps(cell),
        feed=take, warm_batch=warm_batch, step=step,
        params=lambda: {k: v for k, v in fit.params.named() if k in trained},
        first_grad=lambda: _first_grad(fit, trained),
        graphs=lambda: common.graphs_held(fit.graphs))
    collecting = False
    prog_emb = torch.cat(prog_emb).cpu().numpy()
    common.sync(dev)
    ph("checked steps and warm-up")
    graphs_before = common.graphs_held(fit.graphs)

    win, holder, steps = common.run_window(
        cell, take, step, "collate",
        lambda s: {**plan.shapes(s), "training": False})
    captures = common.graphs_held(fit.graphs) - graphs_before
    peak = common.memory_peak(dev)
    it.close()
    del trainer, model, fit, loader, it, emb
    common.release(dev)

    window_s = win.t_end - win.t_start
    out = {"metrics": {
        "gp_graphs_per_s": {"value": plan.batch * win.n / window_s,
                            "unit": "graphs/s"},
        "setup_s": {"value": win.t_start - cell.t0, "unit": "s"}},
        "attempted": win.n, "failed": 0, "memory_peak_bytes": peak,
        "window_s": window_s,
        "notes": {"captures_in_window": captures,
                  "set_up_steps": len(rec["seq"]),
                  "replayed_checked": rec["replayed"]}}
    if cell.trace:
        from harness import trace as tr
        view = tr.view_of(holder["prof"], steps, m)
        d = m["elem_fea_len"] * m["msg_heads"]
        view.extra["flops"] = sum(
            yardsticks.model_flops(m, st, head=False)
            + 3 * yardsticks.svgp_flops(len(plan.inducing), st["C"], d)
            for st in steps)
        out["view"] = view
    ref = reference(cell, crystals, plan, shapes, rec["seq"], rec["start"])
    out["numbers"] = {**checks.training_numbers(rec, ref),
                      "emb_gap": checks.emb_gap(prog_emb, ref["emb"])}
    out["notes"].update(checks.training_notes(rec, ref))
    return out


def _first_grad(fit, trained: list) -> dict:
    """Each trained leaf's first gradient norm from Adam's second moment
    after one update."""
    return {k: float(torch.sqrt(v.double().sum() / (1 - 0.999)))
            for k, v in zip(trained, fit.opt.state_dict()["nu"])}


def reference(cell, crystals, plan: Plan, shapes: dict, seq: list,
              start: int, precision: str = "float32",
              fault: str | None = None) -> dict:
    """The plain reference over the plan's steps ``seq``: the f32
    backbone's embeddings (the inducing rows' and each step's batch's),
    each step's -ELBO, the first gradient's norm of each GP parameter, and
    each one's change over the steps from position ``start`` on.
    ``precision`` names the control: ``float8`` lowers the backbone's
    products, ``tf32`` the SVGP's (``float8+tf32`` both); ``fault`` as in
    the training driver."""
    common.reference_mode()
    dev = cell.device
    m, g = cell.config["backbone"], cell.config["gp"]
    P = weights.make_weights(shapes, cell.seed, dev)
    net = ref_model.CGAT(m, Precision("float8" if "float8" in precision
                                      else "float32"))
    gp_precision = Precision("tf32" if "tf32" in precision else "float32")

    @torch.no_grad()
    def embed(idx):
        return net.embed(P, ref_model.make_batch(crystals, idx, dev))

    embs = [embed(plan.inducing)]
    G = svgp.init(embs[0])
    for v in G.values():
        v.requires_grad_(True)
    opt = ref_optim.AdamW(G, g["learning_rate"], weight_decay=0.0,
                          decoupled=False)
    losses, grad, before = [], None, None
    for j, s in enumerate(seq):
        if j == start:
            before = common.snapshot(G)
        idx = plan.idx(s)
        x = embed(idx)
        embs.append(x)
        y = (torch.as_tensor(crystals.target[idx], dtype=torch.float32,
                             device=dev) - plan.mean) / plan.std
        keep = len(idx) // 2 if fault == "half_batch" else len(idx)
        loss = svgp.neg_elbo(G, x[:keep], y[:keep], plan.n, g["jitter"],
                             gp_precision)
        gr = ref_optim.grads_of(loss, G)
        if grad is None:
            grad = {k: float(gr[k].double().norm()) for k in G}
        if fault != "still":
            opt.step(gr)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad": grad,
            "change": common.change_norms(G, before),
            "sizes": {k: v.numel() for k, v in G.items()},
            "emb": torch.cat(embs).cpu().numpy()}


def numbers(cell, precision: str, fault: str | None = None) -> dict:
    """The cell's numbers of the reference in ``precision`` with ``fault``
    planted, put in the program's place, against the f32 reference, over
    the steps a run's set-up takes."""
    crystals = pool(cell)
    plan = Plan(cell, crystals)
    shapes = ref_model.param_shapes(cell.config["backbone"])
    seq, start = common.set_up_sequence(
        plan, int(cell.traffic["checked_steps"]), common.planned_steps(cell))
    ref = reference(cell, crystals, plan, shapes, seq, start)
    low = reference(cell, crystals, plan, shapes, seq, start, precision,
                    fault)
    return {**checks.training_numbers(low, ref),
            "emb_gap": checks.emb_gap(low["emb"], ref["emb"])}
