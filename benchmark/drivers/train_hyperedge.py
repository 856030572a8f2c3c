"""Training of the hypernetwork-edge model (``no_hyper`` False) through
``Trainer.train_step``: ``drivers/train.py``'s loop (its plan of the
loader's batches, its prefetched feed, its set-up of checked, warm-up and
replayed steps and its window), held against ``reference/hyperedge.py``.
Beside what that driver does, each run

* compares, as ``emb_gap``, the graph embeddings of the first step's
  crystals at the seeded weights with the reference's, read where the
  first ``Trainer.train_step`` computes them (the eager step before the
  capture of its graph, the same launches its replays make: a forward
  pre-hook on the head, ``output_nn``, that keeps its input once and is
  removed after that step, so no capture holds it): a forward at fixed
  weights, which the signs of the L1 loss's residuals do not enter;
* keeps ``grad_gap`` in the notes and out of the judged numbers: one
  crystal whose residual rounds to the other sign turns every leaf's
  first gradient by up to a third, so sound bf16 runs read up to the
  float8 control's band, and no fault reads far above it (PERF.md
  section 2); ``emb_gap`` carries the precision control;
* switches the program's launch record on before the set-up captures its
  graphs (``ops.kernels.build.record_launches``: at each capture, one list
  append a launch; a replay records nothing) and fails unless each
  captured graph made 4 (n_graph - 1) #5 launches in the live edge
  update's scope on its edge slots (``edge_update_mismatch``); a traced
  run gives the traced view each graph's launches by its node slots
  (``View.extra["launches"]``), which ``harness/hyperedge.py`` reads;
* counts the live edge updates of the window's steps from the program's
  counter (``models.cgat.edge_update_stats``) and fails unless each step
  ran n_graph - 1 of them on its edge slots (``edge_update_mismatch``).
A program without the record or the counter is not checked by it, and
gives the view nothing.
"""
from __future__ import annotations

from pathlib import Path

import torch

from harness import cell as cells
from harness import checks, common, hyperedge, traffic, weights
from reference import hyperedge as ref_model
from reference import optim as ref_optim
from reference.precision import Precision

train = cells.module("drivers", "train", Path(__file__).resolve().parents[1])

# the controls (precisions of the reference in the program's place) and
# the faults that calibrate.py reads
CONTROLS = ("float8",)
FAULTS = ("half_batch", "still")

pool, Plan, Feed = train.pool, train.Plan, train.Feed


def _program():
    from cgat_tpu_torch.models import cgat
    from cgat_tpu_torch.ops.kernels import build
    return {**train._program(), "cgat": cgat, "build": build}


def build_trainer(cell, prog, crystals, plan: Plan):
    """``drivers/train.py``'s trainer, with this model's parameters."""
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


def launches_by_nodes(step_graphs) -> dict:
    """Each captured graph's launch record by its node slots (its batch
    signature's first field, the node features' rows); {} where the
    program keeps none."""
    kept = getattr(step_graphs, "launches", None) or {}
    return {key[0][0][0]: launches for key, launches in kept.items()}


def edge_update_launches(step_graphs, max_nbr: int) -> dict:
    """Each captured graph's #5 launches in the live edge update's scope on
    its edge slots (its node slots times ``max_nbr``), by its node slots
    and optimizer phase; {} where the program keeps no launch record."""
    kept = getattr(step_graphs, "launches", None) or {}
    return {f"{key[0][0][0]}/{key[1]}": hyperedge.edge_update_launches(
        launches, key[0][0][0] * max_nbr) for key, launches in kept.items()}


def run(cell) -> dict:
    ph = common.Phases(cell)
    prog = _program()
    dev = cell.device
    if torch.device(dev).type == "cuda":
        prog["build"].build()
    record = getattr(prog["build"], "record_launches", None)
    if record is not None:
        record(True)
    stats = getattr(prog["cgat"], "edge_update_stats", None)
    ph("imports and kernels")
    crystals = pool(cell)
    plan = Plan(cell, crystals)
    ph("crystals")
    trainer, shapes = build_trainer(cell, prog, crystals, plan)
    ph("trainer and weights")
    names = [n for n, _ in trainer.model.named_parameters()]
    feed = Feed(cell, prog, trainer)
    inner = feed.loader.inner
    bad_feed, taken = [], []

    def take():
        s, batch, counts = feed.next()
        taken.append(s)
        want = plan.shapes(s)
        if (counts["graphs"], counts["edges"]) != (want["n"], want["Er"]):
            bad_feed.append(s)
        return s, batch

    first = {}

    def keep_embeddings(module, args):
        first["emb"] = args[0].detach().clone()
        hook.remove()

    hook = trainer.model.output_nn.register_forward_pre_hook(keep_embeddings)

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
        first_grad=lambda: train.adam_first_grad(
            trainer.opt.state_dict()["nu"], names),
        graphs=lambda: common.graphs_held(trainer.step_graphs))
    common.sync(dev)
    emb = first["emb"][:plan.shapes(0)["n"]].float().cpu()
    ph("checked steps and warm-up")
    graphs_before = common.graphs_held(trainer.step_graphs)
    counted_before = stats() if stats else None
    n_taken = len(taken)

    win, holder, steps = common.run_window(
        cell, take, step, "loader",
        lambda s: {**plan.shapes(s), "training": True})
    captures = common.graphs_held(trainer.step_graphs) - graphs_before
    counted = ({k: v - counted_before[k] for k, v in stats().items()}
               if stats else None)
    launches = launches_by_nodes(trainer.step_graphs)
    edge_launches = edge_update_launches(trainer.step_graphs,
                                         cell.config["trainer"]["max_nbr"])
    if record is not None:
        record(False)
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
            3 * hyperedge.hyperedge_flops(cell.config["model"], st)
            for st in steps)
        if launches:
            out["view"].extra["launches"] = launches
    ref = reference(cell, crystals, plan, shapes, rec["seq"], rec["start"])
    training = checks.training_numbers(rec, ref)
    out["numbers"] = judged(training, emb, ref)
    out["notes"].update(checks.training_notes(rec, ref))
    out["notes"]["grad_gap"] = training["grad_gap"]
    if bad_feed:
        out["numbers"]["feed_mismatch"] = float(len(bad_feed))
    layers = hyperedge.live_layers(cell.config["model"])
    if edge_launches:
        out["notes"]["edge_update_launches"] = edge_launches
        if any(n != 4 * layers for n in edge_launches.values()):
            out["numbers"]["edge_update_mismatch"] = 1.0
    if counted is not None:
        want = {"layers": layers * win.n,
                "rows": layers * sum(plan.shapes(s)["E"]
                                     for s in taken[n_taken:])}
        out["notes"]["edge_updates"] = {"counted": counted, "expected": want}
        if counted != want:
            out["numbers"]["edge_update_mismatch"] = 1.0
    return out


def judged(training: dict, emb, ref: dict) -> dict:
    """The numbers judged against the cell's limits: the training numbers
    but ``grad_gap`` (left to the notes), and ``emb_gap``."""
    return {**{k: v for k, v in training.items() if k != "grad_gap"},
            "emb_gap": checks.emb_gap(emb, ref["emb"])}


def reference(cell, crystals, plan: Plan, shapes: dict, seq: list,
              start: int, precision: str = "float32",
              fault: str | None = None) -> dict:
    """``drivers/train.py``'s reference with this model: each step's loss,
    the first gradient's norm of each leaf and each leaf's change over the
    steps from position ``start`` on, ``fault`` planted as there; and the
    graph embeddings of the first step's crystals at the seeded
    weights."""
    common.reference_mode()
    dev = cell.device
    t = cell.config["trainer"]
    P = weights.make_weights(shapes, cell.seed, dev)
    for v in P.values():
        v.requires_grad_(True)
    net = ref_model.CGAT(cell.config["model"], Precision(precision))
    opt = ref_optim.AdamW(P, t["learning_rate"] * train._lr_scale(t, 0),
                          weight_decay=t["weight_decay"])
    mean, std = plan.normalisation()
    losses, grad, before = [], None, None
    for j, s in enumerate(seq):
        if j == start:
            before = common.snapshot(P)
        b = ref_model.make_batch(crystals, plan.idx(s), dev)
        if j == 0:
            with torch.no_grad():
                emb = net.embed(P, b).cpu()
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
            "sizes": {k: v.numel() for k, v in P.items()}, "emb": emb}


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
    return judged(checks.training_numbers(low, ref), low["emb"], ref)
