"""Screening through ``load_artifact(dir).predict(graphs)``: one caller in
a closed loop, each request a list of candidate crystals drawn from the
pool (a new permutation of the pool each pass), served in forwards of
``chunk`` crystals, predictions, ``log_std`` and graph embeddings back on
the host.

Set-up makes the artifact as a user does: the seeded weights as a run's
checkpoint (weights only, as a model soup stores them), exported by
``export_artifact`` into ``TMPDIR`` with ``chunk`` crystal slots and a
signature for every multiple of the mix's ``signature_step`` node slots
up to the largest chunk the pool can make, then loaded by
``load_artifact``; then one chunk of every signature the window's
requests hold within a generous bound is served, so the window captures
nothing."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from harness import checks, common, traffic, weights, yardsticks
from harness import trace as tr
from reference import model as ref_model
from reference.precision import Precision

# the control calibrate.py reads (the reference in float8 in the
# program's place); a screening cell reads no training faults
CONTROLS = ("float8",)
FAULTS = ()


def _program():
    from cgat_tpu_torch.data.batching import CrystalGraph
    from cgat_tpu_torch.models.cgat import CGATConfig
    from cgat_tpu_torch.serving import export_artifact, load_artifact
    from cgat_tpu_torch.training import TrainerConfig
    return dict(CrystalGraph=CrystalGraph, CGATConfig=CGATConfig,
                export_artifact=export_artifact, load_artifact=load_artifact,
                TrainerConfig=TrainerConfig)


def pool(cell) -> traffic.Crystals:
    return traffic.from_mix(cell.seed, cell.traffic,
                            cell.config["model"]["orig_elem_fea_len"])


class Plan:
    """The crystals of each request, and its chunks' shapes."""

    def __init__(self, cell, crystals):
        tf = cell.traffic
        self.crystals = crystals
        self.request = tf["request"]
        self.chunk = tf["chunk"]
        self.bucket = cell.config["trainer"]["node_bucket"]
        self.seed = cell.seed
        self.per_pass = len(crystals) // self.request
        self._passes: dict = {}
        ys = crystals.target.astype(np.float64)
        self.mean, self.std = float(ys.mean()), float(ys.std(ddof=1))
        largest = int(np.sort(crystals.n_atoms)[-self.chunk:].sum())
        step = int(tf.get("signature_step", self.bucket))
        self.buckets = list(range(step, largest + step, step))
        self.block = int(tf.get("reference_block", self.chunk))

    def idx(self, r: int) -> np.ndarray:
        p, j = divmod(r, self.per_pass)
        if p not in self._passes:
            self._passes[p] = np.random.default_rng(
                [self.seed, p]).permutation(len(self.crystals))
        return self._passes[p][j * self.request:(j + 1) * self.request]

    def chunks(self, r: int) -> list:
        idx = self.idx(r)
        return [idx[i:i + self.chunk] for i in range(0, len(idx), self.chunk)]

    def chunk_shapes(self, idx) -> dict:
        """A chunk's shapes: node slots the smallest signature that holds
        its atoms."""
        sh = traffic.batch_shapes(self.crystals, idx, slots=self.chunk,
                                  node_bucket=self.bucket)
        N = next(b for b in self.buckets if b >= sh["Nr"])
        return {**sh, "N": N, "E": N * self.crystals.max_nbr}

    def sample(self, n_requests: int, k: int) -> list:
        """``k`` requests of the first ``n_requests``, drawn from the seed,
        whose answers are compared."""
        rng = np.random.default_rng([self.seed, 1])
        return sorted(int(r) for r in rng.choice(
            n_requests, size=min(k, n_requests), replace=False))


def export(cell, prog, tmp: str, plan: Plan) -> str:
    """The seeded weights as a run's checkpoint, exported to an artifact;
    returns the artifact's directory."""
    m, t = cell.config["model"], cell.config["trainer"]
    shapes = ref_model.param_shapes(m)
    sd = {k: v.cpu() for k, v in
          weights.make_weights(shapes, cell.seed, cell.device).items()}
    ckpt = os.path.join(tmp, "run", "checkpoints")
    os.makedirs(ckpt)
    torch.save({"model": sd, "step": 0}, os.path.join(ckpt, "best.pt"))
    tcfg = prog["TrainerConfig"](batch_size=t["batch_size"],
                                 node_bucket=t["node_bucket"],
                                 max_nbr=t["max_nbr"], seed=cell.program_seed)
    mcfg = common.model_config(prog["CGATConfig"], m)
    with open(os.path.join(ckpt, "best.json"), "w") as f:
        json.dump({"epoch": 0, "val_mae": 0.0, "best_val": 0.0,
                   "plateau": None, "mean": plan.mean, "std": plan.std,
                   "trainer_config": dataclasses.asdict(tcfg),
                   "model_config": dataclasses.asdict(mcfg)}, f, default=str)
    del sd
    art = os.path.join(tmp, "artifact")
    prog["export_artifact"](os.path.join(tmp, "run"), art,
                            batch_size=plan.chunk, node_buckets=plan.buckets)
    return art


def run(cell) -> dict:
    ph = common.Phases(cell)
    prog = _program()
    dev = torch.device(cell.device)
    if dev.type == "cuda":
        from cgat_tpu_torch.ops.kernels import build
        build.build()
    ph("imports and kernels")
    crystals = pool(cell)
    plan = Plan(cell, crystals)
    graphs = traffic.to_graphs(crystals, prog["CrystalGraph"])
    ph("crystals")
    tmp = tempfile.mkdtemp(prefix="screen-")
    try:
        art = export(cell, prog, tmp, plan)
        server = prog["load_artifact"](art, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ph("export and load")
    # one chunk of every signature the window's requests hold
    bound = common.planned_steps(cell)
    seen = set()
    for r in range(bound):
        for c in plan.chunks(r):
            N = plan.chunk_shapes(c)["N"]
            if N not in seen:
                seen.add(N)
                server.predict([graphs[i] for i in c])
    common.sync(dev)
    ph("warm-up")
    before = common.graphs_held(server.graphs)

    sample = set(sampled(cell, plan))
    kept, latency = {}, []
    holder, steps = {}, []
    with tr.profiled(cell.trace, holder):
        win = common.Window(cell)
        setup_s = win.t_start - cell.t0
        with tr.span(tr.WINDOW, cell.trace):
            r = 0
            while True:
                req = [graphs[i] for i in plan.idx(r)]
                t0 = time.perf_counter()
                with tr.span("predict", cell.trace):
                    pred, _, emb = server.predict(req, return_embeddings=True)
                latency.append(time.perf_counter() - t0)
                if r in sample:
                    kept[r] = (pred, emb)
                if cell.trace:
                    steps += [{**plan.chunk_shapes(c), "training": False}
                              for c in plan.chunks(r)]
                r += 1
                if win.step():
                    break
            window_s = win.close()
    captures = common.graphs_held(server.graphs) - before
    peak = common.memory_peak(dev)
    del server
    common.release(dev)

    out = {"metrics": {
        "predict_graphs_per_s": {"value": plan.request * win.n / window_s,
                                 "unit": "graphs/s"},
        "setup_s": {"value": setup_s, "unit": "s"}},
        "attempted": win.n, "failed": 0, "memory_peak_bytes": peak,
        "window_s": window_s,
        "notes": {"captures_in_window": captures,
                  "compared_requests": sorted(kept),
                  "latency_ms_p50_p95": [
                      float(np.percentile(latency, q)) * 1e3
                      for q in (50, 95)]}}
    if cell.trace:
        view = tr.view_of(holder["prof"], steps, cell.config["model"])
        view.extra["flops"] = sum(yardsticks.model_flops(
            cell.config["model"], st) for st in steps)
        out["view"] = view
    out["numbers"] = compare(cell, crystals, plan, kept)
    return out


def sampled(cell, plan: Plan) -> list:
    """The requests whose answers are compared: ``sample_requests`` of
    those a window surely finishes (the traced window's, or its seconds at
    the mix's ``min_rate``), drawn from the seed."""
    k = int(cell.traffic["sample_requests"])
    due = int(cell.traffic["trace_steps"]) if cell.trace \
        else max(k, int(cell.seconds * cell.traffic["min_rate"]))
    return plan.sample(due, k)


def numbers(cell, precision: str, fault: str | None = None) -> dict:
    """The numbers of the reference in ``precision``, put in the program's
    place, against the f32 reference, on the requests a run compares."""
    crystals = pool(cell)
    plan = Plan(cell, crystals)
    reqs = sampled(cell, plan)
    ref = reference(cell, crystals, plan, reqs)
    low = reference(cell, crystals, plan, reqs, precision)
    return checks.screening_numbers(low["pred"], ref["pred"], low["emb"],
                                    ref["emb"], ref["scale"])


def compare(cell, crystals, plan: Plan, kept: dict,
            precision: str = "float32") -> dict:
    """The sampled requests' predictions and embeddings against the plain
    reference's."""
    common.reference_mode()
    if not kept:
        return {"pred_gap": float("nan"), "emb_gap": float("nan")}
    ref = reference(cell, crystals, plan, sorted(kept), precision)
    pred = np.concatenate([kept[r][0] for r in sorted(kept)])
    emb = np.concatenate([kept[r][1] for r in sorted(kept)])
    return checks.screening_numbers(pred, ref["pred"], emb, ref["emb"],
                                    ref["scale"])


def reference(cell, crystals, plan: Plan, requests: list,
              precision: str = "float32") -> dict:
    """The plain reference's predictions and embeddings of ``requests``'
    crystals, in request order, and each prediction's scale: the norm of
    its gradient with respect to the crystal's embedding times the
    embedding's norm. A crystal's answers depend on it alone, so the
    reference works through each request in blocks of the mix's
    ``reference_block`` crystals, so that it fits on the card."""
    common.reference_mode()
    dev = cell.device
    m = cell.config["model"]
    P = weights.make_weights(ref_model.param_shapes(m), cell.seed, dev)
    net = ref_model.CGAT(m, Precision(precision))
    preds, embs, scales = [], [], []
    blocks = [idx[i:i + plan.block] for idx in map(plan.idx, requests)
              for i in range(0, len(idx), plan.block)]
    for block in blocks:
        b = ref_model.make_batch(crystals, block, dev)
        with torch.no_grad():
            e = net.embed(P, b)
        e.requires_grad_(True)
        out = net.head(P, e)[:, 0]
        g, = torch.autograd.grad(out.sum(), e)
        preds.append((out.detach() * plan.std + plan.mean).cpu())
        embs.append(e.detach().cpu())
        scales.append((g.norm(dim=1) * e.detach().norm(dim=1)
                       * plan.std).cpu())
    cat = lambda xs: torch.cat(xs).numpy()
    return {"pred": cat(preds), "emb": cat(embs), "scale": cat(scales)}
