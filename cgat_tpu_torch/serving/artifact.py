"""Export a trained run as a prediction artifact, and serve one, with the
port.

Counterpart of ``cgat_tpu/serving/artifact.py``. ``export_artifact`` turns
a port run directory (``checkpoints/{tag}.pt`` and ``{tag}.json``) into the
artifact layout that ``cgat_tpu.serving.export_artifact`` writes:
``params.npz`` (the f32 master weights as the JAX package's flat
``a/b/c`` arrays) and a ``manifest.json`` of format 2 with the
normalisation, the model and collate config, the signature table and the
source run. It lowers no StableHLO module: every signature's ``files`` is
empty and ``platforms`` names where the port serves (``cuda``, ``cpu``),
so ``cgat_tpu.serving.load_artifact`` refuses such an artifact with its
own "artifact was lowered for ..." error. ``load_artifact`` reads both
kinds (the JAX ``fn_*.bin`` modules are ignored), rebuilds ``CGAtNet``
from the manifest's model config, and predicts bucketed, batched and
denormalised, on the card unless the caller asks for the CPU.

On the card each signature's forward (embed and head, returning the
prediction, ``log_std`` and the graph embedding) is a CUDA graph, the
counterpart of the JAX package's pre-lowered executable a signature, kept
in the port's one graph cache (``training.dispatch.StepGraphs``): the
first request of a signature runs eagerly (the warm-up, whose result is
kept), then the forward is captured once into static input buffers;
every later request of that signature copies its collated batch into the
buffers and replays the graph, so no Python model graph runs on the hot
path. Graphs are keyed on every field's shape of the
collated batch and share one memory pool a ``ServingModel``, released
when the model is dropped. A failed capture or replay raises: the card
never falls back to eager serving. On the CPU serving is eager.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch

from ..data.batching import CrystalBatch, collate
from ..device import resolve_device
from ..models.cgat import CGATConfig, CGAtNet
from ..models.convert import flat_from_state_dict, state_dict_from_jax
from ..training.dispatch import StepGraphs
from ..utils.profiling import annotate, annotated

_MANIFEST = "manifest.json"
_PARAMS = "params.npz"
_FORMAT = 2        # the manifest layout cgat_tpu's export_artifact writes
PLATFORMS = ("cuda", "cpu")     # where the port serves an artifact
# the JAX package's default when a trainer config leaves the composition
# slots to the data (the CLIs' --num-comp-slots default)
_DEFAULT_COMP_SLOTS = 12


def config_from_manifest(manifest: dict) -> CGATConfig:
    """The manifest's model config as the port's ``CGATConfig``: every
    field of the JAX package's config (``no_hyper``, ``update_edges``,
    ``dropout``, ``split_projection`` and the remat flags included) keeps
    its value; a field the port does not know is left out."""
    d = dict(manifest["model_config"])
    d["out_hidden"] = tuple(d.get("out_hidden", ()))
    fields = {f.name for f in dataclasses.fields(CGATConfig)}
    return CGATConfig(**{k: v for k, v in d.items() if k in fields})


def _sig_key(num_graphs: int, num_node_slots: int) -> str:
    return f"c{num_graphs}_n{num_node_slots}"


def export_artifact(run_dir: str, out_dir: str, *, tag: str = "best",
                    batch_size: int | None = None,
                    node_buckets: Sequence[int] | None = None,
                    platforms: Sequence[str] = PLATFORMS) -> dict:
    """Export a port run directory into a serving artifact; returns the
    manifest. ``node_buckets``: the signatures' node-slot counts, each with
    ``E = N * max_nbr`` edge slots (the featuriser gives every atom
    ``max_nbr`` neighbours); {1, 2, 4} x the trainer's node bucket by
    default. ``platforms`` is recorded; one the port cannot serve on
    raises."""
    from ..training.trainer import CheckpointManager, TrainerConfig, \
        _config_from

    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(
            f"the port serves on {', '.join(PLATFORMS)}, not on "
            f"{', '.join(bad)}; export an artifact for {', '.join(bad)} with "
            f"python -m cgat_tpu.cli.export")
    state_dict, meta = CheckpointManager.load(run_dir, tag=tag,
                                              map_location="cpu")
    tcfg = _config_from(TrainerConfig, meta["trainer_config"])
    mcfg = _config_from(CGATConfig, meta["model_config"])
    C = int(batch_size or tcfg.batch_size)
    if node_buckets is None:
        node_buckets = (tcfg.node_bucket, 2 * tcfg.node_bucket,
                        4 * tcfg.node_bucket)
    R = int(tcfg.num_comp_slots or _DEFAULT_COMP_SLOTS)
    max_nbr = int(tcfg.max_nbr)
    sigs = [{"key": _sig_key(C, n), "num_graphs": C, "num_node_slots": n,
             "num_edge_slots": n * max_nbr, "num_comp_slots": R,
             "files": {}}
            for n in sorted({int(n) for n in node_buckets})]
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, _PARAMS),
                        **flat_from_state_dict(state_dict))
    manifest = {
        "format": _FORMAT,
        "mean": float(meta["mean"]), "std": float(meta["std"]),
        "model_config": dataclasses.asdict(mcfg),
        "collate": {"max_nbr": max_nbr, "num_comp_slots": R,
                    "orig_fea": int(mcfg.orig_elem_fea_len),
                    "node_bucket": tcfg.node_bucket,
                    "fea_path": tcfg.fea_path, "target": tcfg.target},
        "platforms": list(platforms),
        "signatures": sigs,
        "source_run": os.path.abspath(run_dir),
        "checkpoint_tag": tag,
        "checkpoint_epoch": meta.get("epoch"),
        "val_mae": meta.get("val_mae"),
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServingModel:
    """A model ready to serve: bucketed, batched, denormalised prediction.

    ``manifest`` carries ``mean``/``std``, the ``collate`` settings and the
    ``signatures`` table (static batch shapes); ``model`` is a ``CGAtNet``
    already on its device and in its compute dtype. On a card each
    signature's forward is a replayed CUDA graph (``graphs``); on the CPU
    it is eager (``graphs`` is None).
    """

    def __init__(self, manifest: dict, model: CGAtNet):
        self.manifest = manifest
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.signatures = sorted(manifest["signatures"],
                                 key=lambda s: s["num_node_slots"])
        self.mean = float(manifest["mean"])
        self.std = float(manifest["std"])
        self.graphs = (StepGraphs(self.device)
                       if self.device.type == "cuda" else None)

    def _pick(self, n_atoms: int) -> dict:
        for sig in self.signatures:
            if sig["num_node_slots"] >= n_atoms:
                return sig
        raise ValueError(
            f"batch needs {n_atoms} node slots but the artifact's largest "
            f"signature has {self.signatures[-1]['num_node_slots']}")

    def forward(self, batch: CrystalBatch) -> tuple:
        """One batch on the device: the denormalised prediction, ``log_std``
        and the f32 graph embedding of every graph slot."""
        emb = self.model.embed(batch)
        out = self.model.head(emb)
        return out[:, 0] * self.std + self.mean, out[:, 1], emb.float()

    def _run(self, batch: CrystalBatch) -> tuple:
        if self.graphs is None:
            return self.forward(batch.to(self.device))
        return self.graphs.run(self.forward, batch)

    @annotated("predict")
    @torch.inference_mode()
    def predict(self, graphs, *, return_embeddings: bool = False):
        """Denormalised predictions and ``log_std`` (and graph embeddings)
        in input order; tail batches are padded, so every crystal gets a
        prediction. ``graphs``: list of ``CrystalGraph``."""
        col = self.manifest["collate"]
        C = self.signatures[0]["num_graphs"]
        preds, log_stds, embs = [], [], []
        for i in range(0, len(graphs), C):
            chunk = graphs[i:i + C]
            sig = self._pick(sum(g.n_atoms for g in chunk))
            batch = collate(chunk,
                            num_graphs=sig["num_graphs"],
                            num_node_slots=sig["num_node_slots"],
                            num_edge_slots=sig["num_edge_slots"],
                            num_comp_slots=sig["num_comp_slots"],
                            max_nbr=col["max_nbr"],
                            orig_fea=col["orig_fea"])
            pred, log_std, emb = self._run(batch)
            n = len(chunk)            # real graphs fill the leading slots
            with annotate("readback"):
                preds.append(pred[:n].cpu().numpy())
                log_stds.append(log_std[:n].cpu().numpy())
                if return_embeddings:
                    embs.append(emb[:n].cpu().numpy())
        cat = (lambda xs: np.concatenate(xs) if xs
               else np.zeros((0,), np.float32))
        if return_embeddings:
            return cat(preds), cat(log_stds), cat(embs)
        return cat(preds), cat(log_stds)


def load_artifact(artifact_dir: str, device=None) -> ServingModel:
    """Load an artifact directory (written by this module's or
    cgat_tpu's ``export_artifact``) onto ``device`` (the CUDA card when
    None; raises if there is none)."""
    device = resolve_device(device)
    with open(os.path.join(artifact_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"unknown artifact format {manifest.get('format')}")
    cfg = config_from_manifest(manifest)
    with np.load(os.path.join(artifact_dir, _PARAMS)) as z:
        flat = {k: z[k] for k in z.files}
    model = CGAtNet(cfg)
    model.load_state_dict(state_dict_from_jax(flat, cfg), strict=True)
    return ServingModel(manifest, model.to_compute_dtype().to(device))
