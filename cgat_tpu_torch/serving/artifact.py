"""Serve a prediction artifact with the port.

Counterpart of ``load_artifact`` / ``ServingModel`` in
``cgat_tpu/serving/artifact.py``. It reads the ``manifest.json`` and
``params.npz`` that ``cgat_tpu.serving.export_artifact`` writes (the JAX
``fn_*.bin`` modules are ignored), rebuilds ``CGAtNet`` from the manifest's
model config, and predicts bucketed, batched and denormalised, on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..data.batching import collate
from ..device import resolve_device
from ..models.cgat import CGATConfig, CGAtNet
from ..models.convert import state_dict_from_jax

_MANIFEST = "manifest.json"
_PARAMS = "params.npz"
_FORMAT = 2        # the manifest layout cgat_tpu's export_artifact writes


def config_from_manifest(manifest: dict) -> CGATConfig:
    """The manifest's model config as the port's ``CGATConfig``: every
    field of the JAX package's config (``no_hyper``, ``update_edges``,
    ``dropout``, ``split_projection`` and the remat flags included) keeps
    its value; a field the port does not know is left out."""
    d = dict(manifest["model_config"])
    d["out_hidden"] = tuple(d.get("out_hidden", ()))
    fields = {f.name for f in dataclasses.fields(CGATConfig)}
    return CGATConfig(**{k: v for k, v in d.items() if k in fields})


class ServingModel:
    """A model ready to serve: bucketed, batched, denormalised prediction.

    ``manifest`` carries ``mean``/``std``, the ``collate`` settings and the
    ``signatures`` table (static batch shapes); ``model`` is a ``CGAtNet``
    already on its device and in its compute dtype.
    """

    def __init__(self, manifest: dict, model: CGAtNet):
        self.manifest = manifest
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.signatures = sorted(manifest["signatures"],
                                 key=lambda s: s["num_node_slots"])
        self.mean = float(manifest["mean"])
        self.std = float(manifest["std"])

    def _pick(self, n_atoms: int) -> dict:
        for sig in self.signatures:
            if sig["num_node_slots"] >= n_atoms:
                return sig
        raise ValueError(
            f"batch needs {n_atoms} node slots but the artifact's largest "
            f"signature has {self.signatures[-1]['num_node_slots']}")

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
                            orig_fea=col["orig_fea"]).to(self.device)
            # one forward gives both the head output and the embedding
            emb = self.model.embed(batch)
            out = self.model.head(emb)
            n = len(chunk)            # real graphs fill the leading slots
            preds.append((out[:n, 0] * self.std + self.mean).cpu().numpy())
            log_stds.append(out[:n, 1].cpu().numpy())
            if return_embeddings:
                embs.append(emb[:n].float().cpu().numpy())
        cat = (lambda xs: np.concatenate(xs) if xs
               else np.zeros((0,), np.float32))
        if return_embeddings:
            return cat(preds), cat(log_stds), cat(embs)
        return cat(preds), cat(log_stds)


def load_artifact(artifact_dir: str, device=None) -> ServingModel:
    """Load an artifact directory onto ``device`` (the CUDA card when None;
    raises if there is none)."""
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
