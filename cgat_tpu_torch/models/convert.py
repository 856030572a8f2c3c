"""JAX parameter tree -> the port's (reference-layout) ``state_dict``.

The port's own copy of the numpy-only mapping in
``cgat_tpu/tools/import_torch.py`` (``export_state_dict``); the port imports
nothing of the JAX package. Layout transforms:

* flax kernels are ``(in, out)``; ``nn.Linear.weight`` is ``(out, in)``;
* MultiHeadNetwork kernels ``(H, out, in)`` become the grouped Conv1d
  weight ``(H*out, in, 1)``;
* flax module names map to the reference's attributes (``graph_{i}_Node``
  -> ``graphs.{i}.Node``, ``layer_{j}`` / ``layer_last`` ->
  ``layers.{j}[.hyper_linear]``, ``fc_{k}_kernel`` -> ``net.{k}.net.0``, ...).

An ``update_edges=False`` model has no reference layout (the reference's
branch for it cannot run, CGAT.py:406-425, so the JAX package's exporter
refuses it). The port defines its own: ``graphs.{i}.Node`` as in every
model and no ``graphs.{i}.Edge`` module, which is what JAX's node-only
tree (``graph_{i}_Node`` and no ``graph_{i}_Edge``) maps to.
"""
from __future__ import annotations

import numpy as np
import torch


def _unflatten(flat: dict) -> dict:
    """``{"a/b/c": array}`` (the serving artifact's ``params.npz``) -> tree."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _np(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(_np(w).T)


def state_dict_from_jax(params: dict, cfg) -> dict:
    """The port's ``state_dict`` (float32 tensors) for a JAX parameter tree,
    given as a nested dict or as flat ``a/b/c`` keys, of numpy arrays."""
    if any("/" in k for k in params):
        params = _unflatten(params)
    sd: dict[str, np.ndarray] = {}

    def mh(ours: dict, ref: str):
        for conv in ("fc_in", "fc_out"):
            k = _np(ours[f"{conv}_kernel"])               # (H, out, in)
            h, out, i = k.shape
            sd[f"{ref}.{conv}.weight"] = k.reshape(h * out, i)[:, :, None]
            sd[f"{ref}.{conv}.bias"] = _np(ours[f"{conv}_bias"]).reshape(h * out)

    def linear(ours: dict, ref: str):
        sd[f"{ref}.weight"] = _t(ours["kernel"])
        if "bias" in ours:
            sd[f"{ref}.bias"] = _np(ours["bias"])

    def simple(ours: dict, ref: str):
        for key in ours:
            if key == "fc_out":
                linear(ours[key], f"{ref}.fc_out")
            else:                                         # fc_{k}
                linear(ours[key], f"{ref}.fcs.{key[3:]}")

    def fc_block(ours: dict, ref: str):
        ks = sorted(int(k[3:-7]) for k in ours
                    if k.startswith("fc_") and k.endswith("_kernel")
                    and k != "fc_last_kernel")
        for k in ks:
            sd[f"{ref}.net.{k}.net.0.weight"] = _t(ours[f"fc_{k}_kernel"])
            sd[f"{ref}.net.{k}.net.0.bias"] = _np(ours[f"fc_{k}_bias"])
        sd[f"{ref}.net.{len(ks)}.weight"] = _t(ours["fc_last_kernel"])
        sd[f"{ref}.net.{len(ks)}.bias"] = _np(ours["fc_last_bias"])

    def pooling(ours: dict, ref: str):
        if "Hyper" not in ours:
            simple(ours, ref)
            return
        hyper = ours["Hyper"]
        n = sum(1 for k in hyper if k.startswith("layer_")
                and k != "layer_last")
        for j in range(n):
            fc_block(hyper[f"layer_{j}"]["hypo_params"],
                     f"{ref}.Hyper.layers.{j}.hyper_linear.hypo_params")
        fc_block(hyper["layer_last"]["hypo_params"],
                 f"{ref}.Hyper.layers.{n}.hypo_params")
        if "damping" in ours:
            sd[f"{ref}.damping"] = _np(ours["damping"])

    def gat(ours: dict, ref: str):
        mh(ours["MH_A"], f"{ref}.MH_A")
        mh(ours["MH_M"], f"{ref}.MH_M")
        if "Pooling_NN" in ours:
            pooling(ours["Pooling_NN"], f"{ref}.Pooling_NN")

    linear(params["embedding"], "embedding")
    sd["nbr_embedding.weight"] = _np(params["nbr_embedding"]["embedding"])
    for i in range(cfg.n_graph):
        gat(params[f"graph_{i}_Node"], f"graphs.{i}.Node")
        if cfg.update_edges:
            gat(params[f"graph_{i}_Edge"], f"graphs.{i}.Edge")
        elif f"graph_{i}_Edge" in params:
            raise ValueError(f"update_edges=False but the parameter tree "
                             f"has graph_{i}_Edge")
    roost = params["roost"]
    linear(roost["embedding"], "roost.embedding")
    i = 0
    while f"graph_{i}" in roost:
        g = roost[f"graph_{i}"]
        simple(g["head0_gate_nn"], f"roost.graphs.{i}.pooling.0.gate_nn")
        simple(g["head0_message_nn"],
               f"roost.graphs.{i}.pooling.0.message_nn")
        sd[f"roost.graphs.{i}.pooling.0.pow"] = _np(g["head0_pow"])
        i += 1
    simple(roost["cry_pool0_gate_nn"], "roost.cry_pool.0.gate_nn")
    sd["roost.cry_pool.0.pow"] = _np(roost["cry_pool0_pow"])
    gat(params["cry_pool"], "cry_pool")
    out_nn = params["output_nn"]
    for key in out_nn:
        if key == "fc_out":
            linear(out_nn[key], "output_nn.fc_out")
        elif key.startswith("res_fc_"):
            linear(out_nn[key], f"output_nn.res_fcs.{key[7:]}")
        elif key.startswith("rezero_"):
            sd[f"output_nn.rezeros.{key[7:]}.alpha"] = _np(
                out_nn[key]["alpha"])
        else:                                             # fc_{k}
            linear(out_nn[key], f"output_nn.fcs.{key[3:]}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
