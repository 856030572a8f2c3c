"""JAX parameter tree <-> the port's (reference-layout) ``state_dict``.

``state_dict_from_jax`` is the port's own copy of the numpy-only mapping in
``cgat_tpu/tools/import_torch.py`` (``export_state_dict``); the port imports
nothing of the JAX package. ``flat_from_state_dict`` is its inverse: the
flat ``a/b/c`` arrays of a serving artifact's ``params.npz`` (the keys
``_flatten_params`` gives in ``cgat_tpu/serving/artifact.py``). Layout
transforms:

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


def _children(keys, prefix: str) -> list[int]:
    """The integer indices ``k`` of the ``{prefix}.{k}...`` keys, sorted."""
    n = len(prefix) + 1
    return sorted({int(k[n:].split(".", 1)[0]) for k in keys
                   if k.startswith(prefix + ".")
                   and k[n:].split(".", 1)[0].isdigit()})


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


def flat_from_state_dict(state_dict: dict) -> dict[str, np.ndarray]:
    """The JAX package's flat parameter arrays (``{"graph_0_Node/MH_A/
    fc_in_kernel": ...}``, float32) of a port ``state_dict``: the inverse
    of :func:`state_dict_from_jax` for every model it maps (``no_hyper``
    either way, ``update_edges=False``, ``split_projection``), every
    transpose and head split undone."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy()
          for k, v in state_dict.items()}
    keys = list(sd)
    flat: dict[str, np.ndarray] = {}

    def put(key: str, arr):
        flat[key] = np.ascontiguousarray(arr, dtype=np.float32)

    def mh(ref: str, ours: str):
        hidden = sd[f"{ref}.fc_out.weight"].shape[1]
        heads = sd[f"{ref}.fc_in.weight"].shape[0] // hidden
        for conv in ("fc_in", "fc_out"):
            w = sd[f"{ref}.{conv}.weight"][:, :, 0]       # (H*out, in)
            put(f"{ours}/{conv}_kernel", w.reshape(heads, -1, w.shape[1]))
            put(f"{ours}/{conv}_bias",
                sd[f"{ref}.{conv}.bias"].reshape(heads, -1))

    def linear(ref: str, ours: str):
        put(f"{ours}/kernel", sd[f"{ref}.weight"].T)
        if f"{ref}.bias" in sd:
            put(f"{ours}/bias", sd[f"{ref}.bias"])

    def simple(ref: str, ours: str):
        for k in _children(keys, f"{ref}.fcs"):
            linear(f"{ref}.fcs.{k}", f"{ours}/fc_{k}")
        linear(f"{ref}.fc_out", f"{ours}/fc_out")

    def fc_block(ref: str, ours: str):
        ks = _children(keys, f"{ref}.net")
        for k in ks[:-1]:
            put(f"{ours}/fc_{k}_kernel", sd[f"{ref}.net.{k}.net.0.weight"].T)
            put(f"{ours}/fc_{k}_bias", sd[f"{ref}.net.{k}.net.0.bias"])
        put(f"{ours}/fc_last_kernel", sd[f"{ref}.net.{ks[-1]}.weight"].T)
        put(f"{ours}/fc_last_bias", sd[f"{ref}.net.{ks[-1]}.bias"])

    def pooling(ref: str, ours: str):
        layers = _children(keys, f"{ref}.Hyper.layers")
        if not layers:
            simple(ref, ours)
            return
        for j in layers[:-1]:
            fc_block(f"{ref}.Hyper.layers.{j}.hyper_linear.hypo_params",
                     f"{ours}/Hyper/layer_{j}/hypo_params")
        fc_block(f"{ref}.Hyper.layers.{layers[-1]}.hypo_params",
                 f"{ours}/Hyper/layer_last/hypo_params")
        if f"{ref}.damping" in sd:
            put(f"{ours}/damping", sd[f"{ref}.damping"])

    def gat(ref: str, ours: str):
        mh(f"{ref}.MH_A", f"{ours}/MH_A")
        mh(f"{ref}.MH_M", f"{ours}/MH_M")
        if any(k.startswith(f"{ref}.Pooling_NN.") for k in keys):
            pooling(f"{ref}.Pooling_NN", f"{ours}/Pooling_NN")

    linear("embedding", "embedding")
    put("nbr_embedding/embedding", sd["nbr_embedding.weight"])
    for i in _children(keys, "graphs"):
        for kind in ("Node", "Edge"):
            if f"graphs.{i}.{kind}.MH_A.fc_in.weight" in sd:
                gat(f"graphs.{i}.{kind}", f"graph_{i}_{kind}")
    linear("roost.embedding", "roost/embedding")
    for i in _children(keys, "roost.graphs"):
        pool = f"roost.graphs.{i}.pooling.0"
        simple(f"{pool}.gate_nn", f"roost/graph_{i}/head0_gate_nn")
        simple(f"{pool}.message_nn", f"roost/graph_{i}/head0_message_nn")
        put(f"roost/graph_{i}/head0_pow", sd[f"{pool}.pow"])
    simple("roost.cry_pool.0.gate_nn", "roost/cry_pool0_gate_nn")
    put("roost/cry_pool0_pow", sd["roost.cry_pool.0.pow"])
    gat("cry_pool", "cry_pool")
    for k in _children(keys, "output_nn.fcs"):
        linear(f"output_nn.fcs.{k}", f"output_nn/fc_{k}")
    for k in _children(keys, "output_nn.res_fcs"):
        linear(f"output_nn.res_fcs.{k}", f"output_nn/res_fc_{k}")
    for k in _children(keys, "output_nn.rezeros"):
        put(f"output_nn/rezero_{k}/alpha", sd[f"output_nn.rezeros.{k}.alpha"])
    linear("output_nn.fc_out", "output_nn/fc_out")
    if len(flat) != len(sd):
        raise ValueError(f"{len(sd) - len(flat)} state_dict entries have no "
                         f"place in the JAX parameter tree")
    return flat
