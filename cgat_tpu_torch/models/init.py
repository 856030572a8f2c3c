"""Seeded parameter initialisation with numpy, without JAX.

Follows the JAX package's host initialiser (``cgat_tpu/models/host_init.py``)
rule by rule, on the port's reference-layout parameter names:

* ReZero ``alpha``: zeros;
* ``damping``: U[0, 1) (torch.rand);
* ``pow``: N(0, 1) (torch.randn);
* ``nbr_embedding.weight``: N(0, 1) (nn.Embedding);
* every bias: U(+-1/sqrt(fan_in)) with its weight's fan-in;
* hypernetwork (``hypo_params``) weights: kaiming normal, N(0, 2/fan_in),
  the FCBlock's last Linear additionally scaled by 0.1;
* every other weight (Linear, grouped Conv1d): U(+-1/sqrt(fan_in)).

The fan-in of a Linear ``(out, in)`` or grouped Conv1d ``(H*out, in, 1)``
weight is ``shape[1]``. The values follow the same distributions as the JAX
initialiser but are drawn in another order, so they are not the same
numbers.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_HYPER_LAST = re.compile(r"hypo_params\.net\.\d+\.weight$")


def _sample(rng: np.random.Generator, name: str, shape, params) -> np.ndarray:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "alpha" and ".rezeros." in f".{name}":
        return np.zeros(shape)
    if leaf == "damping":
        return rng.random(shape)
    if leaf == "pow":
        return rng.standard_normal(shape)
    if name == "nbr_embedding.weight":
        return rng.standard_normal(shape)
    if leaf == "bias":
        fan_in = params[name[:-len("bias")] + "weight"].shape[1]
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape)
    if leaf == "weight":
        fan_in = shape[1]
        if "hypo_params" in name:
            w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            return w * 0.1 if _HYPER_LAST.search(name) else w
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape)
    raise ValueError(f"no init rule for parameter {name} {tuple(shape)}")


def init_state_dict(model: torch.nn.Module, seed: int = 0) -> dict:
    """A float32 ``state_dict`` for ``model`` drawn from
    ``np.random.default_rng(seed)``; load it with ``strict=True``."""
    rng = np.random.default_rng(seed)
    params = dict(model.state_dict())
    return {name: torch.from_numpy(
                _sample(rng, name, tuple(p.shape), params).astype(np.float32))
            for name, p in params.items()}
