"""Seeded f32 weights made on the device in two draws: one uniform and one
normal vector for all the parameters, cut and scaled by the rules of the
port's initialiser (``models/init.py``, the reference's PyTorch
defaults): ReZero ``alpha`` 0; ``damping`` U[0, 1); ``pow`` and the
neighbour embedding N(0, 1); a bias U(+-1/sqrt(fan_in)) of its weight;
hypernetwork weights N(0, 2/fan_in), the last Linear of each scaled by
0.1; every other weight U(+-1/sqrt(fan_in)). The same seed gives the same
tensors, so the reference gets the program's starting weights by drawing
them again."""
from __future__ import annotations

import math
import re

import torch

_HYPER_LAST = re.compile(r"hypo_params\.net\.\d+\.weight$")


def _rule(name: str, shape, shapes) -> tuple[str, float, float]:
    """(draw, scale, shift) of a parameter: value = draw * scale + shift,
    draw "zero", "uniform" (U[0, 1)) or "normal"."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "alpha" and ".rezeros." in f".{name}":
        return "zero", 0.0, 0.0
    if leaf == "damping":
        return "uniform", 1.0, 0.0
    if leaf == "pow" or name == "nbr_embedding.weight":
        return "normal", 1.0, 0.0
    if leaf == "bias":
        bound = 1.0 / math.sqrt(shapes[name[:-len("bias")] + "weight"][1])
        return "uniform", 2 * bound, -bound
    if leaf == "weight":
        fan_in = shape[1]
        if "hypo_params" in name:
            s = math.sqrt(2.0 / fan_in) * (0.1 if _HYPER_LAST.search(name)
                                           else 1.0)
            return "normal", s, 0.0
        bound = 1.0 / math.sqrt(fan_in)
        return "uniform", 2 * bound, -bound
    raise ValueError(f"no init rule for parameter {name} {tuple(shape)}")


def make_weights(shapes: dict, seed: int, device) -> dict:
    """name -> f32 tensor on ``device`` for every entry of ``shapes``."""
    rules = {k: _rule(k, s, shapes) for k, s in shapes.items()}
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    total = {d: sum(sizes[k] for k, r in rules.items() if r[0] == d)
             for d in ("uniform", "normal")}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    draws = {"uniform": torch.rand(total["uniform"], generator=gen,
                                   device=device),
             "normal": torch.randn(total["normal"], generator=gen,
                                   device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for k, shape in shapes.items():
        kind, scale, shift = rules[k]
        if kind == "zero":
            out[k] = torch.zeros(shape, device=device)
            continue
        v = draws[kind][at[kind]:at[kind] + sizes[k]]
        at[kind] += sizes[k]
        out[k] = (v * scale + shift).view(shape) if (scale, shift) != (1, 0) \
            else v.view(shape).clone()
    return out
