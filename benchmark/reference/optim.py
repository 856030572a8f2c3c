"""AdamW and Adam (optax's arithmetic) over a dict of f32 tensors, in
place, with the damping projection the trainer applies after each
update."""
from __future__ import annotations

import torch


class AdamW:
    """``optax.adamw``: p -= lr * (mhat / (sqrt(vhat) + eps) + wd * p);
    with ``decoupled=False``, Adam with the weight decay added to the
    gradient (``optax.chain(add_decayed_weights, adam)``)."""

    def __init__(self, params: dict, lr: float, weight_decay: float = 0.0,
                 b1=0.9, b2=0.999, eps=1e-8, decoupled=True):
        self.params = params
        self.lr, self.wd, self.decoupled = lr, weight_decay, decoupled
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        """One update; a parameter missing from ``grads`` has a zero
        gradient."""
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads.get(k)
            g = torch.zeros_like(p) if g is None else g
            if not self.decoupled and self.wd:
                g = g + self.wd * p
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            if self.decoupled:
                u = u + self.wd * p
            p.add_(-self.lr * u)
            if k.endswith(".damping"):
                p.clamp_(0.0, 1.0)


def grads_of(loss, params: dict) -> dict:
    """d loss / d each parameter (None where it does not reach one)."""
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys],
                             allow_unused=True)
    return {k: g for k, g in zip(keys, gs) if g is not None}
