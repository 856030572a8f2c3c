"""AdamW as ``optax.adamw`` computes it, and the damping projection.

torch's AdamW has no low-precision first moment, and its arithmetic order
differs from optax's, so the port writes the update out with
``torch._foreach_*`` ops, in optax's order (``scale_by_adam`` ->
``add_decayed_weights`` -> ``scale_by_learning_rate``):

    mu  = (1 - b1) * g + b1 * mu         (b1 * mu rounded to mu's dtype)
    nu  = (1 - b2) * g**2 + b2 * nu      (f32)
    u   = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
    p  += -lr * (u + weight_decay * p)

with mu stored in ``mu_dtype`` (bf16 in the CLI's production profile) after
the update is formed from its f32 value, as optax does. A parameter that
got no gradient is updated as if its gradient were zero, as JAX's are.
"""
from __future__ import annotations

import numpy as np
import torch


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay=..., mu_dtype=...)`` over
    a list of parameters; ``lr`` may be set between steps."""

    def __init__(self, params, lr: float, *, weight_decay: float = 1e-4,
                 mu_dtype: torch.dtype = torch.float32, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr = lr
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=mu_dtype)
                       for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self._zeros: dict[int, torch.Tensor] = {}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> list[torch.Tensor]:
        grads = []
        for i, p in enumerate(self.params):
            if p.grad is None:
                if i not in self._zeros:
                    self._zeros[i] = torch.zeros_like(p)
                grads.append(self._zeros[i])
            else:
                grads.append(p.grad)
        return grads

    def _bias_correction(self, decay: float) -> float:
        """``1 - decay**count`` in f32, as optax computes it."""
        return float(np.float32(1) - np.float32(decay) ** np.int32(self.count))

    def state_dict(self) -> dict:
        """The optimizer's state: the update count and both moments (the
        learning rate is set per epoch and is not part of it)."""
        return {"step": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore what ``state_dict`` gave. The first moment's dtype must
        be this optimizer's: a checkpoint written with another
        ``--moment-dtype`` raises rather than changing it."""
        mu, nu = state["mu"], state["nu"]
        if len(mu) != len(self.mu) or len(nu) != len(self.nu):
            raise ValueError(f"optimizer state holds {len(mu)} moments, "
                             f"this model has {len(self.mu)} parameters")
        names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
        have = {m.dtype for m in mu}
        want = self.mu[0].dtype if self.mu else None
        if self.mu and have != {want}:
            got = ", ".join(sorted(names.get(d, str(d)) for d in have))
            raise ValueError(
                f"the checkpoint's first moment (mu) is {got} but this run "
                f"keeps it in {names.get(want, str(want))}; resume with "
                f"--moment-dtype {got} (TrainerConfig.moment_dtype)")
        for own, new in zip(self.mu + self.nu, list(mu) + list(nu)):
            if own.shape != new.shape:
                raise ValueError(f"optimizer moment of shape "
                                 f"{tuple(new.shape)} for a parameter of "
                                 f"shape {tuple(own.shape)}")
            own.copy_(new)
        self.count = int(state["step"])

    @torch.no_grad()
    def step(self) -> None:
        grads = self._grads()
        self.count += 1
        bc1 = self._bias_correction(self.b1)
        bc2 = self._bias_correction(self.b2)
        torch._foreach_mul_(self.mu, self.b1)
        mu = torch._foreach_mul(grads, 1 - self.b1)
        torch._foreach_add_(mu, self.mu)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, g2)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, den)
        torch._foreach_add_(update,
                            torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(update, -self.lr)
        torch._foreach_add_(self.params, update)
        torch._foreach_copy_(self.mu, mu)


@torch.no_grad()
def project_params(model: torch.nn.Module) -> None:
    """Clamp every HNet ``damping`` into [0, 1] after an update: the
    reference clamps it in place at each forward (projected gradient,
    Hypernetworksmp.py:309-313), and the forward's straight-through clip
    already uses the clamped value."""
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] == "damping":
            p.clamp_(0.0, 1.0)
