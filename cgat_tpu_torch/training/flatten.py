"""The optimizer over the small parameters flattened, counterpart of
``cgat_tpu/training/flatten.py`` (``flatten_small``).

The reference-default model has 375 parameter tensors, ~300 of them small
(biases, the hypernetworks' FCBlock layers, ReZero scalars) and holding
~4 % of the elements. Each ``_foreach`` op of the optimizer runs over
every tensor of its lists, so the small ones cost launches and host time
for little work. As in the JAX package, parameters of at most
``DEFAULT_MAX_ELEMS`` elements are "small": they are gathered into one
flat vector per dtype (in sorted dtype-name order, each in parameter
order), and the big ones are left as they are. In PyTorch's idiom the
small parameters become views into their flat vector, so the optimizer
updates the vector and the parameters see it with no copy back.

Their gradients are concatenated into one flat gradient per dtype once a
step (``torch.cat``: a few launches), not accumulated into views of a
flat buffer: autograd would then add each small gradient into its view
with a launch of its own, ~300 a step.

Valid for elementwise updates (SGD, Adam, AdamW, with a uniform weight
decay): each element's update does not depend on where the tensors are
cut, so the result is bit-exact against the optimizer on the parameters
as they are, and ``make_optimizer`` always flattens them (not under
``only_residual``, as in the JAX package). Not valid for LAMB, whose
trust ratio is per tensor; ``make_optimizer`` does not flatten it. The
optimizer's ``state_dict`` keeps the per-parameter layout, so a
checkpoint of a flat run and of a plain one have the same format and load
into either.
"""
from __future__ import annotations

import torch

from .optim import _Params, _dtype_name

# parameters of at most this many elements are flattened (the JAX
# package's threshold: at the reference defaults 72 big tensors, 96 % of
# the elements, stay as they are)
DEFAULT_MAX_ELEMS = 65536


class FlatLayout:
    """The small parameters of ``params`` made views into one flat vector
    per dtype (``flat``, in sorted dtype-name order); ``big`` keeps the
    others. ``inner`` is what the wrapped optimizer runs over: the flat
    vectors, then the big parameters."""

    def __init__(self, params):
        params = list(params)
        self.n = len(params)
        self.big = [i for i, p in enumerate(params)
                    if p.numel() > DEFAULT_MAX_ELEMS]
        groups: dict[str, list[int]] = {}
        for i, p in enumerate(params):
            if p.numel() <= DEFAULT_MAX_ELEMS:
                groups.setdefault(_dtype_name(p.dtype), []).append(i)
        self.groups = [groups[k] for k in sorted(groups)]
        self.shapes = [p.shape for p in params]
        self.flat = []
        with torch.no_grad():
            for idx in self.groups:
                vec = torch.cat([params[i].detach().reshape(-1) for i in idx])
                for i, view in zip(idx, self._cut(vec, idx)):
                    params[i].data = view
                self.flat.append(vec)
        self.inner = self.flat + [params[i] for i in self.big]

    def _cut(self, vec, idx) -> list[torch.Tensor]:
        """``vec`` cut into views shaped as the parameters ``idx``."""
        sizes = [self.shapes[i].numel() for i in idx]
        return [v.view(self.shapes[i])
                for i, v in zip(idx, torch.split(vec, sizes))]

    def flatten(self, tensors) -> list[torch.Tensor]:
        """Per-parameter tensors (gradients) in the inner layout: each
        group concatenated, then the big ones."""
        return ([torch.cat([tensors[i].reshape(-1) for i in idx])
                 for idx in self.groups]
                + [tensors[i] for i in self.big])

    def unflatten(self, inner) -> list[torch.Tensor]:
        """Inner-layout tensors as per-parameter views, in parameter
        order."""
        out: list = [None] * self.n
        for idx, vec in zip(self.groups, inner):
            for i, view in zip(idx, self._cut(vec, idx)):
                out[i] = view
        for i, t in zip(self.big, inner[len(self.groups):]):
            out[i] = t
        return out


class FlatOptimizer(_Params):
    """``inner``, an elementwise optimizer built over ``layout.inner``,
    driven through the parameters as they are (``flatten_small``):
    ``update`` takes per-parameter gradients, ``state_dict`` gives and
    ``load_state_dict`` takes per-parameter state."""

    def __init__(self, params, inner, layout: FlatLayout):
        super().__init__(params)
        self.inner = inner
        self.layout = layout

    @property
    def lr(self) -> float:
        return self.inner.lr

    @lr.setter
    def lr(self, value: float) -> None:
        self.inner.lr = value

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def apply(self) -> None:
        """The update for the parameters' ``.grad``; ``reduce`` sums the
        flat gradients (one tensor a dtype, then the big ones) over the
        ranks, not the per-parameter ones."""
        self.update(self._grads())

    @torch.no_grad()
    def update(self, grads) -> None:
        flat = self.layout.flatten(grads)
        if self.reduce is not None:
            self.reduce(flat)
        self.inner.update(flat)

    def _per_param(self) -> dict:
        """The inner optimizer's state lists as per-parameter views."""
        return {name: self.layout.unflatten(getattr(self.inner, name))
                for name in self.inner._STATE}

    def state_dict(self) -> dict:
        return self.inner.state_dict(self._per_param())

    def load_state_dict(self, state: dict) -> None:
        """Checked as the inner optimizer checks its own, and copied into
        the views of its flat state."""
        self.inner.load_state_dict(state, self._per_param())
