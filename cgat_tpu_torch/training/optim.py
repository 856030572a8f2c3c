"""The optimizers as optax computes them, and the damping projection.

torch's optimizers have no low-precision first moment, and their
arithmetic order differs from optax's, so the port writes each update out
with ``torch._foreach_*`` ops in the order of the JAX package's optax
chain (``cgat_tpu/training/trainer.py`` ``make_optimizer``):

* ``AdamW`` (``optax.adamw``: ``scale_by_adam`` -> ``add_decayed_weights``
  -> ``scale_by_learning_rate``)::

      mu  = (1 - b1) * g + b1 * mu         (b1 * mu rounded to mu's dtype)
      nu  = (1 - b2) * g**2 + b2 * nu      (f32)
      u   = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
      p  += -lr * (u + weight_decay * p)

  with mu stored in ``mu_dtype`` (bf16 in the CLI's production profile)
  after the update is formed from its f32 value, as optax does;
* ``Adam`` (``add_decayed_weights`` -> ``optax.adam``): the same ``u`` of
  ``g + weight_decay * p``, and ``p += -lr * u``;
* ``SGD`` (``optax.sgd`` with momentum: a trace, not Nesterov, behind
  ``add_decayed_weights`` when ``weight_decay != 0``)::

      t  = g + momentum * t;   p += -lr * t

* ``LAMB`` (``cgat_tpu/training/lamb.py``): no bias correction, eps
  inside, weight decay added to the Adam step, and a per-tensor trust
  ratio with the weight norm clamped to [0, 10] (1.0 where either norm
  is 0)::

      m = b1 * m + (1 - b1) * g;   v = b2 * v + (1 - b2) * g * g
      s = m / (sqrt(v) + eps) + weight_decay * p
      p += (-lr * clip(|p|, 0, 10) / (|s| + eps)) * s

* ``MultiSteps`` (``optax.MultiSteps``, the trainer's ``acc_batches``):
  a running mean of the gradients, ``acc += (g - acc) / (n + 1)``, handed
  to the inner optimizer every k-th mini-step; the other mini-steps leave
  the parameters as they are.

A parameter that got no gradient is updated as if its gradient were
zero, as JAX's are. Each optimizer's ``state_dict`` holds its count and
its per-parameter state; ``load_state_dict`` refuses state of another
optimizer, length, shape or dtype.

What changes from one step to the next and enters the arithmetic, the
update count (so Adam's bias corrections) and the learning rate, lives on
the parameters' device as 0-dim tensors (the count int32, as optax keeps
it, the learning rate f32), so that a CUDA graph of the step (every
``Trainer.train_step`` on the card) reads each step's values when it is
replayed: the count is advanced on the device, and the learning rate is
set between steps with ``fill_``. The constants (b1, b2, eps, momentum,
weight decay) stay Python scalars: a 0-dim f32 tensor multiplied into a
bf16 first moment could round it first. ``step`` is ``apply`` (the work on
the device) then ``advance`` (the host's bookkeeping: ``MultiSteps``'
mini-step); ``phase`` is what the device work branches on, on the host.

On the card AdamW's update is one hand-written pass
(``ops/kernels/adamw.py``, ``csrc/adamw.cu``) that reads g, p, mu and nu
once and writes p, mu and nu once, with the ``_foreach`` sequence's f32
operations in its order, so the same bits; the ``_foreach`` sequence
(``AdamW.update_plain``) is its plain version and the path of CPU
tensors. :func:`fused_stats` counts the pass's launches and the elements
they updated (a replayed CUDA graph counts what its capture launched).
Adam, SGD and LAMB stay ``_foreach`` code on every device.
"""
from __future__ import annotations

import torch

from ..ops.kernels import adamw as fused_adamw

# the fused AdamW pass's launches and the elements they updated so far
fused_stats = fused_adamw.stats

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _dtype_name(dtype) -> str:
    return _DTYPE_NAMES.get(dtype, str(dtype))


class _Params:
    """A parameter list and its gradients: ``_grads`` gives a zero tensor,
    made once and kept, for a parameter without a gradient. ``reduce``,
    when set (by the data-parallel step), sums the gradients over the
    ranks in place before the update."""
    phase = 0       # the host state ``apply`` branches on: none
    reduce = None

    def __init__(self, params):
        self.params = list(params)
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

    @torch.no_grad()
    def apply(self) -> None:
        """The update for the parameters' ``.grad``, on the device only."""
        grads = self._grads()
        if self.reduce is not None:
            self.reduce(grads)
        self.update(grads)

    def advance(self) -> None:
        """The host's bookkeeping after ``apply``: nothing here."""

    def step(self) -> None:
        self.apply()
        self.advance()


class _Optimizer(_Params):
    """What the optimizers share: the parameter list, the learning rate
    (set between steps), the update count and the per-parameter state
    lists named by ``_STATE``. ``step`` applies the update for the
    parameters' ``.grad`` through the subclass's ``update(grads)``, which
    takes given gradients."""
    _STATE: tuple[str, ...] = ()

    def __init__(self, params, lr: float):
        super().__init__(params)
        dev = self.params[0].device if self.params else torch.device("cpu")
        self._count = torch.zeros((), dtype=torch.int32, device=dev)
        self._neg_lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.lr = lr

    @property
    def lr(self) -> float:
        return self._lr

    @lr.setter
    def lr(self, value: float) -> None:
        self._lr = float(value)
        self._neg_lr.fill_(-self._lr)

    @property
    def count(self) -> int:
        """The number of updates applied (read from the device)."""
        return int(self._count)

    def state_dict(self, own: dict | None = None) -> dict:
        """The update count and the per-parameter state (the learning rate
        is set per epoch and is not part of it). ``own`` gives the state
        lists in another layout (a flat optimizer's per-parameter views)."""
        own = own or {name: getattr(self, name) for name in self._STATE}
        return {"optimizer": type(self).__name__, "step": self.count,
                **{name: list(own[name]) for name in self._STATE}}

    def _check_dtype(self, name: str, own: list, new: list) -> None:
        """Adam's and AdamW's first moment ``mu`` has the dtype the run
        chose (``--moment-dtype``); every other state is f32."""
        have = {t.dtype for t in new}
        want = own[0].dtype
        if have != {want}:
            got = ", ".join(sorted(_dtype_name(d) for d in have))
            what = ("first moment (mu)" if name == "mu"
                    else f"{type(self).__name__} state {name!r}")
            raise ValueError(
                f"the checkpoint's {what} is {got} but this run keeps it in "
                f"{_dtype_name(want)}"
                + (f"; resume with --moment-dtype {got} "
                   f"(TrainerConfig.moment_dtype)" if name == "mu" else ""))

    @torch.no_grad()
    def load_state_dict(self, state: dict, own: dict | None = None) -> None:
        """Restore what ``state_dict`` gave (into ``own``'s state lists,
        as in ``state_dict``). State of another optimizer, or of another
        length, shape or dtype than this optimizer keeps, raises before
        anything is restored."""
        own_lists = own or {name: getattr(self, name) for name in self._STATE}
        kind = state.get("optimizer", "AdamW")
        if kind != type(self).__name__ or any(n not in state
                                              for n in self._STATE):
            raise ValueError(f"the checkpoint holds {kind} state; this run "
                             f"uses {type(self).__name__} (--optim)")
        for name in self._STATE:
            own, new = own_lists[name], state[name]
            if len(new) != len(own):
                raise ValueError(f"optimizer state holds {len(new)} "
                                 f"{name} tensors, this model has "
                                 f"{len(own)} parameters")
            if own:
                self._check_dtype(name, own, new)
            for o, n in zip(own, new):
                if o.shape != n.shape:
                    raise ValueError(f"optimizer {name} of shape "
                                     f"{tuple(n.shape)} for a parameter of "
                                     f"shape {tuple(o.shape)}")
        for name in self._STATE:
            for o, n in zip(own_lists[name], state[name]):
                o.copy_(n)
        self._count.fill_(int(state["step"]))


class _AdamBase(_Optimizer):
    """``scale_by_adam`` with its first moment in ``mu_dtype``."""
    _STATE = ("mu", "nu")

    def __init__(self, params, lr: float, *, weight_decay: float,
                 mu_dtype: torch.dtype = torch.float32, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, lr)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=mu_dtype)
                       for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    def _bias_corrections(self):
        """The update count advanced, and the bias corrections
        ``1 - decay**count`` for it, f32 on the device, as optax computes
        them."""
        self._count.add_(1)
        count = self._count.to(torch.float32)
        return 1.0 - torch.pow(self.b1, count), 1.0 - torch.pow(self.b2, count)

    def _adam(self, grads):
        """The Adam direction u for ``grads``, and mu's new f32 value (to
        be stored once the update is formed)."""
        bc1, bc2 = self._bias_corrections()
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
        return update, mu


class AdamW(_AdamBase):
    """``optax.adamw(lr, b1, b2, eps, weight_decay=..., mu_dtype=...)`` over
    a list of parameters; ``lr`` may be set between steps."""

    def __init__(self, params, lr: float, *, weight_decay: float = 1e-4,
                 **kw):
        super().__init__(params, lr, weight_decay=weight_decay, **kw)

    @torch.no_grad()
    def update(self, grads) -> None:
        """The update for ``grads``: the fused pass for CUDA tensors, the
        ``_foreach`` sequence for CPU ones."""
        if self._count.device.type == "cpu":
            self.update_plain(grads)
        else:
            self.update_fused(grads)

    @torch.no_grad()
    def update_plain(self, grads) -> None:
        """The update as ``_foreach`` passes: the fused pass's plain
        version."""
        update, mu = self._adam(grads)
        torch._foreach_add_(update,
                            torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(update, self._neg_lr)
        torch._foreach_add_(self.params, update)
        torch._foreach_copy_(self.mu, mu)

    @torch.no_grad()
    def update_fused(self, grads) -> None:
        """The update as one pass of the CUDA kernel over the lists, or
        an error for lists it does not take; counted by
        :func:`fused_stats`."""
        bc1, bc2 = self._bias_corrections()
        fused_adamw.adamw(self.params, grads, self.mu, self.nu, bc1, bc2,
                          self._neg_lr, b1=self.b1, b2=self.b2, eps=self.eps,
                          weight_decay=self.weight_decay)


class Adam(_AdamBase):
    """``optax.chain(add_decayed_weights(weight_decay), optax.adam(lr,
    mu_dtype=...))``: weight decay coupled to the gradient."""

    def __init__(self, params, lr: float, *, weight_decay: float = 0.0,
                 **kw):
        super().__init__(params, lr, weight_decay=weight_decay, **kw)

    @torch.no_grad()
    def update(self, grads) -> None:
        grads = torch._foreach_add(
            grads, torch._foreach_mul(self.params, self.weight_decay))
        update, mu = self._adam(grads)
        torch._foreach_mul_(update, self._neg_lr)
        torch._foreach_add_(self.params, update)
        torch._foreach_copy_(self.mu, mu)


class SGD(_Optimizer):
    """``optax.sgd(lr, momentum)`` (a trace, not Nesterov), behind
    ``add_decayed_weights(weight_decay)`` when ``weight_decay != 0``."""
    _STATE = ("trace",)

    def __init__(self, params, lr: float, *, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, lr)
        self.momentum = momentum
        self.weight_decay = weight_decay
        with torch.no_grad():
            self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads) -> None:
        self._count.add_(1)
        if self.weight_decay != 0:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(self.params, self.weight_decay))
        trace = torch._foreach_mul(self.trace, self.momentum)
        torch._foreach_add_(trace, grads)
        update = torch._foreach_mul(trace, self._neg_lr)
        torch._foreach_add_(self.params, update)
        torch._foreach_copy_(self.trace, trace)


class LAMB(_Optimizer):
    """``cgat_tpu.training.lamb.lamb(lr, weight_decay=...)`` (reference
    CGAT/lambs.py:155-181)."""
    _STATE = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float, *, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6):
        super().__init__(params, lr)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        with torch.no_grad():
            self.exp_avg = [torch.zeros_like(p) for p in self.params]
            self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads) -> None:
        self._count.add_(1)
        torch._foreach_mul_(self.exp_avg, self.b1)
        torch._foreach_add_(self.exp_avg, torch._foreach_mul(grads,
                                                             1 - self.b1))
        g2 = torch._foreach_mul(grads, 1 - self.b2)
        torch._foreach_mul_(g2, grads)
        torch._foreach_mul_(self.exp_avg_sq, self.b2)
        torch._foreach_add_(self.exp_avg_sq, g2)
        den = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_add_(den, self.eps)
        step = torch._foreach_div(self.exp_avg, den)
        torch._foreach_add_(step, torch._foreach_mul(self.params,
                                                     self.weight_decay))
        w_norm = torch.stack(torch._foreach_norm(self.params)).clamp(0.0,
                                                                     10.0)
        s_norm = torch.stack(torch._foreach_norm(step))
        one = torch.ones_like(w_norm)
        trust = w_norm / (s_norm + self.eps)
        trust = torch.where(w_norm == 0.0, one, trust)
        trust = torch.where(s_norm == 0.0, one, trust)
        torch._foreach_mul_(step, list((self._neg_lr * trust).unbind()))
        torch._foreach_add_(self.params, step)


class MultiSteps:
    """``optax.MultiSteps(inner, k)``: gradients averaged over k
    mini-steps (a running mean) and handed to ``inner`` every k-th one; in
    between the parameters do not change. ``lr`` is the inner
    optimizer's. The mini-step is host state: ``apply`` branches on it and
    divides by it, so a CUDA graph of the step holds for one ``phase``.
    ``reduce`` as :class:`_Params`', applied to each mini-step's
    gradients."""
    reduce = None

    def __init__(self, inner: _Optimizer, k: int):
        self.inner = inner
        self.k = k
        self.mini_step = 0
        with torch.no_grad():
            self.acc = [torch.zeros_like(p) for p in inner.params]

    @property
    def params(self):
        return self.inner.params

    @property
    def lr(self) -> float:
        return self.inner.lr

    @lr.setter
    def lr(self, value: float) -> None:
        self.inner.lr = value

    @property
    def phase(self) -> int:
        return self.mini_step

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    @torch.no_grad()
    def apply(self) -> None:
        grads = self.inner._grads()
        if self.reduce is not None:
            self.reduce(grads)
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step == self.k - 1:
            self.inner.update(self.acc)
            torch._foreach_zero_(self.acc)

    def advance(self) -> None:
        self.mini_step = (self.mini_step + 1) % self.k

    def step(self) -> None:
        self.apply()
        self.advance()

    def state_dict(self) -> dict:
        return {"optimizer": "MultiSteps", "mini_step": self.mini_step,
                "acc": list(self.acc), "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if state.get("optimizer") != "MultiSteps":
            raise ValueError(f"the checkpoint holds "
                             f"{state.get('optimizer', 'AdamW')} state "
                             f"without gradient accumulation; this run "
                             f"accumulates (--acc-batches {self.k})")
        if len(state["acc"]) != len(self.acc) or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(self.acc, state["acc"])):
            raise ValueError("the checkpoint's accumulated gradients do not "
                             "match this model's parameters")
        self.inner.load_state_dict(state["inner"])
        for a, b in zip(self.acc, state["acc"]):
            a.copy_(b)
        self.mini_step = int(state["mini_step"])


@torch.no_grad()
def project_params(model: torch.nn.Module) -> None:
    """Clamp every HNet ``damping`` into [0, 1] after an update: the
    reference clamps it in place at each forward (projected gradient,
    Hypernetworksmp.py:309-313), and the forward's straight-through clip
    already uses the clamped value."""
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] == "damping":
            p.clamp_(0.0, 1.0)
