"""Hypernetwork stack (torch.nn), counterpart of ``cgat_tpu/models/hyper.py``.

A conditioning vector per node drives an ``FCBlock`` (Tanh MLP) that
predicts the weights and bias of a small Linear, which is then applied to
that node's own input (reference CGAT/Hypernetworksmp.py:24-313). Module
attributes follow the reference, so the ``state_dict`` keys are the
reference's, e.g. ``Hyper.layers.0.hyper_linear.hypo_params.net.0.net.0.weight``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.hyper_apply import hyper_apply_op
from ..ops.kernels.hyper_apply import supported as hyper_supported
from .blocks import TorchLinear


class FCLayer(nn.Module):
    """Linear -> Tanh (Hypernetworksmp.py:24-33)."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.net = nn.Sequential(TorchLinear(in_features, out_features),
                                 nn.Tanh())

    def forward(self, x):
        return self.net(x)


class FCBlock(nn.Module):
    """[Linear -> Tanh] x (1 + num_hidden_layers), then a plain Linear
    (Hypernetworksmp.py:36-83, the ``outermost_linear`` form)."""

    def __init__(self, in_features, hidden_ch, num_hidden_layers,
                 out_features):
        super().__init__()
        layers = [FCLayer(in_features, hidden_ch)]
        layers += [FCLayer(hidden_ch, hidden_ch)
                   for _ in range(num_hidden_layers)]
        layers.append(TorchLinear(hidden_ch, out_features))
        self.net = nn.ModuleList(layers)

    def hidden(self, x):
        """The activations that feed the last Linear."""
        for layer in self.net[:-1]:
            x = layer(x)
        return x

    def forward(self, x):
        return self.net[-1](self.hidden(x))


class HyperLinear(nn.Module):
    """Predicts a per-sample Linear(in_ch -> out_ch) from ``cond`` and
    applies it to ``x`` (Hypernetworksmp.py:205-254).

    With kernel-eligible widths the last hypernetwork Linear and the apply
    run as the fused ``hyper_apply`` kernel, which never writes the
    (B, out*in + out) predicted parameters to device memory. ``remat``
    (the model's ``hyper_remat``) recomputes the layer in the backward
    instead of keeping its activations, as ``nn.remat(HyperLinear)`` does
    in the JAX package: the forward kernel then runs twice a step."""
    compute_dtype: torch.dtype | None = None
    remat: bool = False

    def __init__(self, in_ch, out_ch, hyper_in_ch, hyper_num_hidden_layers,
                 hyper_hidden_ch):
        super().__init__()
        self.in_ch = in_ch
        self.out_ch = out_ch
        self.hypo_params = FCBlock(hyper_in_ch, hyper_hidden_ch,
                                   hyper_num_hidden_layers,
                                   in_ch * out_ch + out_ch)

    def forward(self, cond, x):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._predict_apply, cond, x,
                              use_reentrant=False)
        return self._predict_apply(cond, x)

    def _predict_apply(self, cond, x):
        last = self.hypo_params.net[-1]
        dt = self.compute_dtype or last.weight.dtype
        hidden = self.hypo_params.hidden(cond)
        x = x.to(dt)
        if hyper_supported(hidden.shape[-1], self.in_ch, self.out_ch, dt):
            return hyper_apply_op(hidden.to(dt).contiguous(),
                                  last.weight.to(dt), last.bias.to(dt),
                                  x.contiguous(), self.out_ch)
        params = last(hidden)
        w = params[:, :self.in_ch * self.out_ch]
        w = w.reshape(-1, self.out_ch, self.in_ch)
        return (torch.einsum("boi,bi->bo", w, x)
                + params[:, self.in_ch * self.out_ch:])


class HyperLayer(nn.Module):
    """HyperLinear -> LayerNorm (no affine) -> Tanh (Hypernetworksmp.py:86-114)."""

    def __init__(self, in_ch, out_ch, hyper_in_ch, hyper_num_hidden_layers,
                 hyper_hidden_ch):
        super().__init__()
        self.hyper_linear = HyperLinear(in_ch, out_ch, hyper_in_ch,
                                        hyper_num_hidden_layers,
                                        hyper_hidden_ch)

    def forward(self, cond, x):
        y = self.hyper_linear(cond, x)
        return torch.tanh(F.layer_norm(y, y.shape[-1:], eps=1e-5))


class HyperFC(nn.Module):
    """Predicted MLP: ``num_hidden_layers + 1`` HyperLayers, then one bare
    HyperLinear, all conditioned on the same input
    (Hypernetworksmp.py:117-185)."""

    def __init__(self, hyper_in_ch, hyper_num_hidden_layers, hyper_hidden_ch,
                 hidden_ch, num_hidden_layers, in_ch, out_ch):
        super().__init__()
        hyper = (hyper_in_ch, hyper_num_hidden_layers, hyper_hidden_ch)
        dims_in = [in_ch] + [hidden_ch] * num_hidden_layers
        layers = [HyperLayer(d, hidden_ch, *hyper) for d in dims_in]
        layers.append(HyperLinear(hidden_ch, out_ch, *hyper))
        self.layers = nn.ModuleList(layers)

    def forward(self, cond, x):
        for layer in self.layers:
            x = layer(cond, x)
        return x


class HNet0(nn.Module):
    """H_Net_0: hyper-MLP conditioned on ``h_0`` applied to ``x``
    (Hypernetworksmp.py:257-285). Used by the first message-passing layer."""

    def __init__(self, hyper_in_ch, hyper_num_hidden_layers, hyper_hidden_ch,
                 hidden_ch, num_hidden_layers, in_ch, out_ch):
        super().__init__()
        self.Hyper = HyperFC(hyper_in_ch, hyper_num_hidden_layers,
                             hyper_hidden_ch, hidden_ch, num_hidden_layers,
                             in_ch, out_ch)

    def forward(self, h_0, x):
        return self.Hyper(h_0, x)


class HNet(nn.Module):
    """H_Net: conditioning ``d * h_0 + (1 - d) * x`` with the learnable
    ``damping`` clamped into [0, 1] in the forward pass, as the reference
    clamps it in place each forward (Hypernetworksmp.py:288-313): a
    straight-through clip, the value clamped and the gradient unit, as in
    the JAX package (the trainer projects the stored value after each
    update). ``h_t`` is unused, as in the reference. ``damping`` stays f32,
    so the mix is f32."""

    def __init__(self, hyper_in_ch, hyper_num_hidden_layers, hyper_hidden_ch,
                 hidden_ch, num_hidden_layers, in_ch, out_ch):
        super().__init__()
        self.damping = nn.Parameter(torch.rand(1))
        self.Hyper = HyperFC(hyper_in_ch, hyper_num_hidden_layers,
                             hyper_hidden_ch, hidden_ch, num_hidden_layers,
                             in_ch, out_ch)

    def forward(self, h_0, h_t, x):
        d = self.damping + (torch.clamp(self.damping, 0.0, 1.0)
                            - self.damping).detach()
        return self.Hyper(d * h_0 + (1.0 - d) * x, x)
