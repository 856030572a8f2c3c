"""Core building blocks (torch.nn), counterpart of ``cgat_tpu/models/blocks.py``.

Parameters keep the reference ``state_dict`` layout (reference
CGAT/message_changed.py:31-138, CGAT/CGAT.py:65-112), so a reference
checkpoint, or a JAX parameter tree through ``models/convert.py``, loads
with ``strict=True``. Every layer with weights computes in its
``compute_dtype``: the input and the weights are cast to it at each use, as
flax casts to the JAX package's compute dtype, so f32 master weights train
under bf16 compute and their grads arrive in f32. ``compute_dtype`` None
(a layer used on its own) means the weights' own dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.mh_network import mh_network_op
from ..ops.kernels.mh_network import supported as mh_supported

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default negative_slope


class TorchLinear(nn.Linear):
    """``nn.Linear`` computing in its ``compute_dtype``."""
    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class SimpleNetwork(nn.Module):
    """LeakyReLU MLP (reference message_changed.py:31-66)."""

    def __init__(self, input_dim, output_dim, hidden_layer_dims):
        super().__init__()
        dims = [input_dim, *hidden_layer_dims]
        self.fcs = nn.ModuleList(TorchLinear(dims[i], dims[i + 1])
                                 for i in range(len(dims) - 1))
        self.fc_out = TorchLinear(dims[-1], output_dim)

    def forward(self, x):
        for fc in self.fcs:
            x = F.leaky_relu(fc(x), LEAKY_SLOPE)
        return self.fc_out(x)


class Rezero(nn.Module):
    """alpha * x with alpha initialised to 0 (reference message_changed.py:69-78).
    ``alpha`` stays f32, so the product is f32 as in the JAX package."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.alpha * x


class ResidualNetwork(nn.Module):
    """ReLU residual MLP with linear skips (reference message_changed.py:81-135).

    ``fea = act(fc(fea)) + res_fc(fea)`` per layer, ReZero-gated when
    ``if_rezero``; the skip is the identity where the width does not change.
    ``last_layer=False`` returns the penultimate features.
    """

    def __init__(self, input_dim, output_dim, hidden_layer_dims,
                 if_rezero=False):
        super().__init__()
        dims = [input_dim, *hidden_layer_dims]
        pairs = list(zip(dims[:-1], dims[1:]))
        self.fcs = nn.ModuleList(TorchLinear(a, b) for a, b in pairs)
        self.res_fcs = nn.ModuleList(
            TorchLinear(a, b, bias=False) if a != b else nn.Identity()
            for a, b in pairs)
        self.rezeros = (nn.ModuleList(Rezero() for _ in pairs)
                        if if_rezero else None)
        self.fc_out = TorchLinear(dims[-1], output_dim)

    def forward(self, x, *, last_layer=True):
        for i, (fc, res_fc) in enumerate(zip(self.fcs, self.res_fcs)):
            branch = torch.relu(fc(x))
            if self.rezeros is not None:
                branch = self.rezeros[i](branch)
            x = branch + res_fc(x)
        return self.fc_out(x) if last_layer else x


class MultiHeadNetwork(nn.Module):
    """H parallel [Linear -> LeakyReLU -> Linear] networks over one input.

    The reference realises it as grouped 1x1 ``Conv1d``s over the input
    repeated per head (CGAT/CGAT.py:91-109); the Conv1d modules are kept as
    the holders of the ``(H*out, in, 1)`` weights, and the computation is:

    * ``flat=True`` with kernel-eligible widths: the ``mh_network`` kernel,
      returning ``(B, H*out)`` head-major (the layout the segment-attention
      kernel takes);
    * otherwise two batched matmuls returning ``(B, H, out)``.
    """
    compute_dtype: torch.dtype | None = None

    def __init__(self, input_dim, output_dim, hidden_layer_dim, nb_heads):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.hidden_layer_dim = hidden_layer_dim
        self.nb_heads = nb_heads
        self.fc_in = nn.Conv1d(input_dim * nb_heads,
                               hidden_layer_dim * nb_heads, 1,
                               groups=nb_heads)
        self.fc_out = nn.Conv1d(hidden_layer_dim * nb_heads,
                                output_dim * nb_heads, 1, groups=nb_heads)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.fc_in.weight.dtype

    def flat_supported(self) -> bool:
        return mh_supported(self.input_dim, self.hidden_layer_dim,
                            self.output_dim, self.nb_heads, self.dtype)

    def forward(self, x=None, *, split_parts=None, flat=False):
        """``x`` of shape (B, ..., input_dim) is flattened to
        (B', input_dim) like the reference's ``reshape(-1, input_dim, 1)``.
        Callers of ``flat=True`` check :meth:`flat_supported` first.

        ``split_parts`` instead of ``x``: ``(features, index or None)``
        pairs whose widths take consecutive slices of ``input_dim``.
        ``fc_in`` projects each part's rows first and the projections are
        gathered by ``index``, which equals projecting the gathered concat
        (the first layer is linear) with the same parameters."""
        H, hid, out = self.nb_heads, self.hidden_layer_dim, self.output_dim
        dt = self.dtype
        w_in = self.fc_in.weight.view(H * hid, self.input_dim).to(dt)
        w_out = self.fc_out.weight.view(H * out, hid).to(dt)
        b_in, b_out = self.fc_in.bias.to(dt), self.fc_out.bias.to(dt)
        if split_parts is not None:
            h, off = None, 0
            for feat, idx in split_parts:
                d = feat.shape[-1]
                p = torch.einsum("bi,hji->bhj", feat.to(dt),
                                 w_in.view(H, hid, -1)[:, :, off:off + d])
                p = p if idx is None else p[idx]
                h = p if h is None else h + p
                off += d
            if off != self.input_dim:
                raise ValueError(f"split parts cover {off} of "
                                 f"{self.input_dim} input features")
        elif flat:
            x = x.reshape(-1, self.input_dim).to(dt)
            return mh_network_op(x.contiguous(), w_in, b_in, w_out, b_out, H)
        else:
            x = x.reshape(-1, self.input_dim).to(dt)
            h = torch.einsum("bi,hji->bhj", x, w_in.view(H, hid, -1))
        h = F.leaky_relu(h + b_in.view(H, hid), LEAKY_SLOPE)
        y = torch.einsum("bhj,hoj->bho", h, w_out.view(H, out, hid))
        return y + b_out.view(H, out)
