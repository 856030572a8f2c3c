"""Loss functions, counterpart of ``cgat_tpu/training/losses.py`` (reference
CGAT/utils.py:30-47, lightning_module.py:130-142).

All losses are masked means over graph slots, so padded crystals add
nothing. The reference default is plain L1 on normalised targets; the
robust variants add a learned aleatoric log-std.
"""
from __future__ import annotations

import torch

SQRT2 = 1.4142135623730951


def _masked_mean(x, mask):
    num = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device)).sum()
    den = torch.clamp(mask.to(x.dtype).sum(), min=1.0)
    return num / den


def robust_l1(output, log_std, target, mask):
    """Lorentzian aleatoric L1: sqrt(2)*|d|*exp(-s) + s (utils.py:30-37)."""
    loss = SQRT2 * torch.abs(output - target) * torch.exp(-log_std) + log_std
    return _masked_mean(loss, mask)


def robust_l2(output, log_std, target, mask):
    """Gaussian aleatoric L2: 0.5*d^2*exp(-2s) + s (utils.py:40-47)."""
    loss = 0.5 * (output - target) ** 2 * torch.exp(-2.0 * log_std) + log_std
    return _masked_mean(loss, mask)


def l1(output, target, mask):
    return _masked_mean(torch.abs(output - target), mask)


def mse(output, target, mask):
    return _masked_mean((output - target) ** 2, mask)


def make_loss(loss_name: str = "L1", robust: bool = False):
    """The training criterion ``fn(output, log_std, target_norm, mask)``
    (lightning_module.py:130-142)."""
    if robust:
        return robust_l1 if loss_name == "L1" else robust_l2
    if loss_name == "L1":
        return lambda o, s, t, m: l1(o, t, m)
    return lambda o, s, t, m: mse(o, t, m)
