"""The SVGP head's ELBO in plain PyTorch (hyllios/CGAT
``CGAT/gaussian_process.py``: a whitened variational strategy with
learnable inducing points, a Cholesky variational distribution, a
constant mean, ScaleKernel(RBF), a Gaussian likelihood; gpytorch's
VariationalELBO), over a dict of f32 tensors: ``inducing`` (M, D),
``var_mean`` (M,), ``var_chol`` (M, M), ``raw_lengthscale``,
``raw_outputscale``, ``raw_noise`` and ``mean_const`` (0-dim)."""
from __future__ import annotations

import math

import torch

from .precision import Precision


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def init(inducing: torch.Tensor) -> dict:
    """The prior around ``inducing``: m = 0, S = I, every raw scale 0."""
    m = inducing.shape[0]
    z = lambda *s: torch.zeros(s, dtype=torch.float32,
                               device=inducing.device)
    return {"inducing": inducing.clone().float(), "var_mean": z(m),
            "var_chol": torch.eye(m, device=inducing.device),
            "raw_lengthscale": z(), "raw_outputscale": z(), "raw_noise": z(),
            "mean_const": z()}


def neg_elbo(P: dict, x, y, num_data: int, jitter: float = 1e-5,
             precision: Precision | None = None):
    """-ELBO of rows ``x`` (B, D) with normalised targets ``y`` (B,)."""
    p = precision or Precision()
    ls = softplus(P["raw_lengthscale"])
    os_ = softplus(P["raw_outputscale"])
    noise = softplus(P["raw_noise"])

    def rbf(a, b):
        a, b = a / ls, b / ls
        d2 = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
              - 2.0 * p.mm(a, b.t()))
        return os_ * torch.exp(-0.5 * d2.clamp(min=0.0))

    z = P["inducing"]
    m = z.shape[0]
    kzz = rbf(z, z) + jitter * torch.eye(m, device=z.device)
    lz = torch.linalg.cholesky(kzz)
    a = torch.linalg.solve_triangular(lz, rbf(z, x), upper=False)
    mean = P["mean_const"] + p.mm(a.t(), P["var_mean"][:, None])[:, 0]
    lt = torch.tril(P["var_chol"])
    lta = p.mm(lt.t(), a)
    var = (os_ - (a * a).sum(0) + (lta * lta).sum(0)).clamp(min=1e-10)
    ell = -0.5 * (torch.log(2.0 * math.pi * noise)
                  + ((y - mean) ** 2 + var) / noise)
    vm = P["var_mean"]
    kl = 0.5 * ((lt * lt).sum() + vm @ vm - m
                - 2.0 * torch.log(torch.diagonal(lt).abs() + 1e-20).sum())
    return -(ell.mean() - kl / num_data)
