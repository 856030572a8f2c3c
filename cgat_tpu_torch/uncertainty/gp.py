"""Sparse variational GP uncertainty head, counterpart of
``cgat_tpu/uncertainty/gp.py`` (reference: CGAT/gaussian_process.py:45-70,
228-233): a whitened variational strategy with learnable inducing points,
a Cholesky variational distribution, a constant (or zero) mean, a
ScaleKernel(RBF) and a Gaussian likelihood, trained by maximising the
variational ELBO (loss = -ELBO). Written out in f32 tensors (gpytorch is
not used): with Z the M inducing points, Kzz + jitter I = Lz Lz^T,
A = Lz^{-1} Kzx and q(v) = N(m, L L^T)::

    mean(f(x)) = mu + A^T m
    var(f(x))  = k(x, x) - ||A||^2 + ||L^T A||^2      (columnwise)
    ELBO = mean_i E_q[log N(y_i | f_i, sigma^2)] - KL(q(v) || N(0, I)) / N

The Cholesky factor and the triangular solve are ``torch.linalg`` calls,
as the JAX package leaves them to XLA. The optimiser is the port's
``training.optim.Adam`` without weight decay (``optax.adam``); under
``zero_mean`` the constant mean is not trained. ``fit_gp`` and
``fit_gp_streaming`` draw the inducing rows and each epoch's order from
``np.random.default_rng(seed)`` in the JAX package's order, so the two
trajectories are comparable.

``fit_gp`` trains on fixed embeddings; ``fit_gp_streaming`` embeds every
batch through the frozen backbone (eval mode, no gradient) inside the GP
step, so a large pool never materialises its embeddings. On a card each
step, the embedding forward included, is a replay of a CUDA graph of the
step, one a batch shape (``training.dispatch.StepGraphs``: the first step
of a shape eager, then its capture); on the CPU each step is eager.
``train_gp_from_checkpoint`` is ``cli.train_gp``'s driver and writes the
JAX package's pickle layout; ``load_gp`` reads the pickles of both
packages without importing the JAX package.
"""
from __future__ import annotations

import dataclasses
import gzip
import math
import pickle

import numpy as np
import torch

from ..data.batching import CrystalBatch
from ..data.dataset import GraphLoader, load_dataset_dir, split_dataset
from ..device import resolve_device
from ..training.dispatch import StepGraphs
from ..training.optim import Adam
from ..utils.profiling import annotated


def softplus(x):
    """``jax.nn.softplus``, ``log(exp(x) + 1)`` at every x (``F.softplus``
    turns into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclasses.dataclass
class GPParams:
    """The SVGP's parameters, the JAX package's ``GPParams`` field for
    field: f32 tensors (numpy arrays in a pickle)."""
    inducing: torch.Tensor          # (M, D) learnable inducing locations
    var_mean: torch.Tensor          # (M,)
    var_chol: torch.Tensor          # (M, M) lower-triangular factor of S
    raw_lengthscale: torch.Tensor   # () softplus-constrained
    raw_outputscale: torch.Tensor   # ()
    raw_noise: torch.Tensor         # ()
    mean_const: torch.Tensor        # () constant mean (0 under zero_mean)

    def map(self, fn) -> "GPParams":
        return GPParams(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})

    def named(self) -> list[tuple[str, torch.Tensor]]:
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)]


@dataclasses.dataclass(frozen=True)
class GPConfig:
    zero_mean: bool = False
    jitter: float = 1e-5


def init_gp(inducing_points, cfg: GPConfig = GPConfig(),
            device="cpu") -> GPParams:
    """The prior's parameters around the given inducing points: m = 0,
    S = I, softplus(0) = log 2 for the lengthscale, the outputscale and
    the noise, mean 0."""
    z = torch.as_tensor(np.asarray(inducing_points, np.float32),
                        device=device)
    m = z.shape[0]

    def zero(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=z.device)
    return GPParams(inducing=z.clone(), var_mean=zero(m),
                    var_chol=torch.eye(m, dtype=torch.float32,
                                       device=z.device),
                    raw_lengthscale=zero(), raw_outputscale=zero(),
                    raw_noise=zero(), mean_const=zero())


def _rbf(x1, x2, lengthscale, outputscale):
    """ScaleKernel(RBFKernel): s^2 * exp(-0.5 d^2 / l^2)."""
    x1 = x1 / lengthscale
    x2 = x2 / lengthscale
    d2 = ((x1 * x1).sum(-1)[:, None] + (x2 * x2).sum(-1)[None, :]
          - 2.0 * x1 @ x2.T)
    return outputscale * torch.exp(-0.5 * torch.maximum(
        d2, torch.zeros_like(d2)))


def _chol_with_jitter(k, jitter):
    """Cholesky with a fixed jitter, without the error check's host sync
    (a failed factor gives non-finite values, as in the JAX package)."""
    eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
    return torch.linalg.cholesky_ex(k + jitter * eye, check_errors=False).L


def gp_predict_f(params: GPParams, x, cfg: GPConfig = GPConfig()):
    """Latent predictive mean and variance at x (B, D)."""
    ls = softplus(params.raw_lengthscale)
    os_ = softplus(params.raw_outputscale)
    z = params.inducing
    kzz = _rbf(z, z, ls, os_)
    kzx = _rbf(z, x, ls, os_)
    lz = _chol_with_jitter(kzz, cfg.jitter)
    a = torch.linalg.solve_triangular(lz, kzx, upper=False)      # (M, B)
    mean = params.mean_const + a.T @ params.var_mean
    ltril = torch.tril(params.var_chol)
    lta = ltril.T @ a
    kxx_diag = os_ * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    var = kxx_diag - (a * a).sum(0) + (lta * lta).sum(0)
    return mean, torch.maximum(var, torch.full_like(var, 1e-10))


def gp_predict_y(params: GPParams, x, cfg: GPConfig = GPConfig()):
    """Observed predictive (adds the likelihood's noise)."""
    mean, var = gp_predict_f(params, x, cfg)
    return mean, var + softplus(params.raw_noise)


def kl_divergence(params: GPParams):
    """KL(q(v) || N(0, I)) of the whitened variational distribution."""
    ltril = torch.tril(params.var_chol)
    m = params.var_mean
    tr = (ltril * ltril).sum()
    logdet = 2.0 * torch.log(torch.diagonal(ltril).abs() + 1e-20).sum()
    return 0.5 * (tr + m @ m - m.shape[0] - logdet)


def elbo(params: GPParams, x, y, num_data: int, cfg: GPConfig = GPConfig(),
         mask=None):
    """VariationalELBO (gpytorch's semantics): the batch mean of the
    expected log likelihood, over ``mask``'s rows when it is given, minus
    KL / num_data."""
    mean, var = gp_predict_f(params, x, cfg)
    noise = softplus(params.raw_noise)
    ell = -0.5 * (torch.log(2.0 * math.pi * noise)
                  + ((y - mean) ** 2 + var) / noise)
    if mask is not None:
        ell_mean = torch.where(mask, ell, torch.zeros_like(ell)).sum() \
            / mask.sum().float().clamp(min=1.0)
    else:
        ell_mean = ell.mean()
    return ell_mean - kl_divergence(params) / num_data


def confidence_region(mean, var):
    """mean +- 2 std of the latent f (gpytorch's confidence_region)."""
    sd = torch.sqrt(var)
    return mean - 2.0 * sd, mean + 2.0 * sd


@dataclasses.dataclass
class _Rows:
    """A batch of fixed embeddings and normalised targets: what
    ``StepGraphs`` needs of a batch (its fields' shapes key the graph)."""
    x: torch.Tensor
    y: torch.Tensor

    def map(self, fn) -> "_Rows":
        return _Rows(fn(self.x), fn(self.y))

    def copy_(self, src: "_Rows") -> "_Rows":
        self.x.copy_(src.x)
        self.y.copy_(src.y)
        return self


class GPFit:
    """The GP's trainable state on ``device`` and its step:
    ``step(batch)`` maximises ``elbo_of(params, batch)`` by one Adam step
    and returns the loss (-ELBO) as a device scalar. On a card the step is
    a replay of its CUDA graph for the batch's shapes (``graphs``, a
    ``StepGraphs``; set it to None for eager steps on the card); on the CPU
    it is eager. Under ``cfg.zero_mean`` the constant mean is not
    trained."""

    def __init__(self, params: GPParams, cfg: GPConfig, learning_rate,
                 elbo_of, device):
        self.params = params.map(lambda t: t.detach().clone())
        trained = [t for name, t in self.params.named()
                   if not (cfg.zero_mean and name == "mean_const")]
        for t in trained:
            t.requires_grad_(True)
        self.opt = Adam(trained, learning_rate, weight_decay=0.0)
        self.elbo_of = elbo_of
        self.graphs = StepGraphs(device) if device.type == "cuda" else None

    def _step_on_device(self, batch) -> dict:
        loss = -self.elbo_of(self.params, batch)
        self.opt.zero_grad()
        loss.backward()
        self.opt.apply()
        return {"loss": loss.detach()}

    @annotated("gp_step")
    def step(self, batch) -> torch.Tensor:
        if self.graphs is None:
            return self._step_on_device(batch)["loss"]
        return self.graphs.run(self._step_on_device, batch)["loss"].clone()

    def result(self) -> GPParams:
        return self.params.map(lambda t: t.detach())


def _report(verbose: bool, epoch: int, epochs: int, history) -> None:
    if verbose and (epoch % max(1, epochs // 10) == 0):
        print(f"gp epoch {epoch}: -elbo {history[-1]:.4f}")


def fit_gp(embeddings: np.ndarray, targets_norm: np.ndarray, *,
           num_inducing: int = 500, epochs: int = 100, batch_size: int = 512,
           learning_rate: float = 1e-2, seed: int = 0,
           cfg: GPConfig = GPConfig(), verbose: bool = True, device=None):
    """Train an SVGP on (normalised) targets on ``device`` (the card
    unless the caller asks for the CPU). The inducing points start at a
    random subset of the rows (gaussian_process.py:208-227). Returns the
    parameters and each epoch's mean loss (-ELBO)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = embeddings.shape[0]
    idx = rng.permutation(n)[: min(num_inducing, n)]
    fit = GPFit(init_gp(embeddings[idx], cfg, device), cfg, learning_rate,
                lambda p, b: elbo(p, b.x, b.y, n, cfg), device)
    x = torch.as_tensor(np.asarray(embeddings, np.float32), device=device)
    y = torch.as_tensor(np.asarray(targets_norm, np.float32), device=device)
    steps_per_epoch = max(1, n // batch_size)
    history = []
    for epoch in range(epochs):
        order = rng.permutation(n)
        losses = []
        for b in range(steps_per_epoch):
            sel = torch.as_tensor(order[b * batch_size:(b + 1) * batch_size],
                                  device=device)
            losses.append(fit.step(_Rows(x[sel], y[sel])))
        history.append(float(torch.stack(losses).double().sum())
                       / steps_per_epoch)
        _report(verbose, epoch, epochs, history)
    return fit.result(), history


def frozen_embed(model, batch: CrystalBatch) -> torch.Tensor:
    """The backbone's f32 graph embeddings of ``batch``, no gradient."""
    with torch.no_grad():
        return model(batch, return_graph_embedding=True).float()


def streaming_elbo(model, mean: float, std: float, num_data: int,
                   cfg: GPConfig = GPConfig()):
    """``elbo_of(params, batch)`` of the on-the-fly step: the masked ELBO
    of the frozen ``model``'s embeddings of ``batch`` against its
    normalised targets."""
    def elbo_of(params, batch):
        return elbo(params, frozen_embed(model, batch),
                    (batch.target - mean) / std, num_data, cfg,
                    mask=batch.graph_mask)
    return elbo_of


def inducing_embeddings(model, graphs, *, max_nbr=24, node_bucket=64,
                        num_comp_slots=None) -> torch.Tensor:
    """The frozen ``model``'s embeddings of ``graphs`` collated as one
    batch, its real rows only."""
    device = next(model.parameters()).device
    loader = GraphLoader(graphs, len(graphs), shuffle=False, max_nbr=max_nbr,
                         node_bucket=node_bucket,
                         num_comp_slots=num_comp_slots, drop_last=False)
    return torch.cat([frozen_embed(model, b)[b.graph_mask]
                      for b in (b.to(device) for b in loader)])


def fit_gp_streaming(model, graphs, *, mean: float, std: float,
                     num_inducing: int = 500, epochs: int = 100,
                     batch_size: int = 512, learning_rate: float = 1e-2,
                     seed: int = 0, cfg: GPConfig = GPConfig(),
                     max_nbr: int = 24, node_bucket: int = 64,
                     num_comp_slots=None, verbose: bool = True):
    """On-the-fly SVGP training (reference gaussian_process.py:241-296) on
    ``model``'s device: the frozen ``model`` (a ``CGAtNet``, put in eval
    mode for the call) embeds every batch inside the GP step, then the
    masked ELBO, its gradient and Adam run; on a card the step is one
    CUDA graph replay a batch shape. The inducing points are the
    embeddings of one random ``num_inducing``-graph batch
    (gaussian_process.py:213-222); padded graph slots are masked out.
    Returns the parameters and each epoch's mean loss (-ELBO)."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    n = len(graphs)
    sel = rng.permutation(n)[: min(num_inducing, n)]
    was_training = model.training
    model.eval()
    try:
        inducing = inducing_embeddings(
            model, [graphs[i] for i in sel], max_nbr=max_nbr,
            node_bucket=node_bucket, num_comp_slots=num_comp_slots)
        fit = GPFit(init_gp(inducing.cpu().numpy(), cfg, device), cfg,
                    learning_rate, streaming_elbo(model, mean, std, n, cfg),
                    device)
        loader = GraphLoader(graphs, min(batch_size, n), shuffle=True,
                             seed=seed, max_nbr=max_nbr,
                             node_bucket=node_bucket,
                             num_comp_slots=num_comp_slots)
        history = []
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            losses = [fit.step(batch.to(device)) for batch in loader]
            history.append(float(torch.stack(losses).mean()))
            _report(verbose, epoch, epochs, history)
    finally:
        model.train(was_training)
    return fit.result(), history


# ------------------------------------------------------------------ pipeline

def embedding_dataset(data, target: str = "e_above_hull_new"):
    """EmbeddingData (gaussian_process.py:33-41): a prepared dict whose
    'input' holds (C, embedding_dim) arrays, or the path of its gzipped
    pickle."""
    if isinstance(data, str):
        with gzip.open(data, "rb") as f:
            data = pickle.load(f)
    x = np.asarray(data["input"], np.float32)
    y = np.asarray(data["target"][target], np.float32).reshape(-1)
    return x, y


def train_gp_from_checkpoint(args):
    """``cli.train_gp``'s driver (gaussian_process.py:568-673): the frozen
    CGAT of ``args.cgat_model`` -> embeddings (precomputed, from
    ``args.embedding_path``, or ``args.on_the_fly`` inside the GP step)
    -> an SVGP on the normalised targets of the seeded training split ->
    the validation MAE -> a gzipped pickle of the JAX package's layout at
    ``args.out``. With ``args.devices`` > 1, inside a world of that many
    ranks, each rank embeds its share (``Trainer.embeddings`` across the
    mesh), every rank fits the same GP, and rank 0 alone writes."""
    from ..training.trainer import load_trainer

    device = resolve_device(getattr(args, "device", None))
    devices = int(getattr(args, "devices", 1) or 1)
    trainer, _ = load_trainer(
        args.cgat_model, device=device, parallel=devices > 1,
        **({"n_devices": devices, "edge_shards": 1} if devices > 1 else {}))
    tcfg = trainer.cfg
    on_the_fly = bool(getattr(args, "on_the_fly", False))
    graphs = None
    if args.embedding_path:
        x, y = embedding_dataset(args.embedding_path, tcfg.target)
        on_the_fly = False      # the embeddings are there already
        n = len(x)
    else:
        graphs = load_dataset_dir(args.data_path or tcfg.data_path,
                                  fea_path=tcfg.fea_path,
                                  max_neighbor_number=tcfg.max_nbr,
                                  target=tcfg.target)
        y = np.asarray([g.target for g in graphs], np.float32)
        n = len(graphs)
        x = None if on_the_fly else trainer.embeddings(graphs)

    tr, va, _ = split_dataset(n, seed=args.seed)
    mean = float(np.mean(y[tr]))
    std = float(np.std(y[tr], ddof=1)) if len(tr) > 1 else 1.0
    cfg = GPConfig(zero_mean=args.zero_mean)
    if on_the_fly:
        gp_params, history = fit_gp_streaming(
            trainer.model, [graphs[i] for i in tr], mean=mean, std=std,
            num_inducing=args.inducing_points, epochs=args.epochs,
            batch_size=args.batch_size, learning_rate=args.learning_rate,
            seed=args.seed, cfg=cfg, max_nbr=tcfg.max_nbr,
            node_bucket=tcfg.node_bucket,
            num_comp_slots=tcfg.num_comp_slots)
        x_va = trainer.embeddings([graphs[i] for i in va])
    else:
        gp_params, history = fit_gp(
            x[tr], (y[tr] - mean) / std, num_inducing=args.inducing_points,
            epochs=args.epochs, batch_size=args.batch_size,
            learning_rate=args.learning_rate, seed=args.seed, cfg=cfg,
            device=trainer.device)
        x_va = x[va]

    gp_device = gp_params.inducing.device
    with torch.no_grad():
        mu, _ = gp_predict_f(gp_params, torch.as_tensor(
            np.asarray(x_va, np.float32), device=gp_device), cfg)
    pred = mu.cpu().numpy() * std + mean
    val_mae = float(np.mean(np.abs(pred - y[va]))) if len(va) else float("nan")
    print(f"gp val mae: {val_mae:.4f}")

    out = {"params": gp_params.map(lambda t: t.cpu().numpy()),
           "mean": mean, "std": std, "zero_mean": args.zero_mean,
           "val_mae": val_mae, "history": history}
    if trainer.is_main:
        with gzip.open(args.out, "wb") as f:
            pickle.dump(out, f)
        print(f"wrote {args.out}")
    return out


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's GP pickle into the port's ``GPParams``,
    without importing the JAX package."""

    def find_class(self, module, name):
        if (module, name) == ("cgat_tpu.uncertainty.gp", "GPParams"):
            return GPParams
        return super().find_class(module, name)


def load_gp(path: str, device=None):
    """A GP pickle written by ``train_gp_from_checkpoint`` of either
    package: (its parameters as f32 tensors on ``device``, the card
    unless the caller asks for the CPU, and the whole record)."""
    device = resolve_device(device)
    with gzip.open(path, "rb") as f:
        d = _Unpickler(f).load()
    return d["params"].map(lambda a: torch.as_tensor(
        np.asarray(a, np.float32), device=device)), d
