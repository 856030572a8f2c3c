"""CGAtNet's forward and loss in plain PyTorch over a dict of f32
parameters named as the model's ``state_dict`` (hyllios/CGAT
``CGAT/CGAT.py``, ``message_changed.py``, ``Hypernetworksmp.py``,
``roost_message.py``; the default path: ``no_hyper``, vector attention,
heads concatenated, ReZero, no dropout). Real rows only, no padding, no
kernels: the segment softmax is ``scatter_reduce`` and ``index_add``.
Every product goes through a :class:`Precision` (f32 for the reference).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Precision

LEAKY = 0.01
SOFTMAX_EPS = 1e-16
ROOST_EPS = 1e-13
NEG_BIG = -1e30


@dataclasses.dataclass
class Batch:
    """Real rows of a batch of crystals on one device: atoms, edges with
    batch-wide ids, the composition dense per crystal (``R`` the most
    distinct species of a crystal in the batch), targets."""
    nodes: torch.Tensor        # (Nr, orig) f32
    src: torch.Tensor          # (Er,) int64
    dst: torch.Tensor          # (Er,) int64
    shell: torch.Tensor        # (Er,) int64
    node2graph: torch.Tensor   # (Nr,) int64
    comp_fea: torch.Tensor     # (C, R, orig) f32
    comp_weight: torch.Tensor  # (C, R) f32
    comp_mask: torch.Tensor    # (C, R) bool
    target: torch.Tensor       # (C,) f32

    @property
    def num_graphs(self) -> int:
        return self.target.shape[0]


def make_batch(crystals, idx, device) -> Batch:
    """The crystals ``idx`` of a pool (``harness.traffic.Crystals``) as a
    :class:`Batch` on ``device``."""
    idx = np.asarray(idx)
    atoms = [np.arange(crystals.atom_ptr[i], crystals.atom_ptr[i + 1])
             for i in idx]
    n_atoms = crystals.n_atoms[idx]
    base = np.concatenate([[0], np.cumsum(n_atoms)[:-1]])
    k = crystals.max_nbr
    rows = np.concatenate(atoms)
    edge_rows = (rows[:, None] * k + np.arange(k)).reshape(-1)
    offset = np.repeat(base, n_atoms * k)
    r = crystals.comp_ptr[idx + 1] - crystals.comp_ptr[idx]
    R = int(r.max())
    C = len(idx)
    orig = crystals.comp_fea.shape[1]
    comp_fea = np.zeros((C, R, orig), np.float32)
    comp_weight = np.zeros((C, R), np.float32)
    comp_mask = np.zeros((C, R), bool)
    for j, i in enumerate(idx):
        s = crystals.comps(i)
        comp_fea[j, :r[j]] = crystals.comp_fea[s]
        comp_weight[j, :r[j]] = crystals.comp_weight[s]
        comp_mask[j, :r[j]] = True
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    return Batch(
        nodes=t(crystals.atom_fea[rows]),
        src=t(crystals.edge_src[edge_rows].astype(np.int64) + offset),
        dst=t(crystals.edge_dst[edge_rows].astype(np.int64) + offset),
        shell=t(crystals.edge_shell[edge_rows].astype(np.int64)),
        node2graph=t(np.repeat(np.arange(C), n_atoms)),
        comp_fea=t(comp_fea), comp_weight=t(comp_weight),
        comp_mask=t(comp_mask),
        target=t(crystals.target[idx], torch.float32))


# --------------------------------------------------------------- shapes

def _mh(prefix, d_in, d_out, hid, heads):
    return {f"{prefix}.fc_in.weight": (heads * hid, d_in, 1),
            f"{prefix}.fc_in.bias": (heads * hid,),
            f"{prefix}.fc_out.weight": (heads * d_out, hid, 1),
            f"{prefix}.fc_out.bias": (heads * d_out,)}


def _linear(prefix, d_in, d_out, bias=True):
    out = {f"{prefix}.weight": (d_out, d_in)}
    if bias:
        out[f"{prefix}.bias"] = (d_out,)
    return out


def _simple(prefix, d_in, d_out, hidden):
    return {**_linear(f"{prefix}.fcs.0", d_in, hidden),
            **_linear(f"{prefix}.fc_out", hidden, d_out)}


def _hyper_linear(prefix, c, d_in, d_out):
    out = {}
    for k in range(4):
        out.update(_linear(f"{prefix}.hypo_params.net.{k}.net.0", c, c))
    out.update(_linear(f"{prefix}.hypo_params.net.4", c, d_in * d_out + d_out))
    return out


def param_shapes(cfg: dict) -> dict:
    """name -> shape of every parameter of the model ``cfg`` (its widths,
    as the configuration file gives them)."""
    c, heads, nbr = cfg["elem_fea_len"], cfg["msg_heads"], \
        cfg["nbr_embedding_size"]
    orig = cfg["orig_elem_fea_len"]
    cat = 2 * c + nbr
    hid = int(cat / 1.5)
    out = {"embedding.weight": (c, orig),
           "nbr_embedding.weight": (cfg["neighbor_number"] + 1, nbr)}
    for i in range(cfg["n_graph"]):
        p = f"graphs.{i}"
        out.update(_mh(f"{p}.Node.MH_A", cat, c, hid, heads))
        out.update(_mh(f"{p}.Node.MH_M", cat, c, hid, heads))
        if i > 0:
            out[f"{p}.Node.Pooling_NN.damping"] = (1,)
        for j in range(3):
            out.update(_hyper_linear(
                f"{p}.Node.Pooling_NN.Hyper.layers.{j}.hyper_linear", c, c, c))
        out.update(_hyper_linear(f"{p}.Node.Pooling_NN.Hyper.layers.3",
                                 c, c, c))
        ecat = 2 * c + nbr
        ehid = int(ecat / 1.5)
        out.update(_mh(f"{p}.Edge.MH_A", ecat, nbr, ehid, heads))
        out.update(_mh(f"{p}.Edge.MH_M", ecat, nbr, ehid, heads))
        out.update(_simple(f"{p}.Edge.Pooling_NN", nbr, nbr, nbr))
    out.update(_linear("roost.embedding", orig, c - 1))
    for l in range(cfg["n_graph_roost"]):
        p = f"roost.graphs.{l}.pooling.0"
        out[f"{p}.pow"] = (1,)
        out.update(_simple(f"{p}.gate_nn", 2 * c, 1, 256))
        out.update(_simple(f"{p}.message_nn", 2 * c, c, 256))
    out["roost.cry_pool.0.pow"] = (1,)
    out.update(_simple("roost.cry_pool.0.gate_nn", c, 1, 256))
    out.update(_mh("cry_pool.MH_M", c, c, c, heads))
    out.update(_mh("cry_pool.MH_A", 2 * c, c, c, heads))
    dims = [heads * c, *cfg["out_hidden"]]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out.update(_linear(f"output_nn.fcs.{i}", a, b))
        if a != b:
            out.update(_linear(f"output_nn.res_fcs.{i}", a, b, bias=False))
        out[f"output_nn.rezeros.{i}.alpha"] = (1,)
    out.update(_linear("output_nn.fc_out", dims[-1], 2))
    return out


# -------------------------------------------------------------- forward

class CGAT:
    """The forward of the model ``cfg`` over parameters ``P`` with products
    in ``precision``."""

    def __init__(self, cfg: dict, precision: Precision | None = None):
        self.cfg = cfg
        self.p = precision or Precision()

    def linear(self, P, prefix, x, bias=True):
        y = self.p.mm(x, P[f"{prefix}.weight"].t())
        return y + P[f"{prefix}.bias"] if bias else y

    def simple(self, P, prefix, x):
        x = F.leaky_relu(self.linear(P, f"{prefix}.fcs.0", x), LEAKY)
        return self.linear(P, f"{prefix}.fc_out", x)

    def mh(self, P, prefix, x):
        """H networks [Linear, LeakyReLU, Linear] over x (B, d_in) ->
        (B, H, d_out)."""
        H = self.cfg["msg_heads"]
        w_in = P[f"{prefix}.fc_in.weight"][..., 0]
        w_out = P[f"{prefix}.fc_out.weight"][..., 0]
        hid, d_in = w_in.shape[0] // H, w_in.shape[1]
        d_out = w_out.shape[0] // H
        h = self.p.mm(x.unsqueeze(0).expand(H, -1, -1),
                      w_in.view(H, hid, d_in).transpose(1, 2))
        h = F.leaky_relu(h + P[f"{prefix}.fc_in.bias"].view(H, 1, hid),
                         LEAKY)
        y = self.p.mm(h, w_out.view(H, d_out, hid).transpose(1, 2))
        y = y + P[f"{prefix}.fc_out.bias"].view(H, 1, d_out)
        return y.transpose(0, 1)

    def hyper_linear(self, P, prefix, cond, x):
        """A Linear whose weights and bias a Tanh MLP of ``cond`` predicts,
        applied to ``x``."""
        h = cond
        for k in range(4):
            h = torch.tanh(self.linear(
                P, f"{prefix}.hypo_params.net.{k}.net.0", h))
        params = self.linear(P, f"{prefix}.hypo_params.net.4", h)
        d_in = x.shape[1]
        d_out = params.shape[1] // (d_in + 1)
        w = params[:, :d_in * d_out].reshape(-1, d_out, d_in)
        y = self.p.mm(w, x.unsqueeze(-1)).squeeze(-1)
        return y + params[:, d_in * d_out:]

    def hyper_fc(self, P, prefix, cond, x):
        for j in range(3):
            y = self.hyper_linear(P, f"{prefix}.layers.{j}.hyper_linear",
                                  cond, x)
            x = torch.tanh(F.layer_norm(y, y.shape[-1:], eps=1e-5))
        return self.hyper_linear(P, f"{prefix}.layers.3", cond, x)

    @staticmethod
    def segment_softmax_sum(alpha, m, ids, n):
        """softmax of ``alpha`` over the rows of each segment (every
        trailing position apart), times ``m``, summed into ``n`` rows."""
        idx = ids.view(-1, *([1] * (alpha.dim() - 1))).expand_as(alpha)
        mx = torch.full((n,) + alpha.shape[1:], NEG_BIG, dtype=alpha.dtype,
                        device=alpha.device).scatter_reduce(
            0, idx, alpha, "amax", include_self=True)
        ex = torch.exp(alpha - mx[ids])
        den = torch.zeros_like(mx).index_add(0, ids, ex)
        num = torch.zeros_like(mx).index_add(0, ids, ex * m)
        return num / (den + SOFTMAX_EPS)

    def roost(self, P, b: Batch):
        w, mask = b.comp_weight, b.comp_mask
        fea = torch.cat([self.linear(P, "roost.embedding", b.comp_fea),
                         w[..., None]], dim=-1)
        C, R, Fd = fea.shape
        eye = torch.eye(R, dtype=torch.bool, device=fea.device)
        pair_mask = (mask[:, :, None] & mask[:, None, :] & ~eye)[..., None]
        nbr_w = w[:, None, :, None].expand(C, R, R, 1)
        for l in range(self.cfg["n_graph_roost"]):
            p = f"roost.graphs.{l}.pooling.0"
            pair = torch.cat([fea[:, :, None, :].expand(C, R, R, Fd),
                              fea[:, None, :, :].expand(C, R, R, Fd)], dim=-1)
            g = _weighted_attention(self.simple(P, f"{p}.gate_nn", pair),
                                    nbr_w, P[f"{p}.pow"], pair_mask, 2)
            fea = (g * self.simple(P, f"{p}.message_nn", pair)).sum(2) + fea
        g = _weighted_attention(
            self.simple(P, "roost.cry_pool.0.gate_nn", fea), w[..., None],
            P["roost.cry_pool.0.pow"], mask[..., None], 1)
        return (g * fea).sum(1)

    def embed(self, P, b: Batch):
        """The graph embeddings (C, heads * elem_fea_len)."""
        cfg = self.cfg
        n = b.nodes.shape[0]
        e = P["nbr_embedding.weight"][b.shell]
        x = self.linear(P, "embedding", b.nodes, bias=False)
        x0 = x
        for i in range(cfg["n_graph"]):
            p = f"graphs.{i}"
            m_cat = torch.cat([x[b.dst], e, x[b.src]], dim=-1)
            alpha = self.mh(P, f"{p}.Node.MH_A", m_cat)
            msg = self.mh(P, f"{p}.Node.MH_M", m_cat)
            aggr = self.segment_softmax_sum(alpha, msg, b.dst, n).mean(1)
            hyper = f"{p}.Node.Pooling_NN.Hyper"
            if i == 0:
                upd = self.hyper_fc(P, hyper, x, aggr)
            else:
                d = P[f"{p}.Node.Pooling_NN.damping"]
                d = d + (d.clamp(0.0, 1.0) - d).detach()
                upd = self.hyper_fc(P, hyper, d * x0 + (1.0 - d) * aggr, aggr)
            e = e + self.simple(P, f"{p}.Edge.Pooling_NN", e)
            x = x + upd
        crys = self.roost(P, b)
        msg = self.mh(P, "cry_pool.MH_M", x)
        alpha = self.mh(P, "cry_pool.MH_A",
                        torch.cat([x, crys[b.node2graph]], dim=-1))
        agg = self.segment_softmax_sum(alpha, msg, b.node2graph,
                                       b.num_graphs)
        return agg.reshape(b.num_graphs, -1)

    def head(self, P, x):
        dims = [self.cfg["msg_heads"] * self.cfg["elem_fea_len"],
                *self.cfg["out_hidden"]]
        for i, (a, c) in enumerate(zip(dims[:-1], dims[1:])):
            branch = torch.relu(self.linear(P, f"output_nn.fcs.{i}", x))
            branch = P[f"output_nn.rezeros.{i}.alpha"] * branch
            skip = (self.linear(P, f"output_nn.res_fcs.{i}", x, bias=False)
                    if a != c else x)
            x = branch + skip
        return self.linear(P, "output_nn.fc_out", x)

    def forward(self, P, b: Batch):
        """(C, 2): the normalised prediction and ``log_std``."""
        return self.head(P, self.embed(P, b))


def _weighted_attention(gate, weights, pow_, mask, dim):
    gate = torch.where(mask, gate, torch.full_like(gate, NEG_BIG))
    gmax = gate.amax(dim=dim, keepdim=True).clamp(min=NEG_BIG)
    g = torch.exp(gate - gmax)
    w = torch.where(mask, weights, torch.ones_like(weights))
    g = torch.where(mask, (w ** pow_) * g, torch.zeros_like(g))
    return g / (g.sum(dim=dim, keepdim=True) + ROOST_EPS)


def l1_loss(out, b: Batch, mean: float, std: float, keep=None):
    """The trainer's criterion: the mean absolute error of the normalised
    prediction against the normalised target (over the first ``keep``
    crystals, where given)."""
    return (out[:keep, 0] - (b.target[:keep] - mean) / std).abs().mean()
