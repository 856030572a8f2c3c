"""CGAtNet with the source's live edge update (``no_hyper=False``;
hyllios/CGAT ``CGAT/CGAT.py`` ``GATConvEdges`` :115-230, its live branch,
and ``Hypernetworksmp.py`` ``H_Net_0``/``H_Net``), in plain PyTorch over a
dict of f32 parameters named as the model's ``state_dict``. Everything
but the edge update is :mod:`reference.model`'s, imported.

Edge layer l = 0 .. n_graph - 2, on the real edges, from the node
features before that layer's node update::

    m = [x_src, e, x_dst]                              (E, 2c + nbr)
    a = exp(MH_A(m)); alpha = a / sum_heads(a)         (E, heads, nbr)
    g = mean_heads(alpha * MH_M(m))                    (E, nbr)
    layer 0:  e <- e + HNet0(cond = e, x = g)
    later:    e <- e + HNet(cond = d e_0 + (1 - d) g, x = g)

``d`` the layer's ``damping`` clamped to [0, 1] with a straight-through
gradient; each HNet is ``hyper_fc`` (three ``hyper_linear`` each with a
LayerNorm without affine and a tanh, then a fourth ``hyper_linear``). The
attention is normalised across heads, not over a segment, with no max
subtracted (CGAT.py:214-219). Nothing reads the last layer's edge update:
it is not computed and its parameters get no gradient. Every product goes
through the :class:`Precision`.
"""
from __future__ import annotations

import torch

from . import model as base
from .model import Batch, l1_loss, make_batch  # noqa: F401  (the driver's)


def param_shapes(cfg: dict) -> dict:
    """name -> shape of every parameter of the model ``cfg`` (the port's
    ``state_dict`` names): :func:`reference.model.param_shapes` with each
    edge MLP (``Edge.Pooling_NN``) replaced, under ``no_hyper`` False, by
    the edge hypernetwork in the port's order (``damping`` from layer 1
    on, then four ``hyper_linear`` of ``nbr`` -> ``nbr``), the last
    layer's included."""
    shapes = base.param_shapes(cfg)
    if cfg.get("no_hyper", True):
        return shapes
    nbr = cfg["nbr_embedding_size"]
    out = {}
    for name, shape in shapes.items():
        layer, _, rest = name.partition(".Edge.Pooling_NN.")
        if not rest:
            out[name] = shape
            continue
        if not rest.startswith("fcs.0.weight"):
            continue                    # the MLP's other tensors: dropped
        p = f"{layer}.Edge.Pooling_NN"
        if int(layer.rsplit(".", 1)[1]) > 0:
            out[f"{p}.damping"] = (1,)
        for j in range(3):
            out.update(base._hyper_linear(
                f"{p}.Hyper.layers.{j}.hyper_linear", nbr, nbr, nbr))
        out.update(base._hyper_linear(f"{p}.Hyper.layers.3", nbr, nbr, nbr))
    return out


class CGAT(base.CGAT):
    """:class:`reference.model.CGAT` with the live edge update under
    ``no_hyper`` False."""

    def edge_update(self, P, i: int, x, e, e0, b: Batch):
        """The update of layer ``i``'s edge features ``e`` (the node
        features ``x`` before the layer's node update, ``e0`` the first
        layer's edge features)."""
        p = f"graphs.{i}.Edge"
        m_cat = torch.cat([x[b.src], e, x[b.dst]], dim=-1)
        a = torch.exp(self.mh(P, f"{p}.MH_A", m_cat))
        alpha = a / a.sum(dim=1, keepdim=True)
        g = (alpha * self.mh(P, f"{p}.MH_M", m_cat)).mean(1)
        hyper = f"{p}.Pooling_NN.Hyper"
        if i == 0:
            return self.hyper_fc(P, hyper, e, g)
        d = P[f"{p}.Pooling_NN.damping"]
        d = d + (d.clamp(0.0, 1.0) - d).detach()
        return self.hyper_fc(P, hyper, d * e0 + (1.0 - d) * g, g)

    def embed(self, P, b: Batch):
        """The graph embeddings (C, heads * elem_fea_len)."""
        cfg = self.cfg
        if cfg.get("no_hyper", True):
            return super().embed(P, b)
        n = b.nodes.shape[0]
        e = P["nbr_embedding.weight"][b.shell]
        x = self.linear(P, "embedding", b.nodes, bias=False)
        x0, e0 = x, e
        last = cfg["n_graph"] - 1
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
            if i < last:
                e = e + self.edge_update(P, i, x, e, e0, b)
            x = x + upd
        crys = self.roost(P, b)
        msg = self.mh(P, "cry_pool.MH_M", x)
        alpha = self.mh(P, "cry_pool.MH_A",
                        torch.cat([x, crys[b.node2graph]], dim=-1))
        agg = self.segment_softmax_sum(alpha, msg, b.node2graph,
                                       b.num_graphs)
        return agg.reshape(b.num_graphs, -1)

