"""The port's CGAtNet against the JAX package's, on the same weights and
batch: f32 against the XLA path, bf16 against the Pallas path (interpret
mode), plus the weight bridge and the seeded initialiser."""
import numpy as np
import jax
import pytest
import torch

from cgat_tpu.data import collate as jcollate
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.models import CGAtNet as JNet
from cgat_tpu.models.host_init import init_params_host
from cgat_tpu.ops import attention as jatt
from cgat_tpu.serving.artifact import _flatten_params
from cgat_tpu.tools.import_torch import export_state_dict
from cgat_tpu_torch.data import collate
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import (CGATConfig, CGAtNet, init_state_dict,
                                   state_dict_from_jax)
from cgat_tpu_torch.models.cgat import DropoutKey, dropout
from cgat_tpu_torch.ops.kernels import hyper_apply, mh_network
from cgat_tpu_torch.ops.kernels import segment_attention

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
             nbr_embedding_size=8, neighbor_number=6, msg_heads=2,
             n_graph_roost=1, out_hidden=(32, 32, 16))
# tests/test_mh_kernel.py:93-99: 128-wide, 2 layers, 5 heads, bf16 — all
# three JAX kernels engage (interpret mode) and all three port kernels do
BF16 = dict(orig_elem_fea_len=16, elem_fea_len=128, n_graph=2,
            nbr_embedding_size=128, neighbor_number=16, msg_heads=5,
            n_graph_roost=1, out_hidden=(16,), compute_dtype="bfloat16")


def _pair(kw, seed=0, n=5, atoms=(3, 7), bucket=8):
    nbr, fea = kw["neighbor_number"], kw["orig_elem_fea_len"]
    jbatch = jcollate(jrandom_graphs(seed, n, n_atoms_range=atoms,
                                     max_nbr=nbr, orig_fea=fea),
                      max_nbr=nbr, node_bucket=bucket)
    batch = collate(random_graphs(seed, n, n_atoms_range=atoms, max_nbr=nbr,
                                  orig_fea=fea),
                    max_nbr=nbr, node_bucket=bucket)
    jmodel = JNet(JConfig(**kw))
    params = init_params_host(jmodel, jbatch, seed=seed)
    cfg = CGATConfig(**kw)
    model = CGAtNet(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return jmodel, params, jbatch, model.to_compute_dtype().eval(), batch


@pytest.mark.parametrize("variant", [{}, {"vector_attention": False,
                                          "global_vector_attention": False,
                                          "mean_pooling": True},
                                     {"no_hyper": False},
                                     {"no_hyper": False,
                                      "vector_attention": False},
                                     {"update_edges": False},
                                     {"split_projection": True},
                                     {"remat": True}, {"hyper_remat": True},
                                     {"dropout": 0.1}])
def test_f32_forward_matches_jax(variant):
    kw = {**SMALL, **variant}
    jmodel, params, jbatch, model, batch = _pair(kw)
    apply = lambda **k: np.asarray(jmodel.apply({"params": params}, jbatch,
                                                **k))
    with torch.no_grad():
        got = {"out": model(batch).numpy(),
               "emb": model(batch, return_graph_embedding=True).numpy(),
               "pen": model(batch, last_layer=False).numpy()}
    want = {"out": apply(),
            "emb": apply(return_graph_embedding=True),
            "pen": apply(last_layer=False)}
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def bf16_pair():
    jmodel, params, jbatch, model, batch = _pair(BF16, n=6, atoms=(5, 9))
    old = jatt.get_backend()
    jatt.set_backend("pallas")
    try:
        want = np.asarray(jmodel.apply({"params": params}, jbatch),
                          np.float32)
    finally:
        jatt.set_backend(old)
    return model, batch, want


def test_bf16_forward_matches_jax_pallas(bf16_pair):
    model, batch, want = bf16_pair
    with torch.no_grad():
        got = model(batch)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2,
                               atol=5e-2 * np.abs(want).max())


def test_bf16_forward_goes_through_every_kernel(bf16_pair, monkeypatch):
    """On CPU tensors each wrapper runs its plain version; count those
    calls to show the forward takes every kernel path (2 MH nets, 1
    aggregation and 4 HyperLinears per layer, plus the crystal pool)."""
    model, batch, _ = bf16_pair
    calls = {"mh": 0, "seg": 0, "hyper": 0}

    def counting(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counting(mh_network, "mh_network_plain", "mh")
    counting(segment_attention, "segment_attention_plain", "seg")
    counting(hyper_apply, "hyper_apply_plain", "hyper")
    with torch.no_grad():
        model(batch)
    n = BF16["n_graph"]
    assert calls == {"mh": 2 * n, "seg": n + 1, "hyper": 4 * n}


def test_state_dict_from_jax_equals_export_state_dict():
    jmodel, params, _, model, _ = _pair(SMALL)
    ref = export_state_dict(params, JConfig(**SMALL))
    for tree in (params, _flatten_params(params)):
        sd = state_dict_from_jax(tree, CGATConfig(**SMALL))
        assert list(sd) == list(ref)
        for k, v in ref.items():
            assert sd[k].dtype == torch.float32
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the key set is the module's own: strict loading succeeds both ways
    assert set(CGAtNet(CGATConfig(**SMALL)).state_dict()) == set(ref)
    assert set(model.state_dict()) == set(ref)


def test_reference_key_layout():
    sd = CGAtNet(CGATConfig(n_graph=2, n_graph_roost=1)).state_dict()
    assert sd["graphs.0.Node.MH_A.fc_in.weight"].shape == (5 * 256, 384, 1)
    assert sd["nbr_embedding.weight"].shape == (25, 128)
    hyper = ("graphs.1.Node.Pooling_NN.Hyper.layers.3.hypo_params.net.4"
             ".weight")
    assert sd[hyper].shape == (128 * 128 + 128, 128)
    assert ("graphs.0.Node.Pooling_NN.Hyper.layers.0.hyper_linear.hypo_params"
            ".net.0.net.0.weight") in sd
    assert "graphs.1.Node.Pooling_NN.damping" in sd
    assert "graphs.0.Node.Pooling_NN.damping" not in sd
    assert "roost.graphs.0.pooling.0.gate_nn.fcs.0.weight" in sd
    assert sd["cry_pool.MH_A.fc_in.weight"].shape == (5 * 128, 256, 1)
    assert "output_nn.rezeros.6.alpha" in sd
    assert "output_nn.res_fcs.0.weight" in sd
    assert "output_nn.res_fcs.1.weight" not in sd   # 1024 -> 1024 identity


def test_init_state_dict_follows_host_init_rules():
    model = CGAtNet(CGATConfig(**SMALL))
    sd = init_state_dict(model, seed=3)
    model.load_state_dict(sd, strict=True)
    again = init_state_dict(model, seed=3)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    for k, v in sd.items():
        if k.endswith("alpha"):
            assert (v == 0).all(), k
        elif k.endswith("damping"):
            assert ((v >= 0) & (v < 1)).all(), k
        elif k.endswith(".bias"):
            bound = 1 / np.sqrt(sd[k[:-4] + "weight"].shape[1])
            assert v.abs().max() <= bound, k
        elif "hypo_params" in k and k.endswith("weight"):
            std = float(v.std())
            want = np.sqrt(2 / v.shape[1])
            if ".net.0.weight" not in k:
                want *= 0.1          # the FCBlock's last Linear
            assert 0.8 * want < std < 1.2 * want, (k, std, want)
        elif k.endswith("weight") and k != "nbr_embedding.weight":
            assert v.abs().max() <= 1 / np.sqrt(v.shape[1]), k


def test_bf16_hyper_edge_forward_matches_jax_f32():
    """``no_hyper=False`` in bf16, 128 wide: every edge row runs the edge
    HNets (the hyper_apply plain versions on E rows here), held against
    cgat_tpu's f32 XLA forward on the same weights (ADVICE.md:3) with the
    bf16 tolerances of the bf16 forward test."""
    kw = {**BF16, "no_hyper": False}
    jmodel, params, jbatch, model, batch = _pair(
        {**kw, "compute_dtype": "float32"}, n=6, atoms=(5, 9))
    want = np.asarray(jmodel.apply({"params": params}, jbatch), np.float32)
    cfg = CGATConfig(**kw)
    bf16 = CGAtNet(cfg)
    bf16.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    with torch.no_grad():
        got = bf16.to_compute_dtype().eval()(batch)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2,
                               atol=5e-2 * np.abs(want).max())


def _count_plain(monkeypatch):
    calls = {}
    for mod in (mh_network, hyper_apply, segment_attention):
        for name in dir(mod):
            if name.endswith("_plain"):
                real = getattr(mod, name)

                def counted(*a, _real=real, _name=name, **k):
                    calls[_name] = calls.get(_name, 0) + 1
                    return _real(*a, **k)
                monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("variant,extra", [
    ({"remat": True}, {"mh_network_plain": 2, "segment_attention_plain": 1,
                       "hyper_apply_plain": 4}),
    ({"hyper_remat": True}, {"hyper_apply_plain": 4}),
    ({"no_hyper": False}, {"hyper_apply_plain": 4}),
])
def test_variant_grads_and_kernel_calls(variant, extra, monkeypatch):
    """A bf16 backward of the 128-wide 2-layer model under remat,
    hyper_remat and no_hyper=False: remat and hyper_remat give the same
    loss and grads as the default model (the recompute is the same
    function), and each layer runs ``extra`` more forward plain kernel
    versions than in the default model's step (the recompute, or the edge
    HNets: all but the last layer's, whose edge update nothing reads); the
    edge HNets of a hyper-edge model get finite grads, the last layer's
    none."""
    _, params, _, _, batch = _pair(BF16, n=4, atoms=(5, 9))
    results = {}
    for name, cfg in (("default", CGATConfig(**BF16)),
                      ("variant", CGATConfig(**BF16, **variant))):
        model = CGAtNet(cfg)
        sd = (state_dict_from_jax(params, cfg)
              if name == "default" or "no_hyper" not in variant
              else init_state_dict(model, seed=1))
        model.load_state_dict(sd, strict=True)
        calls = _count_plain(monkeypatch)
        loss = model(batch)[:, 0].float().square().sum()
        loss.backward()
        results[name] = (float(loss.detach()), dict(calls),
                         {n: p.grad for n, p in model.named_parameters()})
        monkeypatch.undo()
    (l0, c0, g0), (l1, c1, g1) = results["default"], results["variant"]
    layers = BF16["n_graph"] - ("no_hyper" in variant)
    for k in ("mh_network_plain", "segment_attention_plain",
              "hyper_apply_plain"):
        assert c1[k] == c0[k] + layers * extra.get(k, 0), (k, c1)
    if "no_hyper" in variant:
        edge = [g for n, g in g1.items()
                if n.startswith("graphs.0.Edge.Pooling_NN.")]
        assert np.isfinite(l1) and edge and all(
            g is not None and torch.isfinite(g).all() for g in edge)
        assert all(g is None for n, g in g1.items()
                   if n.startswith("graphs.1.Edge."))
        return
    assert l1 == l0
    for n, g in g0.items():
        assert (g is None) == (g1[n] is None), n
        if g is not None:
            assert torch.equal(g, g1[n]), n


def test_dropout_keep_rate_scaling_and_replay():
    """Kept with probability 1 - p and scaled by 1/(1 - p); the same
    (seed, site) path and device step draw the same mask, another step or
    another path another one; p = 0 in training and any p in eval give
    the default forward's bits. The masks cannot be JAX's bit for bit
    (the port's Philox, not JAX's threefry), so a training forward under
    dropout is not held against cgat_tpu; its eval forward is, in
    ``test_f32_forward_matches_jax``."""
    def key(path, step):
        return DropoutKey(path, torch.tensor(step, dtype=torch.int64))

    x = torch.ones(200_000)
    y = dropout(x, 0.25, key((0, 3), 7))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(y, dropout(x, 0.25, key((0, 3), 7)))
    assert not torch.equal(y, dropout(x, 0.25, key((0, 3), 8)))
    assert not torch.equal(y, dropout(x, 0.25, key((1, 3), 7)))
    _, params, _, _, batch = _pair(SMALL)
    outs = {}
    for p, mode in ((0.0, "eval"), (0.0, "train"), (0.3, "eval"),
                    (0.3, "train")):
        cfg = CGATConfig(**SMALL, dropout=p)
        model = CGAtNet(cfg)
        model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
        model.train(mode == "train")
        with torch.no_grad():
            outs[p, mode] = model(batch, dropout_key=key((0,), 5))
    assert torch.equal(outs[0.0, "train"], outs[0.0, "eval"])
    assert torch.equal(outs[0.3, "eval"], outs[0.0, "eval"])
    assert not torch.equal(outs[0.3, "train"], outs[0.0, "eval"])
    with pytest.raises(ValueError, match="dropout_key"):
        model(batch)


def test_node_only_layout_and_converter():
    """``update_edges=False``: ``graphs.{i}.Node`` only, which JAX's
    node-only tree maps to with strict loading; a JAX tree with an Edge
    subtree for such a config raises."""
    kw = {**SMALL, "update_edges": False}
    _, params, _, model, _ = _pair(kw)
    keys = list(model.state_dict())
    assert not any(".Edge." in k for k in keys)
    assert any(k.startswith("graphs.1.Node.") for k in keys)
    _, full, _, _, _ = _pair(SMALL)
    with pytest.raises(ValueError, match="graph_0_Edge"):
        state_dict_from_jax(full, CGATConfig(**kw))
    sd = init_state_dict(CGAtNet(CGATConfig(**SMALL, no_hyper=False)))
    assert sd["graphs.0.Edge.Pooling_NN.Hyper.layers.3.hypo_params.net.4"
              ".weight"].shape == (8 * 8 + 8, 8)
    assert "graphs.1.Edge.Pooling_NN.damping" in sd
