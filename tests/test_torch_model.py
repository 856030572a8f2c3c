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
                                          "mean_pooling": True}])
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


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError):
        CGAtNet(CGATConfig(**SMALL, no_hyper=False))
    with pytest.raises(NotImplementedError):
        CGAtNet(CGATConfig(**SMALL, update_edges=False))
