"""The plain reference against the port's CPU path at tiny widths, in f32:
the forward, the loss, the gradients, one AdamW step and one SVGP step;
its parameter names against the model's; the seeded weights; the
controls' roundings."""
import numpy as np
import pytest
import torch

from cgat_tpu_torch.data.batching import CrystalGraph, collate
from cgat_tpu_torch.models.cgat import CGATConfig, CGAtNet
from cgat_tpu_torch.training import TrainerConfig, make_optimizer
from cgat_tpu_torch.training.optim import project_params
from cgat_tpu_torch.uncertainty import gp as port_gp
from harness import traffic, weights
from reference import model as ref_model
from reference import optim as ref_optim
from reference import svgp
from reference.precision import Precision

TINY = {"orig_elem_fea_len": 200, "elem_fea_len": 16, "n_graph": 2,
        "nbr_embedding_size": 16, "neighbor_number": 24, "mean_pooling": False,
        "rezero": True, "msg_heads": 2, "update_edges": True,
        "vector_attention": True, "global_vector_attention": True,
        "n_graph_roost": 2, "no_hyper": True, "dropout": 0.0,
        "out_hidden": [32, 32, 16], "compute_dtype": "float32"}


def _port(cfg=TINY):
    return CGAtNet(CGATConfig(**{**cfg, "out_hidden": tuple(
        cfg["out_hidden"])}))


def _setup(seed=4, n=12):
    crystals = traffic.make_crystals(seed, 40, atoms=(4, 20))
    idx = np.arange(3, 3 + n)
    graphs = traffic.to_graphs(crystals, CrystalGraph)
    batch = collate([graphs[i] for i in idx], num_graphs=n + 2,
                    max_degree=24)
    P = weights.make_weights(ref_model.param_shapes(TINY), seed, "cpu")
    # the ReZero gates at 0 would hide the head's branches: open them
    for k in P:
        if k.endswith(".alpha"):
            P[k] = torch.full_like(P[k], 0.3)
    port = _port()
    port.load_state_dict({k: v.clone() for k, v in P.items()}, strict=True)
    return crystals, idx, batch, P, port


@pytest.mark.parametrize("cfg", [TINY, {**TINY, "elem_fea_len": 128,
                                        "nbr_embedding_size": 128,
                                        "msg_heads": 5, "n_graph": 5,
                                        "n_graph_roost": 3,
                                        "out_hidden": [1024, 1024, 512, 512,
                                                       256, 256, 128]}])
def test_parameter_names_and_shapes_are_the_models(cfg):
    want = {k: tuple(v.shape) for k, v in _port(cfg).state_dict().items()}
    assert ref_model.param_shapes(cfg) == want


def test_forward_and_embeddings_match_the_port():
    crystals, idx, batch, P, port = _setup()
    net = ref_model.CGAT(TINY)
    b = ref_model.make_batch(crystals, idx, "cpu")
    with torch.no_grad():
        emb = net.embed(P, b)
        out = net.head(P, emb)
        pe = port(batch, return_graph_embedding=True)
        po = port(batch)
    n = len(idx)
    torch.testing.assert_close(emb, pe[:n], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out, po[:n], rtol=1e-4, atol=1e-5)


def test_loss_gradients_and_adamw_step_match_the_port():
    crystals, idx, batch, P, port = _setup()
    mean, std = 0.3, 1.7
    # the port's step: the trainer's criterion, backward, AdamW, projection
    out = port(batch)
    target = (batch.target - mean) / std
    mask = batch.graph_mask
    loss_port = (torch.where(mask, (out[:, 0] - target).abs(),
                             torch.zeros(())).sum() / mask.sum())
    opt = make_optimizer(TrainerConfig(learning_rate=1e-3,
                                       weight_decay=1e-2),
                         list(port.parameters()))
    opt.zero_grad()
    loss_port.backward()
    port_grads = {k: (p.grad.clone() if p.grad is not None
                      else torch.zeros_like(p))
                  for k, p in port.named_parameters()}
    opt.apply()
    project_params(port)
    # the reference's
    for v in P.values():
        v.requires_grad_(True)
    net = ref_model.CGAT(TINY)
    b = ref_model.make_batch(crystals, idx, "cpu")
    loss = ref_model.l1_loss(net.forward(P, b), b, mean, std)
    g = ref_optim.grads_of(loss, P)
    assert float(loss.detach()) == pytest.approx(float(loss_port), rel=1e-5)
    for k, pg in port_grads.items():
        torch.testing.assert_close(g.get(k, torch.zeros_like(pg)), pg,
                                   rtol=1e-3, atol=1e-6, msg=k)
    ref_optim.AdamW(P, 1e-3, weight_decay=1e-2).step(g)
    state = dict(port.named_parameters())
    worst = max(float((P[k] - state[k]).abs().max()) for k in P)
    # an Adam step moves a weight by about the learning rate wherever its
    # gradient is not nought; rounding may flip the tiniest few
    assert worst < 2.5e-3
    agree = np.mean([float((P[k] - state[k]).abs().max()) < 1e-6
                     for k in P])
    assert agree > 0.9


def test_svgp_step_matches_the_port():
    torch.manual_seed(0)
    x = torch.randn(30, 12)
    y = torch.randn(30)
    z = x[:8].clone()
    cfg = port_gp.GPConfig()
    fit = port_gp.GPFit(port_gp.init_gp(z.numpy(), cfg, "cpu"), cfg, 1e-2,
                        lambda p, b: port_gp.elbo(p, b[0], b[1], 100, cfg),
                        torch.device("cpu"))
    loss_port = float(fit.step((x, y)))
    G = svgp.init(z)
    for v in G.values():
        v.requires_grad_(True)
    loss = svgp.neg_elbo(G, x, y, 100)
    assert float(loss) == pytest.approx(loss_port, rel=1e-5)
    ref_optim.AdamW(G, 1e-2, decoupled=False).step(
        ref_optim.grads_of(loss, G))
    for name, t in fit.params.named():
        torch.testing.assert_close(G[name].detach(), t.detach(), rtol=1e-4,
                                   atol=1e-6, msg=name)


def test_weights_follow_the_init_rules_and_the_seed():
    shapes = ref_model.param_shapes(TINY)
    a = weights.make_weights(shapes, 2 ** 40 + 3, "cpu")
    b = weights.make_weights(shapes, 2 ** 40 + 3, "cpu")
    c = weights.make_weights(shapes, 2 ** 40 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embedding.weight"], c["embedding.weight"])
    assert set(a) == set(shapes)
    for k, v in a.items():
        assert tuple(v.shape) == shapes[k]
        if k.endswith(".alpha"):
            assert torch.all(v == 0)
        elif k.endswith(".damping"):
            assert torch.all((v >= 0) & (v < 1))
        elif k.endswith(".bias"):
            fan_in = shapes[k[:-4] + "weight"][1]
            assert float(v.abs().max()) <= 1 / fan_in ** 0.5


@pytest.mark.parametrize("name,rel", [("tf32", 2 ** -11),
                                      ("bfloat16", 2 ** -8),
                                      ("float8", 2 ** -4)])
def test_control_roundings_lose_their_bits(name, rel):
    torch.manual_seed(1)
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    exact = a @ b
    got = Precision(name).mm(a, b)
    err = float((got - exact).norm() / exact.norm())
    assert rel / 64 < err < 4 * rel
    a.requires_grad_(True)
    Precision(name).mm(a, b).sum().backward()
    assert a.grad is not None and a.grad.shape == a.shape
