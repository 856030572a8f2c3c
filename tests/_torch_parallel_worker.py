"""One rank of a gloo world for tests/test_torch_parallel.py.

Launched once a rank by the test with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and one
torch thread, on the CPU (gloo), or with ``spec["device"] = "cuda"`` one
card a rank (NCCL); imports torch and the port, never JAX:

    python tests/_torch_parallel_worker.py step <spec.json>
    python tests/_torch_parallel_worker.py fit <spec.json>
    python tests/_torch_parallel_worker.py gp <spec.json>
    python tests/_torch_parallel_worker.py spy <spec.json>

``step``: one parallel AdamW step of the tiny model from the weights in
``spec["state_dict"]`` on the first group of ``spec["graphs"]`` random
graphs; rank 0 saves the global loss, the gradient summed over the world
and the parameters after the step to ``spec["out"]``. ``fit``: a
``Trainer`` with ``n_devices`` ranks fits 2 epochs into ``spec["ckpt_dir"]``
(over the shards of ``spec["stream"]``'s ``data_path`` when it is given,
``streaming=True``, else on random graphs); every rank saves its
metrics, the test split's parallel evaluation and embeddings, and rank 0
the final weights. ``gp``: ``cli.train_gp`` with ``spec["argv"]`` as one
rank of the world, then this rank's embeddings of ``spec["data"]`` by the
run's trainer across the mesh, saved to ``rank<r>.npz`` beside
``spec["out"]``. ``spy``: an edge-sharded forward and backward of the
tiny model under ``dropout=0.1`` on the first group, once with a spy that
counts every ``Tensor.index_add_`` outside the segment-sum kernel's plain
version and every ``segment_sum`` without a plan, and once with every
plan dropped (the atomics path); rank 0 saves both runs' loss, summed
gradient and counts.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

TINY = dict(orig_elem_fea_len=12, elem_fea_len=8, n_graph=2,
            nbr_embedding_size=8, neighbor_number=4, msg_heads=2,
            n_graph_roost=1, out_hidden=(8,))
GRAPHS = dict(n_atoms_range=(3, 6), max_nbr=4, orig_fea=12)
MEAN, STD = 0.1, 1.3


def step(spec: dict) -> None:
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.models import CGATConfig
    from cgat_tpu_torch.parallel import (ParallelLoader,
                                         global_loss_and_metrics,
                                         reduce_gradients)
    from cgat_tpu_torch.training import Trainer, TrainerConfig
    n, S = spec["n_devices"], spec["edge_shards"]
    t = Trainer(TrainerConfig(n_devices=n, edge_shards=S, optim="AdamW",
                              learning_rate=1e-3),
                CGATConfig(**TINY), mean=MEAN, std=STD,
                device=spec.get("device", "cpu"))
    t.init_state(torch.load(spec["state_dict"]))
    mesh = t.mesh
    loader = ParallelLoader(random_graphs(0, spec["graphs"], **GRAPHS), 4,
                            mesh.dp.size, max_nbr=4, node_bucket=8,
                            num_comp_slots=8, edge_shards=S,
                            process_index=mesh.dp.index,
                            process_count=mesh.dp.size)
    batch = t.rank_batch(next(iter(loader)))
    # the reduced gradient, apart from the step (which reduces its own)
    out = t.model(batch, edge_group=mesh.edge if S > 1 else None)
    loss, _ = global_loss_and_metrics(out, batch, MEAN, STD, t.criterion,
                                      mesh)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in t.model.parameters()]
    reduce_gradients(grads, mesh.world)
    grad = torch.cat([g.reshape(-1) for g in grads]).cpu()
    metrics = t.train_step(batch)
    if torch.distributed.get_rank() == 0:
        torch.save({"loss": float(metrics["loss"]), "grad": grad,
                    "params": {k: v.cpu() for k, v in
                               t.model.state_dict().items()}}, spec["out"])


def fit(spec: dict) -> None:
    import numpy as np
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.models import CGATConfig
    from cgat_tpu_torch.training import Trainer, TrainerConfig
    stream = spec.get("stream")
    t = Trainer(TrainerConfig(n_devices=spec["n_devices"],
                              edge_shards=spec["edge_shards"], batch_size=4,
                              epochs=2, check_val_every_n_epoch=1, max_nbr=4,
                              node_bucket=8, num_comp_slots=8,
                              ckpt_dir=spec["ckpt_dir"], run_name="r",
                              **(dict(stream, streaming=True,
                                      target="e_above_hull")
                                 if stream else {})),
                CGATConfig(**{**TINY, "orig_elem_fea_len": 200}
                           if stream else TINY),
                None if stream else random_graphs(0, 40, **GRAPHS),
                device="cpu")
    history = t.fit()
    rank = torch.distributed.get_rank()
    if rank == 0:
        torch.save(t.model.state_dict(),
                   os.path.join(spec["ckpt_dir"], "final.pt"))
    np.savez(os.path.join(spec["ckpt_dir"], f"rank{rank}.npz"),
             val_mae=history[-1]["val_mae"],
             train_loss=[h["train_loss"] for h in history],
             test=json.dumps(t.evaluate_split(t.test_graphs)),
             emb=t.embeddings(t.test_graphs))


def gp(spec: dict) -> None:
    import numpy as np
    from cgat_tpu_torch.cli import train_gp
    from cgat_tpu_torch.data.dataset import load_dataset_dir
    from cgat_tpu_torch.training import load_trainer
    assert train_gp.main(spec["argv"]) == 0
    t, _ = load_trainer(spec["run"], device="cpu", parallel=True,
                        n_devices=2, edge_shards=1)
    emb = t.embeddings(load_dataset_dir(spec["data"], max_neighbor_number=4,
                                        target="e_above_hull"))
    np.savez(os.path.join(os.path.dirname(spec["out"]),
                          f"rank{torch.distributed.get_rank()}.npz"), emb=emb)


def spy(spec: dict) -> None:
    import contextlib

    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.models import CGATConfig, cgat
    from cgat_tpu_torch.ops import segment
    from cgat_tpu_torch.ops.kernels import segment_sum as kernel
    from cgat_tpu_torch.parallel import (ParallelLoader,
                                         global_loss_and_metrics,
                                         reduce_gradients)
    from cgat_tpu_torch.training import Trainer, TrainerConfig
    t = Trainer(TrainerConfig(n_devices=2, edge_shards=2),
                CGATConfig(**TINY, dropout=0.1), mean=MEAN, std=STD,
                device="cpu")
    t.init_state(torch.load(spec["state_dict"]))
    mesh = t.mesh
    batch = t.rank_batch(next(iter(ParallelLoader(
        random_graphs(0, 16, **GRAPHS), 4, 1, max_nbr=4, node_bucket=8,
        num_comp_slots=8, edge_shards=2))))
    counts = {"index_add_": 0, "segment_sum_without_plan": 0}
    inside = []
    index_add_ = torch.Tensor.index_add_
    plain, seg_sum, take = (kernel.segment_sum_plain, segment.segment_sum,
                            segment.take_rows)

    def counted_index_add_(self, *args, **kwargs):
        if not inside:
            counts["index_add_"] += 1
        return index_add_(self, *args, **kwargs)

    def kernel_plain(*args):
        inside.append(1)
        try:
            return plain(*args)
        finally:
            inside.pop()

    def counted_seg_sum(data, ids, n, plan=None):
        counts["segment_sum_without_plan"] += plan is None
        return seg_sum(data, ids, n, plan)

    @contextlib.contextmanager
    def patched(sum_fn, take_fn):
        saved = [(m, name, getattr(m, name)) for m in (segment, cgat)
                 for name in ("segment_sum", "take_rows")]
        for m in (segment, cgat):
            m.segment_sum, m.take_rows = sum_fn, take_fn
        kernel.segment_sum_plain = kernel_plain
        torch.Tensor.index_add_ = counted_index_add_
        try:
            yield
        finally:
            torch.Tensor.index_add_ = index_add_
            kernel.segment_sum_plain = plain
            for m, name, fn in saved:
                setattr(m, name, fn)

    def run():
        t.model.zero_grad(set_to_none=True)
        out = t.model(batch, edge_group=mesh.edge,
                      dropout_key=cgat.DropoutKey(
                          (0, mesh.dp.index, mesh.edge.index),
                          torch.zeros((), dtype=torch.int64)))
        loss, _ = global_loss_and_metrics(out, batch, MEAN, STD,
                                          t.criterion, mesh)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in t.model.parameters()]
        reduce_gradients(grads, mesh.world)
        return {"loss": float(loss), "counts": dict(counts),
                "grad": torch.cat([g.reshape(-1) for g in grads])}

    with patched(counted_seg_sum, take):
        planned = run()
    counts.update(dict.fromkeys(counts, 0))
    with patched(lambda data, ids, n, plan=None:
                 counted_seg_sum(data, ids, n, None),
                 lambda table, ids, plan: take(table, ids, None)):
        atomics = run()
    if torch.distributed.get_rank() == 0:
        torch.save({"planned": planned, "atomics": atomics}, spec["out"])


if __name__ == "__main__":
    torch.set_num_threads(1)
    with open(sys.argv[2]) as f:
        spec = json.load(f)
    {"step": step, "fit": fit, "gp": gp, "spy": spy}[sys.argv[1]](spec)
    torch.distributed.destroy_process_group()
