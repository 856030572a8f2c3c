"""Shared CLI argument handling, counterpart of ``cgat_tpu/cli/common.py``
(reference: CGAT/lightning_module.py:426-593, CGAT/train.py:82-131).

The reference declares several booleans with ``action="store_false"`` so the
flag *disables* the feature and the default is True (SURVEY.md section 2.2) —
a documented footgun. Here every boolean has an explicit ``--x/--no-x`` pair
with the reference's *effective* defaults; the reference's bare flag names are
kept as deprecated aliases with their original (inverting) meaning. The
flags, defaults and aliases are the JAX package's, so a command line means
the same to both; ``--device`` (the CUDA card by default, ``cpu`` on
request) is the port's own, its counterpart of choosing the JAX platform.
``--devices N`` is the number of ranks (one card each under NCCL; gloo
processes with ``--device cpu``), 0 meaning every visible card, and
``--edge-shards S`` must divide it. ``--streaming`` trains from the shards
under ``--data-path`` (out of core; ``--val-path`` required).
``--profile-epoch N`` writes epoch N's trace under ``<run>/profile``.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..models.cgat import CGATConfig
from ..training.trainer import TrainerConfig

def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--data-path", type=str, default="data/")
    p.add_argument("--fea-path", type=str, default=None,
                   help="element embedding JSON (default: bundled matscholar)")
    p.add_argument("--version", type=str, default="",
                   help="module providing a CGAtNet class for model variants "
                        "(reference --version plug-in mechanism)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise MP layers (for large batches)")
    p.add_argument("--profile-epoch", type=int, default=-1)
    p.add_argument("--nbr-embedding-size", type=int, default=128,
                   help="size of edge embedding (reference declared 512 but "
                        "never forwarded it; effective value was 128)")
    p.add_argument("--msg-heads", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--val-size", type=float, default=0.1)
    p.add_argument("--test-size", type=float, default=0.1)
    p.add_argument("--max-nbr", type=int, default=24)
    p.add_argument("--epochs", type=int, default=390)
    p.add_argument("--loss", type=str, default="L1", choices=["L1", "L2"])
    p.add_argument("--optim", type=str, default="AdamW")
    p.add_argument("--learning-rate", "--lr", type=float, default=0.000125)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-6)
    p.add_argument("--atom-fea-len", type=int, default=128)
    p.add_argument("--n-graph", type=int, default=5)
    p.add_argument("--n-graph-roost", type=int, default=3)
    p.add_argument("--clr-period", type=int, default=130)
    p.add_argument("--train-percentage", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target", type=str, default="e_above_hull_new")
    p.add_argument("--test-path", type=str, default=None)
    p.add_argument("--val-path", type=str, default=None)
    p.add_argument("--only-residual", action="store_true")
    p.add_argument("--smoke-test", action="store_true",
                   help="2 epochs on a small subset for a quick end-to-end run")
    # explicit boolean pairs (defaults = reference effective values)
    for name, default, help_ in [
        ("update-edges", True, "update edge embeddings each layer"),
        ("vector-attention", True, "vector-valued MP attention"),
        ("global-vector-attention", True, "vector-valued pooling attention"),
        ("rezero", True, "ReZero gates in the output head"),
        ("clr", True, "cyclic LR schedule (else ReduceLROnPlateau)"),
        ("mean-pool-heads", False, "average pooled heads instead of concat"),
        ("robust-loss", False, "aleatoric Robust L1/L2 loss"),
        ("hyper-edges", False, "hypernetwork edge updates (no_hyper=False)"),
    ]:
        dest = name.replace("-", "_")
        g = p.add_mutually_exclusive_group()
        g.add_argument(f"--{name}", dest=dest, action="store_true",
                       help=help_)
        g.add_argument(f"--no-{name}", dest=dest, action="store_false")
        p.set_defaults(**{dest: default})
    # deprecated reference-style inverting aliases
    p.add_argument("--update_edges", dest="update_edges",
                   action="store_false", help=argparse.SUPPRESS)
    p.add_argument("--vector_attention", dest="vector_attention",
                   action="store_false", help=argparse.SUPPRESS)
    p.add_argument("--global_vector_attention", dest="global_vector_attention",
                   action="store_false", help=argparse.SUPPRESS)
    p.add_argument("--std-loss", dest="robust_loss", action="store_false",
                   help=argparse.SUPPRESS)
    # reference --mean-pooling is store_false and the trainer passes the
    # negation (lightning_module.py:549-551, 170): passing the flag turns
    # head-averaging ON — same effect as --mean-pool-heads here
    p.add_argument("--mean-pooling", dest="mean_pool_heads",
                   action="store_true", help=argparse.SUPPRESS)
    # accepted-for-compatibility no-ops: the loader-worker count, and the
    # dataset-loading toggle, implicit in the load/predict paths
    # (lightning_module.py:463-467, 572)
    p.add_argument("--workers", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--train", action="store_false", dest="_ref_train",
                   help=argparse.SUPPRESS)
    # batching / io
    p.add_argument("--node-bucket", type=int, default=64)
    p.add_argument("--num-comp-slots", type=int, default=12)
    p.add_argument("--ckpt-dir", type=str, default="tb_logs")
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--last-ckpt-every", type=int, default=1,
                   help="refresh the crash-safe 'last' checkpoint every N "
                        "non-improving val epochs")
    # the production default, as in the JAX package: bf16 compute over f32
    # master weights. Pass --precision float32 for the f32 anchor path
    # (reference parity runs). The library-level CGATConfig default stays
    # float32 so programmatic users opt in explicitly.
    p.add_argument("--precision", choices=["float32", "bfloat16"],
                   default="bfloat16")
    # "auto": bf16 first moment under the bf16 production profile, f32
    # under --precision float32 (exact reference AdamW). See
    # TrainerConfig.moment_dtype for the numerics argument.
    p.add_argument("--moment-dtype",
                   choices=["auto", "float32", "bfloat16"], default="auto")
    return p


def add_trainer_args(p: argparse.ArgumentParser):
    p.add_argument("--devices", type=int, default=0,
                   help="data-parallel devices (0 = all available)")
    p.add_argument("--edge-shards", type=int, default=1,
                   help="edge-partition shards per replica")
    p.add_argument("--acc_batches", "--acc-batches", type=int, default=1)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="fuse K train steps into one device dispatch")
    p.add_argument("--streaming", action="store_true",
                   help="stream training shards from disk one at a time "
                        "(out-of-core; requires --val-path)")
    p.add_argument("--ckp", type=str, default="",
                   help="checkpoint run dir to resume from")
    p.add_argument("--pretrained-model", type=str, default=None,
                   help="checkpoint run dir for transfer learning")
    # reference trainer-level aliases (train.py:86-131): --gpus maps to
    # data-parallel devices; apex AMP levels map to the bf16 path (01/02 =
    # mixed precision, train.py:106-110); the distributed backend and GPU
    # pinning are accepted as no-ops so reference scripts run unchanged
    p.add_argument("--gpus", dest="devices", type=int,
                   help=argparse.SUPPRESS)
    p.add_argument("--amp_optimization", type=str, default="00",
                   choices=["00", "01", "02"], help=argparse.SUPPRESS)
    p.add_argument("--distributed_backend", type=str, default="ddp",
                   help=argparse.SUPPRESS)
    p.add_argument("--first-gpu", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--test", action="store_true", dest="_ref_test",
                   help=argparse.SUPPRESS)  # declared but dead in the
    #   reference (train.py:123-126 — main() never reads it)
    return p


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs: the CUDA card (default) or "
                        "the CPU")
    return p


def in_world() -> bool:
    """Whether this process is a rank of a world torchrun (or
    :func:`launch`) started."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank(rank: int, n: int, port: int, main, argv: list[str]) -> None:
    """One rank of a world started by :func:`launch`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch.distributed as dist
    try:
        main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(main, n: int, argv: list[str], device: torch.device) -> None:
    """Run the command ``main(argv)`` as ``n`` ranks on this host (a free
    port for the rendezvous), the CUDA kernels built first so that no two
    ranks run nvcc; raises if a rank fails."""
    from ..parallel.distributed import free_port
    if device.type == "cuda":
        from ..ops.kernels import build
        build.build()
    torch.multiprocessing.spawn(_rank, args=(n, free_port(), main, argv),
                                nprocs=n, join=True)


def device_from_args(args) -> torch.device:
    """``--device`` as a torch device; raises when the card is asked for
    and there is none, rather than dropping to the CPU."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return torch.device(args.device)


def check_devices(args) -> None:
    """Resolve ``--devices 0`` to every visible card (one with ``--device
    cpu`` or without a card; the world's size inside a torchrun world) and
    check that ``--edge-shards`` divides the devices."""
    if not hasattr(args, "devices"):
        return
    if args.devices < 0:
        raise ValueError(f"--devices must be at least 0, not {args.devices}")
    if args.devices == 0:
        if "WORLD_SIZE" in os.environ:
            args.devices = int(os.environ["WORLD_SIZE"])
        elif getattr(args, "device", "cuda") == "cuda":
            args.devices = max(torch.cuda.device_count(), 1)
        else:
            args.devices = 1
    shards = getattr(args, "edge_shards", 1)
    if shards < 1 or args.devices % shards:
        raise ValueError(f"--edge-shards {shards} does not divide "
                         f"--devices {args.devices}")


def configs_from_args(args) -> tuple[TrainerConfig, CGATConfig]:
    check_devices(args)
    # apex AMP levels 01/02 = mixed precision (reference train.py:106-110);
    # the port's counterpart is bf16 compute with f32 master weights
    if getattr(args, "amp_optimization", "00") in ("01", "02"):
        args.precision = "bfloat16"
    tcfg = TrainerConfig(
        data_path=args.data_path, fea_path=args.fea_path, target=args.target,
        max_nbr=args.max_nbr, val_size=args.val_size, test_size=args.test_size,
        train_percentage=args.train_percentage, val_path=args.val_path,
        test_path=args.test_path, batch_size=args.batch_size,
        epochs=2 if args.smoke_test else args.epochs, optim=args.optim,
        learning_rate=args.learning_rate, momentum=args.momentum,
        weight_decay=args.weight_decay, loss=args.loss,
        robust_loss=args.robust_loss, clr=args.clr,
        clr_period=args.clr_period,
        acc_batches=getattr(args, "acc_batches", 1),
        only_residual=args.only_residual, seed=args.seed,
        node_bucket=args.node_bucket, num_comp_slots=args.num_comp_slots,
        ckpt_dir=args.ckpt_dir, run_name=args.run_name,
        log_tensorboard=args.tensorboard,
        last_ckpt_every=getattr(args, "last_ckpt_every", 1),
        n_devices=getattr(args, "devices", 1),
        edge_shards=getattr(args, "edge_shards", 1),
        version=args.version,
        profile_epoch=args.profile_epoch,
        steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        streaming=getattr(args, "streaming", False),
        moment_dtype=(args.precision
                      if getattr(args, "moment_dtype", "auto") == "auto"
                      else args.moment_dtype),
    )
    mcfg = CGATConfig(
        orig_elem_fea_len=200, elem_fea_len=args.atom_fea_len,
        n_graph=args.n_graph, nbr_embedding_size=args.nbr_embedding_size,
        neighbor_number=args.max_nbr, mean_pooling=args.mean_pool_heads,
        rezero=args.rezero, msg_heads=args.msg_heads,
        update_edges=args.update_edges,
        vector_attention=args.vector_attention,
        global_vector_attention=args.global_vector_attention,
        n_graph_roost=args.n_graph_roost, no_hyper=not args.hyper_edges,
        compute_dtype=args.precision, remat=args.remat,
    )
    return tcfg, mcfg
