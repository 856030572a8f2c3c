"""Training entry point, counterpart of ``cgat_tpu/cli/train.py``
(reference: CGAT/train.py:22-144).

    python -m cgat_tpu_torch.cli.train --data-path <prepared .pickle.gz or dir>

Fresh training, exact resume (``--ckp <run dir>``), and a full fine-tune
from a checkpoint (``--pretrained-model <run dir>``). Runs on the CUDA card
unless ``--device cpu``. ``--streaming --val-path <dir>`` trains out of
core from the ``*.pickle.gz`` shards under ``--data-path``, one shard in
host memory at a time.

``--devices N`` (N > 1; 0 is every visible card) trains on N ranks with
``--edge-shards S`` edge shards a replica: this command builds the CUDA
kernels, then starts N rank processes on this host (NCCL, one card each;
gloo with ``--device cpu``), each running this command as one rank. Inside
a world that torchrun started (``RANK`` and ``WORLD_SIZE`` set, on one
host or many) it is one rank itself:

    torchrun --nproc-per-node 8 -m cgat_tpu_torch.cli.train --devices 8 ...
"""
from __future__ import annotations

import argparse
import sys

from .common import (add_device_arg, add_model_args, add_trainer_args,
                     configs_from_args, device_from_args, in_world, launch)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__)
    add_trainer_args(p)
    add_model_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    tcfg, mcfg = configs_from_args(args)
    device = device_from_args(args)
    if tcfg.n_devices > 1 and not in_world():
        launch(main, tcfg.n_devices, argv, device)
        return 0

    from ..training.trainer import Trainer, load_trainer, resume_trainer
    print(tcfg)
    print(mcfg)

    if args.pretrained_model:
        # transfer learning: start from the pretrained weights, train on
        # the new data with its own normalisation (train.py:28-33)
        pretrained, _ = load_trainer(args.pretrained_model, device=device)
        trainer = Trainer(tcfg, pretrained.model_cfg, device=device)
        trainer.init_state(pretrained.model.state_dict())
        trainer.fit()
    elif args.ckp:
        # exact resume: weights, optimizer moments, step, epoch and schedule
        # state restored (reference resume_from_checkpoint, train.py:64-76);
        # an explicit --moment-dtype must match the checkpoint's
        overrides = {"n_devices": tcfg.n_devices,
                     "edge_shards": tcfg.edge_shards}
        if args.moment_dtype != "auto":
            overrides["moment_dtype"] = args.moment_dtype
        try:
            trainer, meta = resume_trainer(args.ckp, tag="last",
                                           device=device, **overrides)
        except FileNotFoundError:
            trainer, meta = resume_trainer(args.ckp, tag="best",
                                           device=device, **overrides)
        trainer.fit(
            epochs=tcfg.epochs,
            start_epoch=int(meta.get("epoch", -1)) + 1,
            best_val=float(meta.get("best_val", meta.get("val_mae", "inf"))),
            plateau_state=meta.get("plateau"),
            last_val_mae=meta.get("val_mae"))
    else:
        trainer = Trainer(tcfg, mcfg, device=device)
        trainer.fit()

    print("training done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
