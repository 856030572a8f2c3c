"""Training entry point, counterpart of ``cgat_tpu/cli/train.py``
(reference: CGAT/train.py:22-144).

    python -m cgat_tpu_torch.cli.train --data-path <prepared .pickle.gz or dir>

Fresh training, exact resume (``--ckp <run dir>``), and a full fine-tune
from a checkpoint (``--pretrained-model <run dir>``). Runs on the CUDA card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from .common import (add_device_arg, add_model_args, add_trainer_args,
                     configs_from_args, device_from_args)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_trainer_args(p)
    add_model_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    tcfg, mcfg = configs_from_args(args)
    device = device_from_args(args)

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
        overrides = ({} if args.moment_dtype == "auto"
                     else {"moment_dtype": args.moment_dtype})
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
