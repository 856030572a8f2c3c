"""Import a reference PyTorch-Lightning checkpoint into a port run dir, and
export a port run back; counterpart of ``cgat_tpu/tools/import_torch.py``.

The reference trains with PyTorch Lightning and saves checkpoints holding
``state_dict`` (the CGAtNet weights under a ``model.`` prefix plus the
normalisation ``mean``/``std`` Parameters, lightning_module.py:44-46) and
``hyper_parameters`` (the argparse namespace, lightning_module.py:49).
The port's modules keep the reference's ``state_dict`` keys and layouts,
so the weights load as they are: strip ``model.``, pop ``mean`` and
``std``, load with ``strict=True``::

    python -m cgat_tpu_torch.tools.import_torch model.ckpt --out runs/imported
    python -m cgat_tpu_torch.cli.evaluate runs/imported --data-path ...
    python -m cgat_tpu_torch.cli.train --pretrained-model runs/imported ...
    python -m cgat_tpu_torch.tools.import_torch runs/imported --export \\
        --out back.ckpt

The run dir holds ``checkpoints/best.pt`` (the weights and the step, no
optimizer state) and ``checkpoints/best.json`` (the JAX package's fields),
which ``load_trainer`` reads. The import is strict: a tensor the model
does not have, or a weight the checkpoint lacks, raises. An imported
model computes in f32 (the reference's namespace names no precision); an
exported run's mean and std come back rounded to f32, the dtype of the
reference's Parameters.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

def config_from_hparams(hp):
    """The port's ``CGATConfig`` from the checkpoint's argparse namespace
    (a dict or a ``Namespace``), built as the reference trainer builds its
    model (lightning_module.py:161-176): ``mean_pooling`` negated,
    ``nbr_embedding_size`` not forwarded (the model default 128 applies),
    ``no_hyper`` never passed (stays True)."""
    from ..models import CGATConfig

    if not isinstance(hp, dict):
        hp = vars(hp)
    return CGATConfig(
        orig_elem_fea_len=200,
        elem_fea_len=hp.get("atom_fea_len", 128),
        n_graph=hp.get("n_graph", 5),
        nbr_embedding_size=128,
        neighbor_number=hp.get("max_nbr", 24),
        mean_pooling=not hp.get("mean_pooling", True),
        rezero=hp.get("rezero", True),
        msg_heads=hp.get("msg_heads", 5),
        update_edges=hp.get("update_edges", True),
        vector_attention=hp.get("vector_attention", True),
        global_vector_attention=hp.get("global_vector_attention", True),
        n_graph_roost=hp.get("n_graph_roost", 3),
        no_hyper=True,
    )


def state_dict_from_reference(state_dict: dict, cfg
                              ) -> tuple[dict, float, float]:
    """A LightningModel ``state_dict`` -> (the port's f32 ``state_dict``,
    mean, std). Strict: a tensor the model does not have, or of another
    shape, raises ``ValueError``, a weight the checkpoint lacks
    ``KeyError``."""
    from ..models import CGAtNet

    if not cfg.update_edges:
        raise ValueError(
            "cannot import an update_edges=False reference checkpoint: the "
            "reference's node-only branch is built with positionally broken "
            "arguments (CGAT.py:406-425) that this framework intentionally "
            "does not reproduce")
    sd = {k: torch.as_tensor(v).detach().to(torch.float32)
          for k, v in state_dict.items()}
    mean = float(sd.pop("mean", torch.zeros(1)).reshape(-1)[0])
    std = float(sd.pop("std", torch.ones(1)).reshape(-1)[0])
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    model = CGAtNet(cfg)
    want = model.state_dict()
    extra = sorted(set(sd) - set(want))
    if extra:
        raise ValueError(f"unconsumed reference tensors: {extra[:10]}"
                         f"{' ...' if len(extra) > 10 else ''}")
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"reference checkpoint lacks {missing[:10]}"
                       f"{' ...' if len(missing) > 10 else ''}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in want.items()
           if sd[k].shape != v.shape]
    if bad:
        raise ValueError(f"import mismatch: shape (key, checkpoint, model) "
                         f"{bad[:5]}")
    model.load_state_dict(sd, strict=True)
    return {k: sd[k].contiguous() for k in want}, mean, std


def import_checkpoint(ckpt_path: str, out_dir: str) -> str:
    """Convert a reference .ckpt into a port run dir loadable by
    ``load_trainer``, ``cli.evaluate``, ``cli.predict`` and
    ``--pretrained-model``."""
    from ..training.trainer import TrainerConfig

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    hp = ckpt.get("hyper_parameters", {})
    if not isinstance(hp, dict):
        hp = vars(hp)
    cfg = config_from_hparams(hp)
    sd, mean, std = state_dict_from_reference(state_dict, cfg)
    tcfg = TrainerConfig(
        target=hp.get("target", "e_above_hull_new"),
        max_nbr=hp.get("max_nbr", 24),
        batch_size=hp.get("batch_size", 64),
        learning_rate=hp.get("learning_rate", 1.25e-4),
        optim=hp.get("optim", "AdamW"),
    )
    d = os.path.abspath(os.path.join(out_dir, "checkpoints"))
    os.makedirs(d, exist_ok=True)
    torch.save({"model": sd, "step": int(ckpt.get("global_step", 0))},
               os.path.join(d, "best.pt"))
    meta = {
        "epoch": int(ckpt.get("epoch", 0)), "val_mae": float("nan"),
        "best_val": float("inf"), "plateau": None,
        "mean": mean, "std": std,
        "trainer_config": dataclasses.asdict(tcfg),
        "model_config": dataclasses.asdict(cfg),
        "imported_from": os.path.abspath(ckpt_path),
    }
    with open(os.path.join(d, "best.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return out_dir


def export_checkpoint(run_dir: str, out_ckpt: str, tag: str = "best") -> str:
    """A port run dir -> a reference-format Lightning ``.ckpt`` (so models
    trained here can go back to a reference installation)."""
    from ..models import CGATConfig
    from ..training.trainer import CheckpointManager, _config_from

    state_dict, meta = CheckpointManager.load(run_dir, tag=tag,
                                              map_location="cpu")
    cfg = _config_from(CGATConfig, meta["model_config"])
    if not cfg.update_edges:
        raise ValueError(
            "cannot export an update_edges=False model to the reference "
            "format: the reference's node-only branch differs structurally "
            "(CGAT.py:406-425; PARITY.md deviation 3)")
    sd = {f"model.{k}": v.detach().to(torch.float32).contiguous()
          for k, v in state_dict.items()}
    sd["mean"] = torch.tensor([float(meta["mean"])])
    sd["std"] = torch.tensor([float(meta["std"])])
    tcfg = meta.get("trainer_config", {})
    # the reference's namespace stores mean_pooling negated (its trainer
    # passes `not hparams.mean_pooling`, lightning_module.py:170)
    hp = {
        "atom_fea_len": cfg.elem_fea_len, "n_graph": cfg.n_graph,
        "max_nbr": cfg.neighbor_number, "msg_heads": cfg.msg_heads,
        "n_graph_roost": cfg.n_graph_roost, "rezero": cfg.rezero,
        "mean_pooling": not cfg.mean_pooling,
        "update_edges": cfg.update_edges,
        "vector_attention": cfg.vector_attention,
        "global_vector_attention": cfg.global_vector_attention,
        "target": tcfg.get("target", "e_above_hull_new"),
        "batch_size": tcfg.get("batch_size", 64),
        "learning_rate": tcfg.get("learning_rate", 1.25e-4),
        "optim": tcfg.get("optim", "AdamW"),
        "version": "CGAT.CGAT", "train": False,
    }
    torch.save({"state_dict": sd, "hyper_parameters": hp,
                "epoch": int(meta.get("epoch", 0)), "global_step": 0},
               out_ckpt)
    return out_ckpt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint",
                   help="reference .ckpt to import, or (with --export) a "
                        "port run dir to export")
    p.add_argument("--out", required=True,
                   help="run dir to create (import) / .ckpt path (--export)")
    p.add_argument("--export", action="store_true",
                   help="reverse direction: run dir -> reference .ckpt")
    args = p.parse_args(argv)
    if args.export:
        out = export_checkpoint(args.checkpoint, args.out)
        print(f"exported -> {out}")
    else:
        out = import_checkpoint(args.checkpoint, args.out)
        print(f"imported -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
