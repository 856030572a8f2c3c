"""Where the port's entry points run, and which card that is."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the first CUDA card when it is None. Raises rather
    than dropping to the CPU when there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` reports them (the first
    card's line)."""
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=120)
    return smi.stdout.strip().splitlines()[0]
