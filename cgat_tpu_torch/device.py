"""Where the port's entry points run."""
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
