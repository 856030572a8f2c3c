"""``optimizer_ms.<cell>``: device ms a training step in the optimizer's
kernels (multi_tensor_apply)."""
from harness import readers


def read(view):
    return readers.category_ms_per_step(view, "optimizer")
