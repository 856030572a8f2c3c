"""``step_mfu.<cell>``: the model's matrix FLOPs over the traced window, as
a share (%) of the card's bf16 peak."""
from harness import readers


def read(view):
    return readers.mfu_pct(view)
