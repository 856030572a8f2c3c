"""``device_idle.<cell>``: the share (%) of the traced window in which the
card ran nothing."""
from harness import readers


def read(view):
    return readers.idle_pct(view)
