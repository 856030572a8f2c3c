"""``kernels_roofline.<cell>``: the port's kernels' summed roofline bounds
over their summed device time (%)."""
from harness import readers


def read(view):
    return readers.kernels_roofline_pct(view)
