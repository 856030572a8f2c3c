"""``edge_hyper_roofline.<cell>``: the #5 to #7 calls on edge rows, their
summed roofline bounds (each at its own rows) over their summed device
time (%)."""
from harness import hyperedge


def read(view):
    return hyperedge.edge_hyper_roofline_pct(view)
