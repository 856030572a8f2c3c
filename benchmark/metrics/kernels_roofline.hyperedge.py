"""``kernels_roofline.hyperedge``: the port's kernels' summed roofline
bounds over their summed device time (%), over the hypernetwork-edge
model's calls (the live edge updates' #5 to #8 among them), each call's
bound at its own rows."""
from harness import hyperedge


def read(view):
    return hyperedge.kernels_roofline_pct(view)
