"""``edge_hyper_ms.<cell>``: device ms a training step in #5 to #7 calls on
edge rows (the live edge update's hypernetworks), told from node-row calls
by the program's launch record."""
from harness import hyperedge


def read(view):
    return hyperedge.edge_hyper_ms(view)
