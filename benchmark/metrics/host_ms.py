"""``host_ms.<cell>``: ms a request in which the card runs nothing: its
wall time less the device's busy time inside it."""
from harness import readers


def read(view):
    return readers.host_ms(view, "predict")
