"""``loader_wait_ms.<cell>``: ms a training step the loop waits for the
prefetched batch (the benchmark's span around the loader's next)."""
from harness import readers


def read(view):
    return readers.span_ms(view, "loader")
