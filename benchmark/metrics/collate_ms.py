"""``collate_ms.<cell>``: ms a step spends collating its batch inline (the
benchmark's span around the loader's next)."""
from harness import readers


def read(view):
    return readers.span_ms(view, "collate")
