"""``prefetch_wait_ms.<cell>``: ms a training step the consumer waits on
the prefetch queue (the program's span ``prefetch_wait``)."""
from harness import program


def read(view):
    return program.ms_per_entry(view, "prefetch_wait")
