"""``h2d_ms.<cell>``: host ms a step or request in the program's copies of
a batch from the host to the card (its span ``h2d``)."""
from harness import program


def read(view):
    return program.ms_per_entry(view, "h2d")
