"""``collate_span_ms.<cell>``: ms a step or request in the program's
collates on the window's thread (its span ``collate``)."""
from harness import program


def read(view):
    return program.ms_per_entry(view, "collate")
