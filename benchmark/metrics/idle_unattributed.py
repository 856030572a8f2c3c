"""``idle_unattributed.<cell>``: the share (%) of the window's idle time
during which no leaf span of the program is open on its thread."""
from harness import program


def read(view):
    return program.idle_unattributed_pct(view)
