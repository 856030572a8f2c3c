"""``readback_ms.<cell>``: ms a request in reading the answers back to the
host, their replay's wait included (the program's span ``readback``)."""
from harness import program


def read(view):
    return program.ms_per_entry(view, "readback")
