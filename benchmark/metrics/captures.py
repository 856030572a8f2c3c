"""``captures.<cell>``: the CUDA graphs built in the window (the program's
span ``capture``: a new key's eager first step or forward and its
capture)."""
from harness import program


def read(view):
    return program.count(view, "capture")
