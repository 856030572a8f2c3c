"""ctypes binding of the native C++ featurizer core (``neighbors.cc``).

``periodic_knn_native`` gives exactly what
``cgat_tpu_torch.data.featurizer.periodic_neighbors(..., use_native=False)``
gives (same algorithm, same candidate order) at C++ speed. The library is
built at first use (``build.py``), never at import, and a failed build
raises: nothing drops to the numpy path quietly.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import build

_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build()))
        lib.cgat_periodic_knn.restype = ctypes.c_int
        lib.cgat_periodic_knn.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # lattice (3, 3)
            ctypes.POINTER(ctypes.c_double),  # frac (n, 3)
            ctypes.c_int,                     # n
            ctypes.c_double,                  # radius
            ctypes.c_int,                     # max_nbr
            ctypes.POINTER(ctypes.c_int32),   # nbr_idx out (n, max_nbr)
            ctypes.POINTER(ctypes.c_int32),   # shell out (n, max_nbr)
            ctypes.POINTER(ctypes.c_double),  # dist out (n, max_nbr)
        ]
        _lib = lib
    return _lib


def periodic_knn_native(lattice, frac_coords, *, radius: float = 18.0,
                        max_nbr: int = 24):
    """Native periodic kNN: ``(nbr_idx, shell, dist)``, each
    ``(n, max_nbr)``, or None when some atom lacks ``max_nbr`` neighbours
    within ``radius``."""
    lib = load()
    A = np.ascontiguousarray(lattice, np.float64)
    F = np.ascontiguousarray(frac_coords, np.float64)
    if A.shape != (3, 3) or F.ndim != 2 or F.shape[1] != 3:
        raise ValueError(f"lattice must be (3, 3) and frac_coords (n, 3); "
                         f"got {A.shape} and {F.shape}")
    n = len(F)
    nbr = np.empty((n, max_nbr), np.int32)
    shell = np.empty((n, max_nbr), np.int32)
    dist = np.empty((n, max_nbr), np.float64)
    rc = lib.cgat_periodic_knn(
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        F.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, radius, max_nbr,
        nbr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        shell.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc == 1:
        return None
    if rc != 0:
        raise RuntimeError(f"native periodic kNN failed (code {rc}: "
                           f"degenerate lattice)")
    return nbr.astype(np.int64), shell.astype(np.int64), dist
