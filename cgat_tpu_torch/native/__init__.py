"""ctypes binding of the native C++ core: the featurizer's periodic kNN
(``neighbors.cc``) and the collate (``collate.cc``), one library.

``periodic_knn_native`` gives exactly what
``cgat_tpu_torch.data.featurizer.periodic_neighbors(..., use_native=False)``
gives (same algorithm, same candidate order) at C++ speed.
``graph_counts`` and ``collate_native`` give
``cgat_tpu_torch.data.batching.collate`` its counts and every field of its
batch; ``collate_stats`` counts what the collate served. The library is
built at first use (``build.py``), never at import, and a failed build
raises: nothing drops to a numpy path quietly. The kNN releases the
interpreter lock for its call (``ctypes.CDLL``); the collate holds it only
while it reads the crystals' attributes.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import build

_lib: ctypes.CDLL | None = None
_pylib: ctypes.PyDLL | None = None


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib, _pylib
    if _lib is None:
        path = str(build.build())
        lib = ctypes.CDLL(path)
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
        lib.cgat_collate_stats.restype = None
        lib.cgat_collate_stats.argtypes = [ctypes.c_void_p]
        # the collate reads Python objects: the same library, called with
        # the interpreter lock held (it lets it go for the heavy part)
        py = ctypes.PyDLL(path)
        py.cgat_graph_counts.restype = ctypes.c_int
        py.cgat_graph_counts.argtypes = [ctypes.py_object, ctypes.c_int64] + [
            ctypes.c_void_p] * 3
        py.cgat_collate.restype = ctypes.c_int
        py.cgat_collate.argtypes = [ctypes.py_object] + [ctypes.c_int64] * 7 + [
            ctypes.c_void_p] * 18
        _lib, _pylib = lib, py
    return _lib


def _batch_fields(N: int, E: int, C: int, R: int, F: int, margin: int
                  ) -> dict[str, tuple]:
    """Each field of a batch ``cgat_collate`` writes, in its argument
    order: its shape and dtype."""
    f32, i32 = np.float32, np.int32
    return {"nodes": ((N, F), f32), "target": ((C,), f32),
            "node_mask": ((N,), bool), "node2graph": ((N,), i32),
            "node2graph_offn": ((C + margin + 1,), i32),
            "comp_fea": ((C, R, F), f32), "comp_weight": ((C, R), f32),
            "comp_mask": ((C, R), bool), "graph_mask": ((C,), bool),
            "edge_src": ((E,), i32), "edge_dst": ((E,), i32),
            "edge_shell": ((E,), i32), "edge_mask": ((E,), bool),
            "edge_src_perm": ((E,), i32), "edge_src_sorted": ((E,), i32),
            "edge_dst_offn": ((N + margin + 1,), i32),
            "edge_src_offn": ((N + margin + 1,), i32)}


def graph_counts(graphs: list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each crystal's atoms, edges and composition rows (int64): the
    lengths of its ``atom_fea``, ``edge_src`` and ``comp_fea``."""
    load()
    out = [np.empty((len(graphs),), np.int64) for _ in range(3)]
    _pylib.cgat_graph_counts(graphs, len(graphs),
                             *(a.ctypes.data for a in out))
    return tuple(out)


def collate_native(graphs: list, *, N: int, E: int, C: int, R: int, F: int,
                   margin: int) -> dict[str, np.ndarray]:
    """Every field of a static-shape batch of ``graphs`` (a list of
    ``CrystalGraph``) in N node, E edge, C crystal and R composition slots
    of width F, as numpy arrays, read from the crystals' own arrays: int32
    or int64 edges, f32 or f64 rows and weights, any strides. Raises
    ``ValueError`` for a crystal with an edge id outside its own atoms
    (nothing written out of bounds) or arrays of other kinds or shapes."""
    load()
    out = {k: np.empty(shape, dtype) for k, (shape, dtype)
           in _batch_fields(N, E, C, R, F, margin).items()}
    bad = np.zeros((1,), np.int64)
    rc = _pylib.cgat_collate(graphs, len(graphs), N, E, C, R, F, margin,
                             *(a.ctypes.data for a in out.values()),
                             bad.ctypes.data)
    if rc == 1:
        raise ValueError(f"crystal {bad[0]} has an edge to or from an atom "
                         f"it does not hold")
    if rc == 3:
        raise ValueError(
            f"crystal {bad[0]}: a batch takes int32 or int64 edge arrays of "
            f"one length and f32 or f64 atom and composition rows {F} wide, "
            f"one weight a composition row")
    if rc != 0:
        raise ValueError(f"{len(graphs)} crystals do not fit {C} crystal, "
                         f"{N} node and {E} edge slots")
    return out


def collate_stats() -> dict[str, int]:
    """Batches and crystals the native collate has served in this process
    (zero before the library is loaded)."""
    if _lib is None:
        return {"batches": 0, "crystals": 0}
    out = np.zeros((2,), np.int64)
    _lib.cgat_collate_stats(out.ctypes.data)
    return {"batches": int(out[0]), "crystals": int(out[1])}


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
