"""Offline featurisation: periodic kNN + distance-shell edge features.
Counterpart of ``cgat_tpu/data/featurizer.py``.

Re-implementation of the reference ``prepare`` pipeline
(reference: CGAT/prepare_data.py:14-184) without the pymatgen dependency:
a self-contained periodic neighbor finder builds, per atom, the
``max_num_nbr`` nearest periodic neighbors within ``radius`` (18 A), sorted by
distance, with the *distance-shell index* edge feature (shell increments when
the gap to the previous neighbor exceeds 1e-8; prepare_data.py:163-169).
Crystals with fewer than ``max_num_nbr`` neighbors inside the radius are
rejected (prepare_data.py:152-157).

Structures are plain dicts — ``{"lattice": (3,3), "frac_coords": (n,3),
"species": [symbols], "data": {...targets/id...}}`` — pymatgen Structures /
ComputedStructureEntry objects are converted when pymatgen is installed.
The neighbor search runs in the C++ core (``cgat_tpu_torch.native``, built
at first use); a failed build raises. The numpy path
(``use_native=False``) is its oracle and gives the same output.
"""
from __future__ import annotations

import gzip
import hashlib
import os
import pickle
import warnings
from typing import Sequence

import numpy as np

from .batching import CrystalGraph
from .embedding import Featuriser, load_featuriser


# ------------------------------------------------------------ neighbor search

def _candidate_images(lattice: np.ndarray, r: float) -> np.ndarray:
    """Integer image offsets whose cells can contain points within r."""
    G = np.linalg.inv(lattice)            # cart -> frac: f = d @ G
    bounds = np.ceil(r * np.linalg.norm(G, axis=0)).astype(int) + 1
    ax = [np.arange(-b, b + 1) for b in bounds]
    return np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)


def periodic_neighbors(lattice, frac_coords, *, radius: float = 18.0,
                       max_nbr: int = 24, use_native: bool | None = None):
    """24-NN periodic neighbor lists.

    Returns ``(nbr_idx, shell, dist)`` each ``(n, max_nbr)`` or ``None`` when
    some atom has fewer than ``max_nbr`` neighbors within ``radius``.
    The search starts from a density-based radius and grows until enough
    neighbors are found (identical output to a full radius-18 search).

    ``use_native`` None or True runs the C++ core
    (``cgat_tpu_torch.native``, built at first use; its build errors
    raise); False runs the numpy path below, the oracle with identical
    output.
    """
    if use_native is not False:
        from .. import native
        return native.periodic_knn_native(lattice, frac_coords,
                                          radius=radius, max_nbr=max_nbr)
    A = np.asarray(lattice, np.float64)
    frac = np.asarray(frac_coords, np.float64) % 1.0
    n = len(frac)
    cart = frac @ A
    vol = abs(np.linalg.det(A))
    # sphere holding ~max_nbr+1 atoms at this density, with safety margin
    r = min(radius, 1.5 * (3.0 * (max_nbr + 1) * vol /
                           (4.0 * np.pi * max(n, 1))) ** (1.0 / 3.0))
    r = max(r, 1.0)

    while True:
        images = _candidate_images(A, r)
        offsets = images @ A                              # (m, 3)
        nbr_idx = np.empty((n, max_nbr), np.int64)
        shells = np.empty((n, max_nbr), np.int64)
        dists = np.empty((n, max_nbr), np.float64)
        ok = True
        for i in range(n):
            # all periodic copies of all atoms, relative to atom i
            diff = cart[None, :, :] + offsets[:, None, :] - cart[i]  # (m,n,3)
            d = np.sqrt(np.sum(diff * diff, axis=-1)).reshape(-1)
            j_of = np.broadcast_to(np.arange(n)[None, :],
                                   (len(offsets), n)).reshape(-1)
            sel = (d <= r) & (d > 1e-8)
            if sel.sum() < max_nbr:
                ok = False
                break
            d_sel, j_sel = d[sel], j_of[sel]
            order = np.argsort(d_sel, kind="stable")[:max_nbr]
            dd, jj = d_sel[order], j_sel[order]
            # distance-shell indices (prepare_data.py:163-169)
            sh = np.empty(max_nbr, np.int64)
            index, prev = 1, dd[0]
            for k in range(max_nbr):
                if dd[k] > prev + 1e-8:
                    prev = dd[k]
                    index += 1
                sh[k] = index
            nbr_idx[i], shells[i], dists[i] = jj, sh, dd
        if ok:
            return nbr_idx, shells, dists
        if r >= radius:
            return None
        r = min(radius, r * 1.6)


# -------------------------------------------------------- featurisation cache

class FeaturizationCache:
    """Incremental disk cache of periodic-kNN results for AL rounds.

    Active-learning workflows re-featurise overlapping structure sets round
    after round (the reference re-runs ``prepare`` over every new prototype
    batch, Utilities/get_additional_data.py:23-39). The neighbor search is the
    only expensive part of featurisation, and it depends solely on the
    geometry — so results are cached on disk keyed by a content hash of
    ``(lattice, frac_coords, n_atoms, radius, max_nbr)``. Targets, ids and
    compositions are cheap and never cached, so annotation changes between
    rounds do not invalidate entries.

    Layout: one ``.npz`` per structure under ``path/ab/<hash>.npz`` (two-hex
    fanout). Entries record one of three kinds: a complete ``max_nbr``-NN
    result, a rejection marker (<``max_nbr`` neighbors within the radius), or
    a ragged result (rejection + the legacy variable-degree lists, appended
    lazily when an ``allow_incomplete`` caller needs them).
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def key(self, lattice, frac_coords, radius: float, max_nbr: int) -> str:
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(lattice, np.float64).tobytes())
        h.update(np.ascontiguousarray(frac_coords, np.float64).tobytes())
        h.update(f"|{len(frac_coords)}|{radius!r}|{max_nbr}".encode())
        return h.hexdigest()

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key[:2], key[2:] + ".npz")

    def _load(self, key: str):
        try:
            with np.load(self._file(key)) as z:
                return dict(z)
        except (FileNotFoundError, OSError, ValueError, EOFError):
            return None  # absent or torn write: treat as a miss

    def _store(self, key: str, payload: dict):
        file = self._file(key)
        os.makedirs(os.path.dirname(file), exist_ok=True)
        tmp = file + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, file)  # atomic: concurrent preparers see whole files

    def get(self, key: str, *, ragged: bool = False):
        """Tagged hit or miss:
        ``("knn", nbr_idx, shells)`` for a complete result;
        ``("rejected",)`` for a cached rejection (when the ragged lists are
        not needed or not cached yet); ``("ragged", nbr_lists, shell_lists)``
        when ``ragged`` and the legacy lists are cached; ``None`` on miss."""
        z = self._load(key)
        if z is None:
            self.misses += 1
            return None
        kind = str(z["kind"])
        if kind == "knn":
            self.hits += 1
            return ("knn", z["nbr_idx"].astype(np.int64),
                    z["shells"].astype(np.int64))
        if ragged:
            if "ragged_nbr" not in z:
                self.misses += 1
                return None
            self.hits += 1
            splits = np.cumsum(z["ragged_counts"])[:-1]
            return ("ragged", np.split(z["ragged_nbr"], splits),
                    np.split(z["ragged_shells"], splits))
        self.hits += 1
        return ("rejected",)

    def put(self, key: str, nbr_idx, shells):
        self._store(key, {"kind": "knn",
                          "nbr_idx": np.asarray(nbr_idx, np.int32),
                          "shells": np.asarray(shells, np.int32)})

    def put_rejected(self, key: str, ragged_nbr=None, ragged_shells=None):
        payload = {"kind": "reject"}
        if ragged_nbr is not None:
            payload.update(
                ragged_counts=np.asarray([len(a) for a in ragged_nbr],
                                         np.int64),
                ragged_nbr=(np.concatenate(ragged_nbr) if len(ragged_nbr)
                            else np.zeros(0, np.int64)).astype(np.int64),
                ragged_shells=(np.concatenate(ragged_shells)
                               if len(ragged_shells)
                               else np.zeros(0, np.int64)).astype(np.int64))
        self._store(key, payload)


# --------------------------------------------------------------- featurising

def _to_structure_dict(entry):
    """Accept dicts, pymatgen Structures, or ComputedStructureEntry."""
    if isinstance(entry, dict) and "lattice" in entry:
        return entry
    # pymatgen objects (optional dependency)
    structure = getattr(entry, "structure", entry)
    data = dict(getattr(entry, "data", {}) or {})
    try:
        return {
            "lattice": np.asarray(structure.lattice.matrix),
            "frac_coords": np.asarray([s.frac_coords for s in structure]),
            "species": [s.specie.symbol for s in structure],
            "data": data,
        }
    except AttributeError as e:
        raise TypeError(f"unsupported structure entry: {type(entry)}") from e


def periodic_neighbors_ragged(lattice, frac_coords, *, radius: float = 18.0,
                              max_nbr: int = 24):
    """Ragged variant: per-atom lists of up to ``max_nbr`` neighbors within
    ``radius`` — atoms may have fewer (the legacy featurizer's behaviour,
    reference CGAT/test_prepare_data.py:193-222). Returns per-atom lists
    (nbr_idx, shell, dist)."""
    A = np.asarray(lattice, np.float64)
    frac = np.asarray(frac_coords, np.float64) % 1.0
    n = len(frac)
    cart = frac @ A
    images = _candidate_images(A, radius)
    offsets = images @ A
    nbr_l, shell_l, dist_l = [], [], []
    for i in range(n):
        diff = cart[None, :, :] + offsets[:, None, :] - cart[i]
        d = np.sqrt(np.sum(diff * diff, axis=-1)).reshape(-1)
        j_of = np.broadcast_to(np.arange(n)[None, :],
                               (len(offsets), n)).reshape(-1)
        sel = (d <= radius) & (d > 1e-8)
        d_sel, j_sel = d[sel], j_of[sel]
        order = np.argsort(d_sel, kind="stable")[:max_nbr]
        dd, jj = d_sel[order], j_sel[order]
        sh = np.empty(len(dd), np.int64)
        index, prev = 1, dd[0] if len(dd) else 0.0
        for k in range(len(dd)):
            if dd[k] > prev + 1e-8:
                prev = dd[k]
                index += 1
            sh[k] = index
        nbr_l.append(jj.astype(np.int64))
        shell_l.append(sh)
        dist_l.append(dd)
    return nbr_l, shell_l, dist_l


def featurise_entry(entry, *, radius: float = 18.0, max_nbr: int = 24,
                    target_property: Sequence[str] = ("e_above_hull", "e_form"),
                    allow_incomplete: bool = False,
                    cache: FeaturizationCache | None = None):
    """One entry -> (shell, self_idx, nbr_idx, elements, targets, comp, id)
    or None when rejected. Targets are stored per-atom
    (prepare_data.py:139). With ``allow_incomplete`` crystals lacking
    ``max_nbr`` neighbors keep shorter (ragged) edge lists instead of being
    rejected (legacy test_prepare_data.py behaviour). ``cache`` skips the
    neighbor search for structures featurised in an earlier round."""
    s = _to_structure_dict(entry)
    species = list(s["species"])
    n = len(species)
    data = s.get("data", {})
    cry_id = data.get("id", "unknown")

    targets = {}
    for name in target_property:
        if name in data:
            targets[name] = float(data[name]) / n
        else:
            warnings.warn("no target property")
            targets[name] = -1e8

    key = (cache.key(s["lattice"], s["frac_coords"], radius, max_nbr)
           if cache is not None else None)
    hit = (cache.get(key, ragged=allow_incomplete)
           if cache is not None else None)
    nbr_l = shell_l = None
    if hit is not None and hit[0] == "knn":
        _, nbr_idx, shells = hit
        res = (nbr_idx, shells)
    elif hit is not None and hit[0] == "ragged":
        _, nbr_l, shell_l = hit
        res = None
    elif hit is not None:  # cached rejection, ragged lists not needed
        res = None
    else:
        res = periodic_neighbors(s["lattice"], s["frac_coords"],
                                 radius=radius, max_nbr=max_nbr)
        if res is not None:
            res = res[:2]
            if cache is not None:
                cache.put(key, *res)
    if res is None:
        if allow_incomplete:
            if nbr_l is None:
                nbr_l, shell_l, _ = periodic_neighbors_ragged(
                    s["lattice"], s["frac_coords"], radius=radius,
                    max_nbr=max_nbr)
                if cache is not None:
                    cache.put_rejected(key, nbr_l, shell_l)
            self_l = [np.full(len(nb), i, np.int64)
                      for i, nb in enumerate(nbr_l)]
            # ragged object arrays (legacy layout: lists per atom)
            shells = np.asarray(shell_l, dtype=object)
            self_idx = np.asarray(self_l, dtype=object)
            nbr_idx = np.asarray(nbr_l, dtype=object)
            comp = s.get("composition", " ".join(
                f"{el}{c}" for el, c in _count(species).items()))
            return shells, self_idx, nbr_idx, species, targets, comp, cry_id
        if cache is not None and hit is None:
            cache.put_rejected(key)
        warnings.warn(
            f"{cry_id} does not contain enough neighbors in the cutoff; "
            "compound is not added to the feature set")
        return None
    nbr_idx, shells = res
    self_idx = np.repeat(np.arange(n)[:, None], max_nbr, axis=1)
    # pymatgen formula format: space-separated "Na1 Cl1"
    comp = s.get("composition", " ".join(
        f"{el}{c}" for el, c in _count(species).items()))
    return shells, self_idx, nbr_idx, species, targets, comp, cry_id


def _count(species):
    c: dict[str, int] = {}
    for s in species:
        c[s] = c.get(s, 0) + 1
    return c


def _featurise_star(args):
    """Picklable worker for parallel featurisation (numpy and C++ only, no
    device state). The disk cache is safe under concurrent writers (atomic
    pid-suffixed temp files)."""
    entry, radius, max_nbr, target_property, cache_dir = args
    cache = FeaturizationCache(cache_dir) if cache_dir else None
    return featurise_entry(entry, radius=radius, max_nbr=max_nbr,
                           target_property=target_property, cache=cache)


def build_dataset_prepare(data, *, target_property=("e_above_hull", "e_form"),
                          radius: float = 18.0, fea_path: str | None = None,
                          max_neighbor_number: int = 24,
                          drop_unaries: bool = False, progress: bool = True,
                          cache: FeaturizationCache | str | None = None,
                          workers: int = 0):
    """Featurise a list (or gzipped pickle path) of structure entries into the
    reference's prepared-dict schema (prepare_data.py:14-98):
    ``{'input' (3, n) object rows [shell, self_idx, nbr_idx], 'batch_ids',
    'batch_comp', 'target' {name: [per-atom values]}, 'comps'}``.
    ``cache`` (a :class:`FeaturizationCache` or its directory path) makes
    repeat featurisation of overlapping structure sets incremental.
    ``workers > 1`` runs the neighbor search across processes, preserving
    entry order (the reference parallelises this with a shell loop over
    shards, Utilities/prepare.sh; here it is in-process).
    """
    if isinstance(cache, str):
        cache = FeaturizationCache(cache)
    if isinstance(data, str):
        with gzip.open(data, "rb") as f:
            data = pickle.load(f)

    if workers and workers > 1:
        import multiprocessing as mp

        from .. import native
        native.load()   # build once here; the workers load the library
        cache_dir = cache.path if cache is not None else None
        jobs = [(e, radius, max_neighbor_number, tuple(target_property),
                 cache_dir) for e in data]
        # spawn, not fork: the parent may hold torch's threads
        ctx = mp.get_context("spawn")
        with ctx.Pool(workers) as pool:
            results = pool.imap(_featurise_star, jobs,
                                chunksize=max(1, len(jobs) // (8 * workers)))
            it = _maybe_tqdm(results, progress, total=len(jobs))
            return _assemble_prepared(it, target_property, drop_unaries)

    it = _maybe_tqdm(
        (featurise_entry(entry, radius=radius, max_nbr=max_neighbor_number,
                         target_property=target_property, cache=cache)
         for entry in data), progress,
        total=len(data) if hasattr(data, "__len__") else None)
    return _assemble_prepared(it, target_property, drop_unaries)


def _maybe_tqdm(it, progress, total):
    if progress:
        try:
            from tqdm import tqdm
            return tqdm(it, total=total)
        except ImportError:
            pass
    return it


def _assemble_prepared(results, target_property, drop_unaries):
    shell_l, self_l, nbr_l, comps_l, bc_l, ids_l = [], [], [], [], [], []
    target_l = {name: [] for name in target_property}
    for out in results:
        if out is None:
            continue
        shells, self_idx, nbr_idx, species, targets, comp, cry_id = out
        if drop_unaries and len(set(species)) < 2:
            continue
        shell_l.append(shells)
        self_l.append(self_idx)
        nbr_l.append(nbr_idx)
        comps_l.append(np.asarray(species, dtype=object))
        bc_l.append(comp)
        ids_l.append(cry_id)
        for name in target_property:
            target_l[name].append(targets[name])

    n = len(shell_l)
    inputs = np.empty((3, n), dtype=object)
    for i in range(n):
        inputs[0, i] = shell_l[i]
        inputs[1, i] = self_l[i]
        inputs[2, i] = nbr_l[i]
    return {
        "input": inputs,
        "batch_ids": ids_l,
        "batch_comp": np.asarray(bc_l, dtype=object),
        "target": {k: np.asarray(v) for k, v in target_l.items()},
        "comps": np.asarray(comps_l, dtype=object),
    }


def prepare_graphs(entries, *, featuriser: Featuriser | None = None,
                   fea_path: str | None = None, target: str = "e_above_hull",
                   radius: float = 18.0, max_nbr: int = 24,
                   allow_incomplete: bool = False,
                   cache: FeaturizationCache | str | None = None):
    """Directly featurise entries into CrystalGraph records (skips the
    intermediate pickle; convenience path for in-memory pipelines)."""
    if isinstance(cache, str):
        cache = FeaturizationCache(cache)
    feat = featuriser or load_featuriser(fea_path)
    graphs = []
    for entry in entries:
        out = featurise_entry(entry, radius=radius, max_nbr=max_nbr,
                              target_property=(target,),
                              allow_incomplete=allow_incomplete,
                              cache=cache)
        if out is None:
            continue
        shells, self_idx, nbr_idx, species, targets, comp, cry_id = out
        if shells.dtype == object:  # ragged (allow_incomplete)
            shells = np.concatenate(list(shells))
            self_idx = np.concatenate(list(self_idx))
            nbr_idx = np.concatenate(list(nbr_idx))
        n = len(species)
        cnt = _count(species)
        distinct = list(cnt)
        weights = np.asarray([cnt[e] / n for e in distinct], np.float32)
        t = targets[target]
        y = t if target == "volume" else t * n
        graphs.append(CrystalGraph(
            atom_fea=feat.matrix(species),
            edge_src=self_idx.reshape(-1).astype(np.int32),
            edge_dst=nbr_idx.reshape(-1).astype(np.int32),
            edge_shell=shells.reshape(-1).astype(np.int32),
            comp_fea=feat.matrix(distinct),
            comp_weight=weights,
            target=y,
            cry_id=cry_id,
            composition=comp,
        ))
    return graphs
