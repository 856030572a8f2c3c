"""Element-embedding featuriser, counterpart of ``cgat_tpu/data/embedding.py``
(reference: CGAT/roost_message.py:33-84).

Loads an element -> vector table from JSON. The matscholar 200-d embedding
(public data from the matscholar project, shipped with the reference under
embeddings/matscholar-embedding.json) is bundled in this package as the
default.
"""
from __future__ import annotations

import json
import os
from importlib import resources

import numpy as np

DEFAULT_EMBEDDING = "matscholar-embedding.json"


class Featuriser:
    """Element -> feature-vector lookup (roost_message.py:33-55)."""

    def __init__(self, embedding: dict[str, np.ndarray]):
        self._embedding = {k: np.asarray(v, dtype=np.float32)
                           for k, v in embedding.items()}
        self.allowed_types = set(self._embedding)

    def get_fea(self, key: str) -> np.ndarray:
        if key not in self.allowed_types:
            raise KeyError(f"{key} is not an allowed atom type")
        return self._embedding[key]

    @property
    def embedding_size(self) -> int:
        return len(next(iter(self._embedding.values())))

    def state_dict(self):
        return self._embedding

    def matrix(self, symbols: list[str]) -> np.ndarray:
        return np.stack([self.get_fea(s) for s in symbols])


def _bundled(name: str):
    return resources.files("cgat_tpu_torch.data") / "embeddings" / name


def load_featuriser(path: str | None = None) -> Featuriser:
    """A featuriser from ``path``; a path that does not exist is looked up
    by its file name among the bundled embeddings; None gives the bundled
    matscholar embedding (LoadFeaturiser, roost_message.py:58-84)."""
    if path is None:
        return Featuriser(json.loads(_bundled(DEFAULT_EMBEDDING).read_text()))
    if os.path.exists(path):
        with open(path) as f:
            return Featuriser(json.load(f))
    bundled = _bundled(os.path.basename(path))
    if bundled.is_file():
        return Featuriser(json.loads(bundled.read_text()))
    raise FileNotFoundError(path)
