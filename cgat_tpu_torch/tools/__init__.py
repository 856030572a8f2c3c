"""The active-learning toolkit (``cgat_tpu/tools/``'s counterpart, less
``ensemble`` and ``import_torch``): shard bookkeeping and sampling
(numpy), and the tools that read a trained model or GP on the card. Each
command-line tool runs as ``python -m cgat_tpu_torch.tools.<name>``."""
from . import (additional_data, analysis, annotate, embeddings, errors, loop,
               sample, shards)
from .metropolis import MarkovChain
from .periodic import MAX_Z, SYMBOL_TO_Z, symbol_to_z

__all__ = [
    "analysis",
    "annotate",
    "embeddings",
    "errors",
    "sample",
    "shards",
    "MarkovChain",
    "MAX_Z",
    "SYMBOL_TO_Z",
    "symbol_to_z",
]
