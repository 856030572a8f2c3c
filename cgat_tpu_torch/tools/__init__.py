"""The active-learning toolkit (``cgat_tpu/tools/``'s counterpart): shard
bookkeeping and sampling (numpy), the tools that read a trained model or
GP on the card, seed ensembles and model soups (``ensemble``), the
reference checkpoint's import and export (``import_torch``) and the
replayed step's device time by category (``step_trace``). Each
command-line tool runs as ``python -m cgat_tpu_torch.tools.<name>``."""
from . import (additional_data, analysis, annotate, embeddings, ensemble,
               errors, loop, sample, shards)
from .metropolis import MarkovChain
from .periodic import MAX_Z, SYMBOL_TO_Z, symbol_to_z

__all__ = [
    "analysis",
    "ensemble",
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
