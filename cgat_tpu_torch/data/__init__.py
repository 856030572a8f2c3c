from .batching import (OFFN_MARGIN, CrystalBatch, CrystalGraph, HaloBatch,
                       collate, host_offsets, pad_to_bucket)

__all__ = ["OFFN_MARGIN", "CrystalBatch", "CrystalGraph", "HaloBatch",
           "collate", "host_offsets", "pad_to_bucket"]
