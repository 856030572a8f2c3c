from .attention import edge_softmax_aggregate
from .segment import segment_max, segment_softmax, segment_sum

__all__ = ["edge_softmax_aggregate", "segment_max", "segment_softmax",
           "segment_sum"]
