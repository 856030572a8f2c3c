from .attention import edge_softmax_aggregate, edge_softmax_aggregate_pair
from .segment import (segment_max, segment_softmax, segment_softmax_pair,
                      segment_sum)

__all__ = ["edge_softmax_aggregate", "edge_softmax_aggregate_pair",
           "segment_max", "segment_softmax", "segment_softmax_pair",
           "segment_sum"]
