"""Hand-written CUDA kernels of the port (sources in ``cgat_tpu_torch/csrc``),
each module holding its kernels' wrappers, their plain PyTorch versions
and the autograd Function that joins a forward kernel to its backward;
``adamw`` holds the optimizer's fused update. Every launch goes through
``build.run``, which counts it under its C entry's name
(``build.launch_counts``). Importing builds nothing."""
from . import (adamw, dropout, hyper_apply, mh_network, segment_attention,
               segment_sum)

# the C entry (``build.launch_counts``' key) each kernel wrapper launches
# through, by the wrapper's name; dropout's forward and backward share one
ENTRIES = {"segment_attention": "cgat_segment_attention_fwd",
           "mh_network": "cgat_mh_network_fwd",
           "hyper_apply": "cgat_hyper_apply_fwd",
           "segment_attention_bwd": "cgat_segment_attention_bwd",
           "mh_network_bwd": "cgat_mh_network_bwd",
           "hyper_apply_bwd_dhdx": "cgat_hyper_apply_bwd_dhdx",
           "hyper_apply_bwd_dk": "cgat_hyper_apply_bwd_dk",
           "segment_sum": "cgat_segment_sum", "dropout": "cgat_dropout"}

__all__ = ["adamw", "dropout", "hyper_apply", "mh_network",
           "segment_attention", "segment_sum"]
