"""Hand-written CUDA kernels of the port (sources in ``cgat_tpu_torch/csrc``),
each module holding its kernels' wrappers, their launch counts, their plain
PyTorch versions and the autograd Function that joins a forward kernel to
its backward; ``adamw`` holds the optimizer's fused update, which counts
its launches in a ``utils.counters`` counter that CUDA graph replays keep
(``adamw.stats``), so it is not among ``KERNEL_WRAPPERS``, whose counts
are of eager calls alone. Importing builds nothing."""
from . import (adamw, dropout, hyper_apply, mh_network, segment_attention,
               segment_sum)

# the launch wrappers, the TPU kernels' forwards first, then their
# backwards, then the port's own dropout; each with its ``launches`` count
KERNEL_WRAPPERS = (segment_attention.segment_attention,
                   mh_network.mh_network, hyper_apply.hyper_apply,
                   segment_attention.segment_attention_bwd,
                   mh_network.mh_network_bwd,
                   hyper_apply.hyper_apply_bwd_dhdx,
                   hyper_apply.hyper_apply_bwd_dk, segment_sum.segment_sum,
                   dropout.dropout, dropout.dropout_bwd)

__all__ = ["KERNEL_WRAPPERS", "adamw", "dropout", "hyper_apply", "mh_network",
           "segment_attention", "segment_sum"]
