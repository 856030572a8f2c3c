"""Hand-written CUDA kernels of the port (sources in ``cgat_tpu_torch/csrc``),
each module holding a kernel's wrapper, its launch count and its plain
PyTorch version. Importing builds nothing."""
from . import hyper_apply, mh_network, segment_attention

# the launch wrappers, each with its ``launches`` count
KERNEL_WRAPPERS = (segment_attention.segment_attention,
                   mh_network.mh_network, hyper_apply.hyper_apply)

__all__ = ["KERNEL_WRAPPERS", "hyper_apply", "mh_network",
           "segment_attention"]
