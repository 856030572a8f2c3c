"""cgat_tpu_torch: the PyTorch/CUDA port of cgat_tpu for NVIDIA Hopper.

Mirrors the JAX package's modules (``data``, ``ops``, ``models``,
``training``, ``serving``) and imports nothing of it. Hot ops run as
hand-written CUDA kernels (``csrc/``, built with nvcc at first use) on CUDA
tensors and as their plain PyTorch versions on CPU tensors. Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""
