"""Command-line entry points of the port, run as
``python -m cgat_tpu_torch.cli.<prepare|train|evaluate|predict>``."""
