"""The GP uncertainty head (``cgat_tpu/uncertainty/``'s counterpart)."""
from .gp import (
    GPConfig,
    GPParams,
    confidence_region,
    elbo,
    embedding_dataset,
    fit_gp,
    fit_gp_streaming,
    gp_predict_f,
    gp_predict_y,
    init_gp,
    kl_divergence,
    load_gp,
    train_gp_from_checkpoint,
)

__all__ = [
    "GPConfig",
    "GPParams",
    "confidence_region",
    "elbo",
    "embedding_dataset",
    "fit_gp",
    "fit_gp_streaming",
    "gp_predict_f",
    "gp_predict_y",
    "init_gp",
    "kl_divergence",
    "load_gp",
    "train_gp_from_checkpoint",
]
