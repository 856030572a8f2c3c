from .optim import AdamW, project_params
from .trainer import Trainer, TrainerConfig

__all__ = ["AdamW", "Trainer", "TrainerConfig", "project_params"]
