from .optim import AdamW, project_params
from .trainer import (CheckpointManager, MetricsLogger, Trainer,
                      TrainerConfig, load_trainer, resume_trainer)

__all__ = ["AdamW", "CheckpointManager", "MetricsLogger", "Trainer",
           "TrainerConfig", "load_trainer", "project_params",
           "resume_trainer"]
