from .optim import LAMB, SGD, Adam, AdamW, MultiSteps, project_params
from .trainer import (CheckpointManager, MetricsLogger, Trainer,
                      TrainerConfig, load_trainer, make_optimizer,
                      resume_trainer)

__all__ = ["LAMB", "SGD", "Adam", "AdamW", "CheckpointManager",
           "MetricsLogger", "MultiSteps", "Trainer", "TrainerConfig",
           "load_trainer", "make_optimizer", "project_params",
           "resume_trainer"]
