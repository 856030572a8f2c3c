from .artifact import ServingModel, load_artifact

__all__ = ["ServingModel", "load_artifact"]
