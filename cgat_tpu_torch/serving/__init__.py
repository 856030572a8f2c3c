from .artifact import ServingModel, export_artifact, load_artifact

__all__ = ["ServingModel", "export_artifact", "load_artifact"]
