from .cgat import CGATConfig, CGAtNet
from .convert import state_dict_from_jax
from .init import init_state_dict

__all__ = ["CGATConfig", "CGAtNet", "init_state_dict", "state_dict_from_jax"]
