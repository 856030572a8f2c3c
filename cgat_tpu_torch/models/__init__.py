from .cgat import CGATConfig, CGAtNet
from .convert import flat_from_state_dict, state_dict_from_jax
from .init import init_state_dict

__all__ = ["CGATConfig", "CGAtNet", "flat_from_state_dict", "init_state_dict",
           "state_dict_from_jax"]
