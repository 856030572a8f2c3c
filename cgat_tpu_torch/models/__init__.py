from .cgat import CGATConfig, CGAtNet, DropoutKey
from .convert import flat_from_state_dict, state_dict_from_jax
from .init import init_state_dict

__all__ = ["CGATConfig", "CGAtNet", "DropoutKey", "flat_from_state_dict",
           "init_state_dict", "state_dict_from_jax"]
