from .model import Model
from .modules import ArraySpec, init_params, param_count

__all__ = ["Model", "ArraySpec", "init_params", "param_count"]
