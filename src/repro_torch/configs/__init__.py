from .base import SHAPES, ModelConfig, ShapeSpec, get_config, list_archs, register, shape_applicable

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "list_archs",
    "register",
    "shape_applicable",
]
