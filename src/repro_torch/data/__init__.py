from .pipeline import DataConfig, Pipeline, SyntheticLM

__all__ = ["DataConfig", "Pipeline", "SyntheticLM"]
