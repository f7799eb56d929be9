from .config import ModelConfig, reduced_config
from .model import Model, build_model

__all__ = ["ModelConfig", "reduced_config", "Model", "build_model"]
