"""The paper's decoder LM (dense family) in PyTorch."""
from .common import ModelConfig
from .registry import get_model, ModelFns
