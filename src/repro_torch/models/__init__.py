"""The models in PyTorch: the decoder LM (the dense, moe, vlm, ssm and
hybrid families), the encoder-decoder (seamless-m4t) and the LRA encoder
classifier."""
from .common import ModelConfig
from .registry import get_model, ModelFns
from .classifier import classifier_init, classifier_logits, classifier_loss
