"""SeamlessM4T-medium backbone: encoder-decoder, the audio front end
stubbed [arXiv:2308.11596].  The sequence length applies to the (long)
audio frame axis; the decoder runs a fixed modest target length.

Port of ``repro.configs.seamless_m4t_medium``, field for field.
"""
from repro_torch.models.common import ModelConfig

DECODER_LEN = 1024  # teacher-forced / prefill target length


def config():
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec", num_layers=12,
        encoder_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=4096, vocab_size=256206, attention="h1d", nr=16,
        dtype="bfloat16", remat=True)


def smoke():
    return ModelConfig(
        name="seamless-smoke", family="encdec", num_layers=2,
        encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, attention="h1d", nr=8)


CONFIGS = {"seamless-m4t-medium": config}
SMOKES = {"seamless-m4t-medium": smoke}
