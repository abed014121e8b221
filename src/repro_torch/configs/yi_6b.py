"""Yi-6B: llama-arch dense GQA [arXiv:2403.04652].

Port of ``repro.configs.yi_6b``, field for field.
"""
from repro_torch.models.common import ModelConfig


def config():
    return ModelConfig(
        name="yi-6b", family="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=4, head_dim=128, d_ff=11008,
        vocab_size=64000, attention="h1d", nr=16, rope_theta=5_000_000.0,
        dtype="bfloat16", remat=True,
        seq_parallel_residual=False)


def smoke():
    return ModelConfig(
        name="yi-6b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=8, num_kv_heads=2, head_dim=8, d_ff=128, vocab_size=512,
        attention="h1d", nr=8)


CONFIGS = {"yi-6b": config}
SMOKES = {"yi-6b": smoke}
