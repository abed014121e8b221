"""Mamba2-1.3B: attention-free SSD [arXiv:2405.21060].

Port of ``repro.configs.mamba2_1_3b``, field for field.
"""
from repro_torch.models.common import ModelConfig


def config():
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
        num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        tie_embeddings=True, dtype="bfloat16", remat=True)


def smoke():
    return ModelConfig(
        name="mamba2-smoke", family="ssm", num_layers=2, d_model=64,
        num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=512,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
        tie_embeddings=True)


CONFIGS = {"mamba2-1.3b": config}
SMOKES = {"mamba2-1.3b": smoke}
