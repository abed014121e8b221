"""Zamba2-1.2B: Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242].  The shared block's attention is causal H1D.

Port of ``repro.configs.zamba2_1_2b``, field for field.
"""
from repro_torch.models.common import ModelConfig


def config():
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
        num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
        vocab_size=32000, attention="h1d", nr=16,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        hybrid_attn_every=6, tie_embeddings=True, dtype="bfloat16",
        remat=True)


def smoke():
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", num_layers=6, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        attention="h1d", nr=8, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
        ssm_chunk=16, hybrid_attn_every=3, tie_embeddings=True)


CONFIGS = {"zamba2-1.2b": config}
SMOKES = {"zamba2-1.2b": smoke}
