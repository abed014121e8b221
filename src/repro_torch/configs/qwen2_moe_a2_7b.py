"""Qwen2-MoE-A2.7B: 60 routed experts top-4 + shared expert
[hf:Qwen/Qwen1.5-MoE-A2.7B].

Port of ``repro.configs.qwen2_moe_a2_7b``, field for field.
"""
from repro_torch.models.common import ModelConfig


def config():
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=16, head_dim=128, d_ff=5632,
        vocab_size=151936, attention="h1d", nr=16,
        moe_experts=60, moe_top_k=4, moe_d_ff=1408, moe_shared_d_ff=5632,
        qkv_bias=True, dtype="bfloat16", remat=True)


def smoke():
    return ModelConfig(
        name="qwen2-moe-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        attention="h1d", nr=8, moe_experts=8, moe_top_k=2, moe_d_ff=32,
        moe_shared_d_ff=64, qkv_bias=True)


CONFIGS = {"qwen2-moe-a2.7b": config}
SMOKES = {"qwen2-moe-a2.7b": smoke}
