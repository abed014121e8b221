"""Qwen2.5-14B: dense GQA with QKV bias [hf:Qwen/Qwen2.5].

Port of ``repro.configs.qwen2_5_14b``, field for field.
"""
from repro_torch.models.common import ModelConfig


def config():
    return ModelConfig(
        name="qwen2.5-14b", family="dense", num_layers=48, d_model=5120,
        num_heads=40, num_kv_heads=8, head_dim=128, d_ff=13824,
        vocab_size=152064, qkv_bias=True, attention="h1d", nr=16,
        rope_theta=1_000_000.0, dtype="bfloat16", remat=True)


def smoke():
    return ModelConfig(
        name="qwen2.5-14b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        qkv_bias=True, attention="h1d", nr=8)


CONFIGS = {"qwen2.5-14b": config}
SMOKES = {"qwen2.5-14b": smoke}
