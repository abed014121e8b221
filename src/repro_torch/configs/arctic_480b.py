"""Snowflake Arctic-480B: dense-MoE hybrid, 128 experts top-2 with a dense
FFN residual branch [hf:Snowflake/snowflake-arctic-base].

Port of ``repro.configs.arctic_480b``, field for field.  Its 476.9 B
parameters do not fit one card: the port runs its smoke config and
sizes the full one on the ``meta`` device.
"""
from repro_torch.models.common import ModelConfig


def config():
    return ModelConfig(
        name="arctic-480b", family="moe", num_layers=35, d_model=7168,
        num_heads=56, num_kv_heads=8, head_dim=128, d_ff=4864,
        vocab_size=32000, attention="h1d", nr=16,
        moe_experts=128, moe_top_k=2, moe_d_ff=4864,
        moe_dense_residual=True, dtype="bfloat16", remat=True)


def smoke():
    return ModelConfig(
        name="arctic-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=512,
        attention="h1d", nr=8, moe_experts=8, moe_top_k=2, moe_d_ff=64,
        moe_dense_residual=True)


CONFIGS = {"arctic-480b": config}
SMOKES = {"arctic-480b": smoke}
