"""Llama-3.2-1B: small llama3, tied embeddings [hf:meta-llama/Llama-3.2-1B].

Port of ``repro.configs.llama3_2_1b``, field for field.
"""
from repro_torch.models.common import ModelConfig


def config():
    return ModelConfig(
        name="llama3.2-1b", family="dense", num_layers=16, d_model=2048,
        num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192,
        vocab_size=128256, tie_embeddings=True, attention="h1d", nr=16,
        rope_theta=500_000.0, dtype="bfloat16", remat=True,
        seq_parallel_residual=False)


def smoke():
    return ModelConfig(
        name="llama3.2-1b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        tie_embeddings=True, attention="h1d", nr=8)


CONFIGS = {"llama3.2-1b": config}
SMOKES = {"llama3.2-1b": smoke}
