"""Gemma3-4B: 5:1 local:global attention [hf:google/gemma-3].

Port of ``repro.configs.gemma3_4b``.  Local layers: block-local sliding
window (1024), through the streamed ``l0_causal`` kernel.  Global layers
(every sixth): H1D.  Published in bfloat16: weights, activations and
caches bf16, the band kernels fed f32 (``models.attention``).
"""
from repro_torch.models.common import ModelConfig


def config():
    return ModelConfig(
        name="gemma3-4b", family="dense", num_layers=34, d_model=2560,
        num_heads=8, num_kv_heads=4, head_dim=256, d_ff=10240,
        vocab_size=262144, attention="h1d", nr=16, sliding_window=1024,
        global_every=6, qk_norm=True, mlp_activation="geglu",
        tie_embeddings=True, rope_theta=1_000_000.0, dtype="bfloat16",
        remat=True)


def smoke():
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense", num_layers=6, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        attention="h1d", nr=8, sliding_window=16, global_every=3,
        qk_norm=True, mlp_activation="geglu", tie_embeddings=True)


CONFIGS = {"gemma3-4b": config}
SMOKES = {"gemma3-4b": smoke}
