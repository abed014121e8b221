"""LLaVA-NeXT-34B backbone (Yi-34B-ish decoder); the anyres vision
frontend is stubbed: callers pass precomputed patch embeddings
(``batch["patch_embeds"]``, (B, PATCHES, d)) as a 1D prefix before the
tokens [hf:llava-hf/llava-v1.6].

Port of ``repro.configs.llava_next_34b``, field for field.
"""
from repro_torch.models.common import ModelConfig

PATCHES = 576  # one image of stubbed anyres patch embeddings


def config():
    return ModelConfig(
        name="llava-next-34b", family="vlm", num_layers=60, d_model=7168,
        num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480,
        vocab_size=64000, attention="h1d", nr=16, prefix_len=PATCHES,
        rope_theta=5_000_000.0, dtype="bfloat16", remat=True)


def smoke():
    return ModelConfig(
        name="llava-smoke", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        attention="h1d", nr=8, prefix_len=16)


CONFIGS = {"llava-next-34b": config}
SMOKES = {"llava-next-34b": smoke}
