"""The paper's own models (section 8.2): 53M / 144M decoder LMs with
N_r=16 hierarchical attention, plus the LRA-style encoder (section 8.1:
6L / 8H / 512 / FFN 2048)."""
from repro_torch.models.common import ModelConfig


def _lm(name, d_model, d_ff):
    return ModelConfig(
        name=name, family="dense", num_layers=6, d_model=d_model,
        num_heads=8, num_kv_heads=8, head_dim=d_model // 8, d_ff=d_ff,
        vocab_size=32768, attention="h1d", nr=16, causal_mode="fine-q",
        tie_embeddings=True)


CONFIGS = {
    "h1d-lm-53m": lambda: _lm("h1d-lm-53m", 512, 2048),
    "h1d-lm-144m": lambda: _lm("h1d-lm-144m", 1024, 4096),
    "h1d-lra-encoder": lambda: ModelConfig(
        name="h1d-lra-encoder", family="dense", num_layers=6, d_model=512,
        num_heads=8, num_kv_heads=8, head_dim=64, d_ff=2048,
        vocab_size=256, attention="h1d", nr=16, tie_embeddings=True),
}

SMOKES = {
    k: (lambda k=k: ModelConfig(
        name=f"{k}-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        attention="h1d", nr=8, tie_embeddings=True))
    for k in CONFIGS
}
