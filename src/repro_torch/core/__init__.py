"""Core H-Transformer-1D hierarchical attention, decode cache and dense
oracles."""
from . import hierarchy
from .h1d_attention import (h1d_attention, h1d_attention_mha, fold_kv_heads,
                            unfold_kv_heads)
from .ref_attention import dense_attention, h1d_dense_oracle
from .h1d_decode import (H1DCache, init_cache, prefill_cache, update_cache,
                         decode_attend, update_cache_uniform,
                         decode_attend_uniform)

__all__ = [
    "hierarchy",
    "h1d_attention",
    "h1d_attention_mha",
    "fold_kv_heads",
    "unfold_kv_heads",
    "dense_attention",
    "h1d_dense_oracle",
    "H1DCache",
    "init_cache",
    "prefill_cache",
    "update_cache",
    "decode_attend",
    "update_cache_uniform",
    "decode_attend_uniform",
]
