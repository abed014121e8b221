"""Distribution: sequence-parallel serving over a sharded hierarchical
KV cache (one controller, shards on one device in this slice)."""
from .sp_attention import (SPCache, SPMesh, SPTables, scatter_rows,
                           shard_cache, shard_caches, sp_band_attention,
                           sp_ctx, sp_decode_attend, sp_h1d_attention,
                           sp_scope, sp_sharded_levels, sp_tables,
                           sp_update_cache, unshard_cache, unshard_caches)

__all__ = ["SPCache", "SPMesh", "SPTables", "scatter_rows", "shard_cache",
           "shard_caches", "sp_band_attention", "sp_ctx", "sp_decode_attend",
           "sp_h1d_attention", "sp_scope", "sp_sharded_levels", "sp_tables",
           "sp_update_cache", "unshard_cache", "unshard_caches"]
