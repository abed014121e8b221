"""Distribution: sharding rules over a mesh description, GPipe pipelining
and sequence-parallel serving and training over a sharded hierarchical
KV cache, every shard in one process or one shard a process over a
``torch.distributed`` group (``group.py``), and tensor- and
data-parallel training over a ``DATAxMODEL`` mesh (``tensor.py``)."""
from .pipeline import pipeline_apply
from .sharding import (Mesh, NamedSharding, abstract_mesh, batch_shardings,
                       cache_shardings, dp_axes, dp_size, param_shardings,
                       per_device_bytes, replicated, shard_shape, tp_axis,
                       tp_size)
from .sp_attention import (SPCache, SPMesh, SPTables, scatter_rows,
                           shard_cache, shard_caches, sp_band_attention,
                           sp_ctx, sp_decode_attend, sp_h1d_attention,
                           sp_scope, sp_sharded_levels, sp_tables,
                           sp_update_cache, unshard_cache, unshard_caches)

__all__ = ["Mesh", "NamedSharding", "SPCache", "SPMesh", "SPTables",
           "abstract_mesh", "batch_shardings", "cache_shardings", "dp_axes",
           "dp_size", "param_shardings", "per_device_bytes",
           "pipeline_apply", "replicated", "scatter_rows", "shard_cache",
           "shard_caches", "shard_shape", "sp_band_attention", "sp_ctx",
           "sp_decode_attend", "sp_h1d_attention", "sp_scope",
           "sp_sharded_levels", "sp_tables", "sp_update_cache", "tp_axis",
           "tp_size", "unshard_cache", "unshard_caches"]
