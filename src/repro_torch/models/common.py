"""Shared model components: config, dense projection, RMSNorm, RoPE,
activation.

Port of ``repro.models.common``.  ``ModelConfig`` mirrors the JAX
dataclass field for field with the same defaults, so a config built for
one package reads the same in the other; fields of families or features
this slice does not serve are carried but rejected where used.
Parameters are plain dictionaries of tensors; a dense weight has shape
(d_in, d_out) and is applied as ``x @ w``, as in the JAX package.

Every init function also builds the tensor-parallel spec of each leaf
it draws, beside the leaf, and returns ``(params, specs)`` (the model
inits only when asked, ``specs=True``).  A spec is a plain tuple
with one entry per dimension, ``None`` or a mesh axis name
(``parallel.sharding`` maps them onto a mesh).  The TP degree is the
init's ``tp`` argument (the reference reads it from ``set_mesh_axes``):
an axis shards over ``"model"`` only when ``tp`` divides its size, and
``tp=None`` makes no sharding decision, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | encdec | vlm | audio | ssm | hybrid
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    # --- attention ---------------------------------------------------------
    attention: str = "h1d"       # h1d | full
    nr: int = 16                 # N_r, the paper's single hyper-parameter
    causal_mode: str = "fine-q"  # fine-q (leak-free) | coarse-q
    attn_impl: str = "jnp"       # JAX backend choice; the port picks its
                                 # kernels by device and ignores it
    attn_tq: Optional[int] = None  # JAX tile override; ignored by the port
    decode_impl: str = "jnp"     # JAX backend choice; ignored by the port
    cache_dtype: str = "fp32"    # paged KV-page storage: fp32 | int8
    cache_quant_levels: int = -1
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0
    global_every: int = 0
    rope_theta: float = 10_000.0
    # --- FFN / MoE ---------------------------------------------------------
    mlp_activation: str = "swiglu"   # swiglu | geglu
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_d_ff: int = 0
    moe_dense_residual: bool = False
    moe_capacity_factor: float = 1.25
    moe_aux_loss: float = 0.01
    # --- SSM (mamba2 / hybrid) ---------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64
    hybrid_attn_every: int = 6
    # --- encoder-decoder ----------------------------------------------------
    encoder_layers: int = 0
    # --- frontends ----------------------------------------------------------
    prefix_len: int = 0
    # --- numerics / misc ----------------------------------------------------
    dtype: str = "float32"
    tie_embeddings: bool = False
    remat: bool = False
    force_loop: bool = False
    seq_parallel_residual: bool = True
    remat_policy: str = "dots"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_uses_global_attn(self, i: int) -> bool:
        """Whether layer ``i`` runs the config's global attention (h1d)
        rather than the sliding window: every layer without a cadence,
        else the last of every ``global_every``."""
        if self.global_every <= 0:
            return True
        return i % self.global_every == self.global_every - 1

    def layer_is_attn(self, i: int) -> bool:
        """hybrid (zamba2): whether the shared attention block runs after
        layer ``i``: the last of every ``hybrid_attn_every``."""
        return i % self.hybrid_attn_every == self.hybrid_attn_every - 1


TP_AXIS = "model"


def shard_if_divisible(size: int, tp: Optional[int]) -> Optional[str]:
    """``"model"`` when the TP degree ``tp`` divides ``size``, else None
    (replicated); ``tp=None`` decides nothing."""
    return TP_AXIS if tp and size % tp == 0 else None


def twin(params, specs, with_specs: bool):
    """What a model init returns: ``(params, specs)`` when asked, else
    the parameters alone."""
    return (params, specs) if with_specs else params


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: Optional[float] = None, dtype=torch.float32,
               in_shard: bool = False, out_shard: bool = True,
               tp: Optional[int] = None):
    """2D projection weight (d_in, d_out), drawn on the CPU from ``gen``
    (so the same seed gives the same weights on every device).  Its spec
    shards ``d_in`` (``in_shard``) and ``d_out`` (``out_shard``) where
    ``tp`` divides them."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": torch.randn((d_in, d_out), generator=gen, dtype=dtype) * s}
    spec = (shard_if_divisible(d_in, tp) if in_shard else None,
            shard_if_divisible(d_out, tp) if out_shard else None)
    return p, {"w": spec}


def norm_init(d: int, dtype):
    """An RMSNorm's gain, ones (d,); replicated."""
    return {"g": torch.ones((d,), dtype=dtype)}, {"g": (None,)}


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, *,
               tp: Optional[int] = None):
    """The token embedding (vocab, d), its rows over ``"model"``."""
    p = {"w": torch.randn((vocab, d), generator=gen, dtype=dtype) * 0.02}
    return p, {"w": (shard_if_divisible(vocab, tp), None)}


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (+ bias) with ``w`` of shape (d_in, d_out)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x: (B, S, H, D); positions: (B, S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)           # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs    # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    if name == "swiglu":
        return F.silu
    if name == "geglu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)
