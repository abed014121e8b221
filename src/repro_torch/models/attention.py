"""Attention layer of the paper's models: H1D attention for training
and encoding (causal for the LM, bidirectional for the LRA encoder),
with prefill and single-token decode paths for the LM.

Port of the h1d branches of ``repro.models.attention``.  The decode cache
of a layer is a ``core.h1d_decode.H1DCache`` with ``batch * kv_heads``
folded into its rows (row ``b*Hkv + h``); on the paged path it is a
per-layer page pool (``core.h1d_decode.PagedH1DCache`` or
``QuantPagedH1DCache``) addressed through per-tick page tables.  Prefill
runs the operator in the config's ``causal_mode`` and builds the fine-q
hierarchical cache either way; decode is the fine-q decode for both
modes, as in the reference.  Full and sliding-window attention are not
ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from ..core import h1d_decode, h1d_attention_mha
from ..core import hierarchy as hc
from .common import ModelConfig, dense, dense_init, rmsnorm, apply_rope


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attention != "h1d" or cfg.sliding_window > 0:
        raise NotImplementedError(
            f"attention={cfg.attention!r} with sliding_window="
            f"{cfg.sliding_window} is not ported yet (this slice serves "
            "h1d attention)")


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    hq, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {"wq": dense_init(gen, d, hq * hd, dtype=dtype),
         "wkv": dense_init(gen, d, 2 * hkv * hd, dtype=dtype),
         "wo": dense_init(gen, hq * hd, d, scale=1.0 / math.sqrt(hq * hd),
                          dtype=dtype)}
    if cfg.qkv_bias:
        p["wq"]["b"] = torch.zeros((hq * hd,), dtype=dtype)
        p["wkv"]["b"] = torch.zeros((2 * hkv * hd,), dtype=dtype)
    if cfg.qk_norm:
        p["qn"] = {"g": torch.ones((hd,), dtype=dtype)}
        p["kn"] = {"g": torch.ones((hd,), dtype=dtype)}
    return p


def _project_qkv(p, cfg: ModelConfig, x, positions):
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd); the fused ``wkv`` holds k in its
    first half and v in its second."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(B, S, hq, hd)
    k, v = torch.chunk(dense(p["wkv"], x), 2, dim=-1)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(p, cfg: ModelConfig, q, k, v, kv_weight, causal: bool):
    """H1D attention over projected (B,S,H,hd) heads and the output
    projection.  Pads S to ``nr * 2**k`` with weight-0 keys."""
    B, S = q.shape[:2]
    Lp = hc.padded_length(S, cfg.nr)
    pad = Lp - S
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (q, k, v))
    w = torch.ones((B, Lp), dtype=torch.float32, device=q.device)
    if kv_weight is not None:
        w = w * torch.nn.functional.pad(kv_weight.to(torch.float32),
                                        (0, pad))
    elif pad:
        w[:, S:] = 0.0
    z = h1d_attention_mha(q, k, v, nr=cfg.nr, causal=causal,
                          causal_mode=cfg.causal_mode, kv_weight=w)[:, :S]
    return dense(p["wo"], z.reshape(B, S, -1))


def attn_apply(p, cfg: ModelConfig, x, positions, *, causal=True,
               kv_weight=None):
    """Training/encoding attention, causal (the LM, fine-q or coarse-q
    by ``cfg.causal_mode``) or bidirectional (the encoder).  x: (B, S,
    d); positions: (B, S); kv_weight: (B, S) key weights (0 = padding)."""
    _check_supported(cfg)
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _attend(p, cfg, q, k, v, kv_weight, causal)


def init_decode_cache(cfg: ModelConfig, B: int, Lmax: int, *,
                      dtype=torch.float32, device=None):
    _check_supported(cfg)
    Lmax = hc.padded_length(Lmax, cfg.nr)   # needs nr * 2**k
    return h1d_decode.init_cache(B * cfg.num_kv_heads, Lmax, cfg.head_dim,
                                 cfg.head_dim, cfg.nr, dtype=dtype,
                                 device=device)


def attn_decode(p, cfg: ModelConfig, x, t, cache, *, page_tables=None,
                sp_tables=None):
    """Single-token decode.  x: (B, 1, d); t: (B,) int32 current position.
    Updates ``cache`` in place; returns (out (B, 1, d), cache).

    ``page_tables`` (``core.h1d_decode.PageTables``) switches to the
    paged pool: ``cache`` is then a ``PagedH1DCache`` (or, with int8
    pages, a ``QuantPagedH1DCache``) and the tables route every block
    read and write; the core entry points dispatch on the pool type.  A
    sequence-sharded cache (``parallel.sp_attention.SPCache``, inside
    ``sp_scope``) takes the tick's shard geometry ``sp_tables``."""
    _check_supported(cfg)
    B = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = hq // hkv
    q, k, v = _project_qkv(p, cfg, x, t[:, None])
    q1 = q[:, 0].reshape(B * hkv, G, hd).contiguous()
    k1 = k[:, 0].reshape(B * hkv, hd).contiguous()
    v1 = v[:, 0].reshape(B * hkv, hd).contiguous()
    if page_tables is not None:
        tt = t.to(torch.int32).repeat_interleave(hkv)
        cache = h1d_decode.update_cache_paged(cache, k1, v1, tt,
                                              page_tables.update)
        z = h1d_decode.decode_attend_paged(cache, q1, tt, page_tables.attend,
                                           nr=cfg.nr)
    elif B == 1:
        # uniform position: the scalar t is broadcast per row into the
        # same kernels as the batched path
        cache = h1d_decode.update_cache_uniform(cache, k1, v1, t[0],
                                                tables=sp_tables)
        z = h1d_decode.decode_attend_uniform(cache, q1, t[0], nr=cfg.nr,
                                             tables=sp_tables)
    else:
        tt = t.to(torch.int32).repeat_interleave(hkv)
        cache = h1d_decode.update_cache(cache, k1, v1, tt, tables=sp_tables)
        z = h1d_decode.decode_attend(cache, q1, tt, nr=cfg.nr,
                                     tables=sp_tables)
    z = z.reshape(B, 1, hq * hd)
    return dense(p["wo"], z), cache


def prefill_into_cache(p, cfg: ModelConfig, x, positions, Lmax: int):
    """Run attention over a prefix (in ``cfg.causal_mode``) AND build the
    decode cache (fine-q, from the prefix's keys and values).  Returns
    (out (B, S, d), cache)."""
    _check_supported(cfg)
    B, S, _ = x.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _attend(p, cfg, q, k, v, None, True)
    kf = k.permute(0, 2, 1, 3).reshape(B * hkv, S, hd)
    vf = v.permute(0, 2, 1, 3).reshape(B * hkv, S, hd)
    cache = h1d_decode.prefill_cache(kf, vf, hc.padded_length(Lmax, cfg.nr),
                                     cfg.nr)
    return out, cache
