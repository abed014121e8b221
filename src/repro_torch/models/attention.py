"""Attention layer: H1D attention (the paper), full attention (its
baseline) and block-local sliding-window attention (gemma3's local
layers), for training and encoding (causal for the LM, bidirectional for
the LRA encoder), with prefill and single-token decode paths for the LM.

Port of ``repro.models.attention``.  The decode cache of an h1d layer is
a ``core.h1d_decode.H1DCache`` with ``batch * kv_heads`` folded into its
rows (row ``b*Hkv + h``); on the paged path it is a per-layer page pool
(``core.h1d_decode.PagedH1DCache`` or ``QuantPagedH1DCache``) addressed
through per-tick page tables.  Prefill runs the operator in the config's
``causal_mode`` and builds the fine-q hierarchical cache either way;
decode is the fine-q decode for both modes, as in the reference.

A full layer (``attention='full'``) runs ``core.ref_attention.
dense_attention`` in plain torch, as the reference runs it in jnp (no
TPU kernel stands behind it), with kv-heads folded into the batch so
that K/V are never copied per GQA group.  Its decode cache is the dense
``{"k", "v": (B, Lmax, Hkv, hd), "pos": (B, Lmax) int32}``, slot ``t``,
``pos = -1`` where empty.

A local layer (``cfg.sliding_window > 0`` and ``layer_global=False``,
checked first, so a full config with a window is local there too) runs
one band level of block size ``window`` (``l0_causal`` or ``l0_bidir``;
the streamed kernel on the card at a causal window past 64) and keeps a
rolling cache of the same layout holding the last ``Lc = min(Lmax, 2 *
window)`` tokens, slot ``t % Lc``.  Full and local layers decode through
one plain-torch branch, as the reference's is one jnp branch outside any
kernel; only the local one tests the window.

Under a model axis (``parallel.tensor``, training on a ``DATAxMODEL``
mesh) a column-parallel ``wq`` gives a rank its ``hq / M`` heads, and the
layer runs on them alone: ``wkv``'s own shard holds the k and v columns
of the rank's kv heads (split by head, ``[K_m | V_m]``), or, where ``hkv``
does not divide over the axis and ``wkv`` stays whole, the rank takes the
columns of the kv heads its q heads read; the band kernels run per rank
on those heads, and ``wo``'s row-parallel product sums the heads' parts.
A replicated ``wq`` runs the whole layer on every rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import (dense_attention, h1d_decode, h1d_attention_mha,
                    fold_kv_heads, unfold_kv_heads)
from ..core import hierarchy as hc
from ..kernels.ops import band_attention
from ..parallel import tensor
from .common import (ModelConfig, apply_rope, dense, dense_init, norm_init,
                     rmsnorm)


def _check_supported(cfg: ModelConfig) -> None:
    """The reference's ``attn_apply`` takes ``h1d`` and ``full`` and
    raises ``ValueError`` for any other name."""
    if cfg.attention not in ("h1d", "full"):
        raise ValueError(cfg.attention)


def _is_local(cfg: ModelConfig, layer_global: bool) -> bool:
    return cfg.sliding_window > 0 and not layer_global


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
              *, tp: Optional[int] = None):
    """The projections ``wq``, ``wkv`` (k and v fused), ``wo`` (+ biases,
    + ``qn`` / ``kn``).  Their specs are the reference's head-aware ones:
    ``wq`` / ``wkv`` shard their outputs only when ``tp`` divides the
    query / kv head count, ``wo`` its input."""
    hq, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    heads = tp or 1
    p, s = {}, {}
    p["wq"], s["wq"] = dense_init(gen, d, hq * hd, dtype=dtype,
                                  out_shard=hq % heads == 0, tp=tp)
    p["wkv"], s["wkv"] = dense_init(gen, d, 2 * hkv * hd, dtype=dtype,
                                    out_shard=hkv % heads == 0, tp=tp)
    p["wo"], s["wo"] = dense_init(gen, hq * hd, d,
                                  scale=1.0 / math.sqrt(hq * hd), dtype=dtype,
                                  in_shard=True, out_shard=False, tp=tp)
    if cfg.qkv_bias:
        for n, width in (("wq", hq * hd), ("wkv", 2 * hkv * hd)):
            p[n]["b"] = torch.zeros((width,), dtype=dtype)
            s[n]["b"] = s[n]["w"][1:]
    if cfg.qk_norm:
        for n in ("qn", "kn"):
            p[n], s[n] = norm_init(hd, dtype)
    return p, s


def _heads_sharded(p) -> bool:
    """Whether this rank runs its own heads only (a column-parallel
    ``wq`` under a model axis)."""
    return tensor.sharded(p["wq"]["w"], 1)


def _rank_kv_heads(cfg: ModelConfig, hl: int, m: int):
    """[h0, h1) of the kv heads that q heads ``[m hl, (m + 1) hl)`` read
    (kv head ``h // G``): whole groups, or a part of one group."""
    G = cfg.num_heads // cfg.num_kv_heads
    if hl % G and G % hl:
        raise NotImplementedError(
            f"{cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads: a "
            f"rank's {hl} q heads cut across GQA groups of {G}; tensor "
            f"parallelism takes whole groups or parts of one (ROADMAP A.14)")
    h0 = m * hl // G
    return h0, h0 + max(hl // G, 1)


def _rank_qkv(p, cfg: ModelConfig, x):
    """This rank's q heads and the k | v columns of the kv heads they
    read, from one :func:`~repro_torch.parallel.tensor.copy_to` of ``x``;
    a replicated ``wkv``'s weights (used here for this rank's heads only)
    and the q / k norms' gains pass through ``copy_to`` too, so each sums
    its rank-partial gradient over the axis."""
    q, kv = tensor.column(x, p["wq"], p["wkv"]) if tensor.sharded(
        p["wkv"]["w"], 1) else (tensor.column(x, p["wq"])[0], None)
    norms = {n: {"g": tensor.copy_to(p[n]["g"])} for n in ("qn", "kn")
             if n in p}
    if kv is None:
        hd, hkv = cfg.head_dim, cfg.num_kv_heads
        h0, h1 = _rank_kv_heads(cfg, q.shape[-1] // hd,
                                tensor.model_group().rank)
        cols = [slice(h0 * hd, h1 * hd),
                slice((hkv + h0) * hd, (hkv + h1) * hd)]
        w = tensor.copy_to(p["wkv"]["w"])
        kv = tensor.copy_to(x) @ torch.cat([w[:, c] for c in cols],
                                           1).to(x.dtype)
        if "b" in p["wkv"]:
            b = tensor.copy_to(p["wkv"]["b"])
            kv = kv + torch.cat([b[c] for c in cols]).to(kv.dtype)
    return q, kv, norms


def _project_qkv(p, cfg: ModelConfig, x, positions):
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd); the fused ``wkv`` holds k in its
    first half and v in its second (on a rank's shard, its heads' k then
    their v).  Under a model axis, this rank's heads (module
    docstring)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    norms = p
    if _heads_sharded(p):
        q, kv, norms = _rank_qkv(p, cfg, x)
    else:
        q, kv = dense(p["wq"], x), dense(p["wkv"], x)
    q = q.reshape(B, S, -1, hd)
    k, v = torch.chunk(kv, 2, dim=-1)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(norms["qn"], q)
        k = rmsnorm(norms["kn"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _pad_weights(B: int, S: int, Lp: int, kv_weight, device):
    """(B, Lp) key weights: ``kv_weight`` (or ones) over the S tokens,
    0 on the pad."""
    w = torch.ones((B, Lp), dtype=torch.float32, device=device)
    if kv_weight is not None:
        w = w * torch.nn.functional.pad(kv_weight.to(torch.float32),
                                        (0, Lp - S))
    elif Lp > S:
        w[:, S:] = 0.0
    return w


def _local_attention(q, k, v, window: int, causal: bool, kv_weight):
    """Block-local sliding-window attention (the reference's
    ``_local_attention``): one band level of block size ``window``, query
    block I reading key blocks I - 1 and I.  q (B, L, Hq, D), k / v (B,
    L, Hkv, D) -> (B, L, Hq, D).  L pads to a multiple of the window with
    weight-0 keys; kv-heads fold into the batch and the GQA group into G,
    so K/V stay 3-D and are never copied per group."""
    B, L, _, D = q.shape
    Lp = -(-L // window) * window
    if Lp > L:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, Lp - L))
                   for a in (q, k, v))
    w = _pad_weights(B, L, Lp, kv_weight, q.device)
    qh, kh, vh, fold = fold_kv_heads(q, k, v)
    wr = w.repeat_interleave(fold[1], dim=0)
    # the reference scales q in its own dtype and hands the band math f32
    # v * w; its band math widens q and k to f32 itself, the kernels take
    # f32 operands, so q and k are widened here (exact).  The kernels also
    # take contiguous operands (a fold of one sequence can be a strided
    # view, which elementwise ops keep)
    f32 = torch.float32
    qs = (qh * (1.0 / math.sqrt(D))).to(f32)
    y, dn, _ = band_attention(qs.contiguous(), kh.to(f32).contiguous(),
                              (vh * wr[..., None]).to(f32).contiguous(), wr,
                              nr=window,
                              mode="l0_causal" if causal else "l0_bidir")
    z = (y / torch.clamp(dn, min=1e-9)[..., None]).to(q.dtype)
    return unfold_kv_heads(z, fold)[:, :L]


def _full_attention(q, k, v, causal: bool, kv_weight):
    """Full softmax attention over (B, S, H, hd) heads (the reference's
    ``dense_attention`` branch): kv-heads fold into the batch and the GQA
    group into G, so K/V stay 3-D and are never copied per group.
    Returns (B, S, Hq, hd) in q's dtype."""
    qh, kh, vh, fold = fold_kv_heads(q, k, v)
    if kv_weight is not None:
        kv_weight = kv_weight.repeat_interleave(fold[1], dim=0)
    z = dense_attention(qh, kh, vh, causal=causal, kv_weight=kv_weight)
    return unfold_kv_heads(z, fold)


def _out(p, z):
    """``wo`` over the heads' outputs (B, S, H, hd): row-parallel where
    this rank ran its own heads."""
    B, S = z.shape[:2]
    return tensor.row(p["wo"], z.reshape(B, S, -1), _heads_sharded(p))


def _attend(p, cfg: ModelConfig, q, k, v, kv_weight, causal: bool,
            layer_global: bool):
    """The layer's attention over projected (B,S,H,hd) heads and the
    output projection: the sliding window on a local layer, else full
    attention, or H1D attention with S padded to ``nr * 2**k`` by
    weight-0 keys."""
    B, S = q.shape[:2]
    if _is_local(cfg, layer_global):
        return _out(p, _local_attention(q, k, v, cfg.sliding_window, causal,
                                        kv_weight))
    if cfg.attention == "full":
        return _out(p, _full_attention(q, k, v, causal, kv_weight))
    Lp = hc.padded_length(S, cfg.nr)
    pad = Lp - S
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (q, k, v))
    w = _pad_weights(B, S, Lp, kv_weight, q.device)
    z = h1d_attention_mha(q, k, v, nr=cfg.nr, causal=causal,
                          causal_mode=cfg.causal_mode, kv_weight=w)[:, :S]
    return _out(p, z)


def attn_apply(p, cfg: ModelConfig, x, positions, *, causal=True,
               kv_weight=None, layer_global=True):
    """Training/encoding attention, causal (the LM, fine-q or coarse-q
    by ``cfg.causal_mode``) or bidirectional (the encoder), H1D or full
    by ``cfg.attention``; a sliding window where the config has one and
    ``layer_global`` is False.  x:
    (B, S, d); positions: (B, S); kv_weight: (B, S) key weights (0 =
    padding)."""
    _check_supported(cfg)
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _attend(p, cfg, q, k, v, kv_weight, causal, layer_global)


def init_decode_cache(cfg: ModelConfig, B: int, Lmax: int, *,
                      layer_global=True, dtype=torch.float32, device=None):
    """A zero decode cache: the hierarchical cache of an h1d layer, else
    the dense ``{"k", "v", "pos"}`` cache of ``Lmax`` rows (a local
    layer's rolling one of ``min(Lmax, 2 * window)``)."""
    _check_supported(cfg)
    local = _is_local(cfg, layer_global)
    if cfg.attention == "h1d" and not local:
        Lmax = hc.padded_length(Lmax, cfg.nr)   # needs nr * 2**k
        return h1d_decode.init_cache(B * cfg.num_kv_heads, Lmax,
                                     cfg.head_dim, cfg.head_dim, cfg.nr,
                                     dtype=dtype, device=device)
    Lc = min(Lmax, 2 * cfg.sliding_window) if local else Lmax
    shape = (B, Lc, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((B, Lc), -1, dtype=torch.int32,
                              device=device)}


def _dense_decode(cfg: ModelConfig, q, k, v, t, cache, local: bool):
    """One token of a full or local layer against its dense or rolling
    cache (the reference's shared jnp branch): write k, v and t at slot
    ``t % Lc`` in place, then attend every slot with ``0 <= t - pos``
    (and ``< window`` on a local layer)."""
    B = q.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Lc = cache["k"].shape[1]
    rows = torch.arange(B, device=q.device)
    slot = (t % Lc).long()
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    cache["pos"][rows, slot] = t.to(torch.int32)
    pos = cache["pos"]
    dist = t[:, None].to(torch.int32) - pos             # (B, Lc)
    valid = (pos >= 0) & (dist >= 0)
    if local:
        valid = valid & (dist < cfg.sliding_window)
    f32 = torch.float32
    s = torch.einsum("bhgd,blhd->bhgl",
                     q[:, 0].reshape(B, hkv, hq // hkv, hd).to(f32),
                     cache["k"].to(f32)) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, hc.NEG_INF)
    m = torch.clamp(s.amax(-1, keepdim=True), min=-1e30)
    a = torch.exp(s - m)
    z = torch.einsum("bhgl,blhd->bhgd", a, cache["v"].to(f32))
    z = z / torch.clamp(a.sum(-1), min=1e-9)[..., None]
    return z.to(q.dtype).reshape(B, 1, hq * hd)


def attn_decode(p, cfg: ModelConfig, x, t, cache, *, layer_global=True,
                page_tables=None, sp_tables=None):
    """Single-token decode.  x: (B, 1, d); t: (B,) int32 current position.
    Updates ``cache`` in place; returns (out (B, 1, d), cache).  A full
    layer decodes against its dense cache, a local layer
    (``layer_global=False`` under a sliding window) against its rolling
    cache.

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
    local = _is_local(cfg, layer_global)
    if local or cfg.attention == "full":
        z = _dense_decode(cfg, q, k, v, t, cache, local)
        return dense(p["wo"], z), cache
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


def prefill_into_cache(p, cfg: ModelConfig, x, positions, Lmax: int, *,
                       layer_global=True):
    """Run attention over a prefix (in ``cfg.causal_mode``) AND build the
    decode cache: fine-q hierarchical from the prefix's keys and values,
    or on a full or local layer the dense or rolling cache holding the
    prefix's last ``min(S, Lc)`` tokens.  Returns (out (B, S, d),
    cache)."""
    _check_supported(cfg)
    B, S, _ = x.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _attend(p, cfg, q, k, v, None, True, layer_global)
    if _is_local(cfg, layer_global) or cfg.attention == "full":
        cache = init_decode_cache(cfg, B, Lmax, layer_global=layer_global,
                                  dtype=k.dtype, device=k.device)
        Lc = cache["k"].shape[1]
        take = min(S, Lc)
        src = torch.arange(S - take, S, device=k.device)
        slots = src % Lc
        cache["k"][:, slots] = k[:, S - take:]
        cache["v"][:, slots] = v[:, S - take:]
        cache["pos"][:, slots] = src.to(torch.int32)
        return out, cache
    kf = k.permute(0, 2, 1, 3).reshape(B * hkv, S, hd)
    vf = v.permute(0, 2, 1, 3).reshape(B * hkv, S, hd)
    cache = h1d_decode.prefill_cache(kf, vf, hc.padded_length(Lmax, cfg.nr),
                                     cfg.nr)
    return out, cache
