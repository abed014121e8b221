"""Encoder-decoder transformer (the seamless-m4t backbone).

Port of ``repro.models.encdec``.  The audio front end is a stub, as in
the reference: the encoder takes precomputed frame embeddings (B, Se, d)
(:func:`stub_frames` draws seeded ones).  Encoder self-attention is
bidirectional H1D (the paper's encoder use case: ``l0_bidir`` and
``coarse_bidir`` on the band kernels), decoder self-attention causal
H1D, and cross-attention stays dense: ``core.ref_attention.
dense_attention`` in plain torch, as the reference computes it in jnp
outside any kernel, inside a ``torch.profiler`` range ``xattn``
(:data:`XATTN_RANGE`) so that the profilers file its time apart from
the band kernels'.

Parameters (projections (d_in, d_out), applied as ``x @ w``)::

    {"embed": {"w": (V, d)}, "lm_head": {"w": (d, V)},
     "enc_norm": {"g"}, "dec_norm": {"g"},
     "encoder": [{"ln1", "attn": {"wq", "wkv", "wo"}, "ln2",
                  "mlp": {"wg", "wu", "wd"}}, ...],
     "decoder": [{"ln1", "attn", "lnx", "xattn": {"wq", "wkv", "wo"},
                  "ln2", "mlp"}, ...]}

with the layers kept as Python lists, as the reference keeps them.  The
decode caches are a list with one ``{"self": H1DCache, "mem_k", "mem_v":
(B, Se, Hkv, hd)}`` per decoder layer, built by :func:`encdec_prefill`
(the encoder memory comes from the frames, so there is no empty cache
to start from).  With ``cfg.remat`` each encoder and decoder layer is
rematerialised in the backward (``transformer._remat``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..core import dense_attention
from ..parallel import tensor
from ..tree import tree_map
from .attention import attn_apply, attn_decode, attn_init, prefill_into_cache
from .common import (ModelConfig, dense, dense_init, embed_init, norm_init,
                     rmsnorm, twin)
from .ffn import mlp, mlp_init
from .transformer import _remat

#: the profiler range of the cross-attention (its projections and the
#: dense attention), a group of its own in ``launch/profile_serve.py``
XATTN_RANGE = "xattn"


def _xattn_init(gen: torch.Generator, cfg: ModelConfig, dtype, *,
                tp: Optional[int] = None):
    # the same projection structure
    return attn_init(gen, cfg, dtype, tp=tp)


def _xattn_apply(p, cfg: ModelConfig, x, mem_k, mem_v, *, mem_weight=None):
    """Cross attention, no RoPE.  x: (B, Sd, d); mem_k / mem_v: (B, Se,
    Hkv, hd); mem_weight: (B, Se) frame weights (0 = padding) or None.
    The GQA group runs as dense_attention's G axis, so k and v are never
    copied per group."""
    B, Sd, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = hq // hkv
    with record_function(XATTN_RANGE):
        q = dense(p["wq"], x).reshape(B, Sd, hkv, G, hd)
        qh = q.permute(0, 2, 3, 1, 4).reshape(B * hkv, G, Sd, hd)
        kh = mem_k.permute(0, 2, 1, 3).reshape(B * hkv, -1, hd)
        vh = mem_v.permute(0, 2, 1, 3).reshape(B * hkv, -1, hd)
        # row b * hkv + h of the folded heads is batch row b: each batch
        # row's weights repeat in place (jnp.repeat(axis=0))
        kw = (mem_weight.repeat_interleave(hkv, dim=0)
              if mem_weight is not None else None)
        z = dense_attention(qh, kh, vh, causal=False, kv_weight=kw)
        z = z.reshape(B, hkv, G, Sd, hd).permute(0, 3, 1, 2, 4)
        return dense(p["wo"], z.reshape(B, Sd, hq * hd))


def _xattn_memory(p, cfg: ModelConfig, enc_h):
    """The encoder output through one decoder layer's ``wkv``: (k, v),
    each (B, Se, Hkv, hd)."""
    B, Se, _ = enc_h.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    with record_function(XATTN_RANGE):
        k, v = torch.chunk(dense(p["wkv"], enc_h), 2, dim=-1)
        return k.reshape(B, Se, hkv, hd), v.reshape(B, Se, hkv, hd)


def encdec_init(cfg: ModelConfig, *, seed: int = 0, device=None,
                tp: Optional[int] = None, specs: bool = False):
    """Random parameters drawn as ``transformer.lm_init`` draws them: from
    ``seed`` on the CPU, in ``cfg.dtype``, each layer moved to ``device``
    (default ``cuda``) as it is drawn; on ``device="meta"`` only the
    shapes and dtypes.  ``specs=True`` returns ``(params, specs)`` for
    TP degree ``tp``, as ``lm_init``."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    d = cfg.d_model
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, Any] = {}
    spec: Dict[str, Any] = {}

    def layer(cross: bool):
        """One encoder (or, ``cross``, decoder) layer, on ``dev``."""
        parts = [("ln1", norm_init(d, dtype)),
                 ("attn", attn_init(gen, cfg, dtype, tp=tp))]
        if cross:
            parts += [("lnx", norm_init(d, dtype)),
                      ("xattn", _xattn_init(gen, cfg, dtype, tp=tp))]
        parts += [("ln2", norm_init(d, dtype)),
                  ("mlp", mlp_init(gen, d, cfg.d_ff, dtype, tp=tp))]
        return (tree_map(lambda t: t.to(dev), {n: p for n, (p, _) in parts}),
                {n: s for n, (_, s) in parts})

    with (torch.device("meta") if dev.type == "meta"
          else contextlib.nullcontext()):
        for name, (p, s) in (
                ("embed", embed_init(gen, cfg.vocab_size, d, dtype, tp=tp)),
                ("lm_head", dense_init(gen, d, cfg.vocab_size, scale=0.02,
                                       dtype=dtype, tp=tp)),
                ("enc_norm", norm_init(d, dtype)),
                ("dec_norm", norm_init(d, dtype))):
            params[name] = tree_map(lambda t: t.to(dev), p)
            spec[name] = s
        for name, n, cross in (("encoder", cfg.encoder_layers, False),
                               ("decoder", cfg.num_layers, True)):
            built = [layer(cross) for _ in range(n)]
            params[name] = [p for p, _ in built]
            spec[name] = [s for _, s in built]
    return twin(params, spec, specs)


def stub_frames(cfg: ModelConfig, B: int, Se: int, *, seed: int = 0,
                true_len=None):
    """Seeded stand-ins for the audio front end's output: (frames (B, Se,
    d) float32, standard normal from numpy's ``default_rng(seed)``,
    frame_weight (B, Se) float32: 1 up to each row's ``true_len``, 0 on
    the padding past it; all ones where ``true_len`` is None)."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)
    lens = np.full((B,), Se) if true_len is None else np.asarray(true_len)
    weight = (np.arange(Se)[None] < lens.reshape(B, 1)).astype(np.float32)
    return frames, weight


def _enc_block(lp, cfg: ModelConfig, h, positions, frame_weight):
    h = h + attn_apply(lp["attn"], cfg, rmsnorm(lp["ln1"], h), positions,
                       causal=False, kv_weight=frame_weight)
    return h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h), cfg.mlp_activation)


def encode(params, cfg: ModelConfig, frames, *, frame_weight=None):
    """frames (B, Se, d), the stubbed front end's embeddings -> the
    encoder output (B, Se, d) in the model's dtype.  Bidirectional H1D
    over RoPE positions ``0..Se-1``; ``frame_weight`` (B, Se), where
    given, weights the keys (0 = padding)."""
    B, Se, _ = frames.shape
    h = frames.to(cfg.torch_dtype)
    positions = torch.arange(Se, device=frames.device)[None].expand(B, Se)
    for lp in params["encoder"]:
        h = _remat(cfg, _enc_block)(lp, cfg, h, positions, frame_weight)
    return rmsnorm(params["enc_norm"], h)


def _dec_block(lp, cfg: ModelConfig, h, positions, enc_h, enc_weight):
    h = h + attn_apply(lp["attn"], cfg, rmsnorm(lp["ln1"], h), positions,
                       causal=True)
    mk, mv = _xattn_memory(lp["xattn"], cfg, enc_h)
    h = h + _xattn_apply(lp["xattn"], cfg, rmsnorm(lp["lnx"], h), mk, mv,
                         mem_weight=enc_weight)
    return h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h), cfg.mlp_activation)


def _logits(params, h):
    return dense(params["lm_head"], rmsnorm(params["dec_norm"], h)).to(
        torch.float32)


def decode_train(params, cfg: ModelConfig, tokens, enc_h, *,
                 enc_weight=None):
    """Teacher-forced decoder: tokens (B, Sd), the encoder output enc_h
    (B, Se, d) -> logits (B, Sd, V) in float32.  ``enc_weight`` (B, Se)
    masks the padded frames out of the cross-attention."""
    B, Sd = tokens.shape
    h = params["embed"]["w"][tokens].to(cfg.torch_dtype)
    positions = torch.arange(Sd, device=tokens.device)[None].expand(B, Sd)
    for lp in params["decoder"]:
        h = _remat(cfg, _dec_block)(lp, cfg, h, positions, enc_h, enc_weight)
    return _logits(params, h)


def encdec_forward(params, cfg: ModelConfig, batch):
    """batch: frames (B, Se, d), tokens (B, Sd) [+ frame_weight (B, Se)]
    -> (teacher-forced logits (B, Sd, V), aux 0.0)."""
    fw = batch.get("frame_weight")
    enc_h = encode(params, cfg, batch["frames"], frame_weight=fw)
    return decode_train(params, cfg, batch["tokens"], enc_h,
                        enc_weight=fw), 0.0


def encdec_loss(params, cfg: ModelConfig, batch):
    """Next-token cross entropy over every target position (the
    reference's: no loss mask), through ``logsumexp``; returns (nll,
    {"nll"}).  Over a data axis of D ranks (``parallel.tensor``) a
    rank's loss is its rows' mean over D, its part of the whole batch's
    mean (every rank holds as many rows), and ``nll`` the whole batch's."""
    logits, _ = encdec_forward(params, cfg, batch)
    tokens = batch["tokens"]
    lgt = logits[:, :-1]
    gold = torch.gather(lgt, -1, tokens[:, 1:].long()[..., None])[..., 0]
    nll = (torch.logsumexp(lgt, dim=-1) - gold).mean()
    D = tensor.data_size()
    if D == 1:
        return nll, {"nll": nll}
    nll = nll / D
    return nll, {"nll": tensor.data_sum(nll)}


@torch.inference_mode()
def encdec_prefill(params, cfg: ModelConfig, frames, tokens, Lmax: int):
    """Encode, then run the decoder over the target prefix ``tokens`` (B,
    Sd), building each layer's hierarchical self cache (``Lmax`` rows)
    and its encoder memory.  As in the reference the frames are encoded
    and cross-attended with no frame weights, so every row of a batch
    holds frames of one length.  Returns (last logits (B, V) float32,
    caches, next_pos (B,) int32 = Sd)."""
    enc_h = encode(params, cfg, frames)
    B, Sd = tokens.shape
    h = params["embed"]["w"][tokens].to(cfg.torch_dtype)
    positions = torch.arange(Sd, device=tokens.device)[None].expand(B, Sd)
    caches: List[Dict[str, Any]] = []
    for lp in params["decoder"]:
        a, cache = prefill_into_cache(lp["attn"], cfg,
                                      rmsnorm(lp["ln1"], h), positions, Lmax)
        h = h + a
        mk, mv = _xattn_memory(lp["xattn"], cfg, enc_h)
        h = h + _xattn_apply(lp["xattn"], cfg, rmsnorm(lp["lnx"], h), mk, mv)
        h = h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h), cfg.mlp_activation)
        caches.append({"self": cache, "mem_k": mk, "mem_v": mv})
    logits = _logits(params, h[:, -1:])[:, 0]
    return logits, caches, torch.full((B,), Sd, dtype=torch.int32,
                                      device=tokens.device)


@torch.inference_mode()
def encdec_decode_step(params, cfg: ModelConfig, caches, token, t):
    """One decoder token: token (B,) int, t (B,) int32 positions.  Each
    layer's self cache is updated in place; returns (logits (B, V)
    float32, the caches)."""
    h = params["embed"]["w"][token[:, None]].to(cfg.torch_dtype)
    out = []
    for lp, cache in zip(params["decoder"], caches):
        a, self_cache = attn_decode(lp["attn"], cfg, rmsnorm(lp["ln1"], h),
                                    t, cache["self"])
        h = h + a
        h = h + _xattn_apply(lp["xattn"], cfg, rmsnorm(lp["lnx"], h),
                             cache["mem_k"], cache["mem_v"])
        h = h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h), cfg.mlp_activation)
        out.append({"self": self_cache, "mem_k": cache["mem_k"],
                    "mem_v": cache["mem_v"]})
    return _logits(params, h)[:, 0], out
