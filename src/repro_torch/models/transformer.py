"""Decoder-only transformer LM (families ``dense``, ``moe`` and ``vlm``):
forward, training loss, prefill and single-token decode.

Port of ``repro.models.transformer`` for the paper LM.  The JAX stack
scans over layer-stacked parameters; here ``params["layers"]`` is a list
with one dictionary per layer and the decode caches are a per-layer list,
so the engine's slot axis of a cache array is axis 0 (axis 1 in the
scanned JAX layout).  Under a sliding window (gemma3) layer ``i`` is
local unless ``cfg.layer_uses_global_attn(i)``; a local layer's cache is
its rolling ``{"k", "v", "pos"}`` dictionary, a global layer's the
hierarchical cache.  ``lm_forward`` and ``lm_loss`` are differentiable
(the band kernels carry their backward); with ``cfg.remat`` each layer
is rematerialised in the backward (:func:`_remat`, the reference's
``jax.checkpoint`` per layer).  Prefill and decode run under
``torch.inference_mode()``.  A ``moe`` layer (:func:`block_kind`) holds
``moe`` in place of ``mlp`` and adds its load-balancing loss to the
forward's aux; ``prefix_embeds`` (a VLM's patch embeddings) run before
the tokens in the forward and the prefill.  The SSM, hybrid and
encoder-decoder families are later slices.

Parameters (all (d_in, d_out) projections applied as ``x @ w``)::

    {"embed": {"w": (V, d)}, "final_norm": {"g": (d,)},
     ["lm_head": {"w": (d, V)}]        # only without tied embeddings
     "layers": [{"ln1": {"g"}, "attn": {"wq", "wkv", "wo"},
                 "ln2": {"g"}, "mlp": {"wg", "wu", "wd"}}, ...]}

with ``"moe": {"router", "w1", "w3", "w2", ["shared", "shared_gate"],
["residual"]}`` in place of ``"mlp"`` in a ``moe`` layer.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..tree import tree_map
from .attention import (attn_init, attn_apply, attn_decode,
                        init_decode_cache, prefill_into_cache)
from .common import ModelConfig, dense, dense_init, rmsnorm
from .ffn import mlp_init, mlp, moe_init, moe_apply


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet: the port runs the "
            "dense, moe and vlm decoders; mamba2 (ssm), zamba2 (hybrid) "
            "and the encoder-decoder come later")


def block_kind(cfg: ModelConfig, i: int) -> str:
    """``moe`` for every layer of a config with experts, else ``dense``
    (the reference's ``block_kind`` for the ported families)."""
    return "moe" if cfg.moe_experts > 0 else "dense"


def block_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               kind: str = "dense"):
    p = {"ln1": {"g": torch.ones((cfg.d_model,), dtype=dtype)},
         "attn": attn_init(gen, cfg, dtype),
         "ln2": {"g": torch.ones((cfg.d_model,), dtype=dtype)}}
    if kind == "moe":
        p["moe"] = moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _ffn(lp, cfg: ModelConfig, x):
    """The layer's feed-forward on ``x``: (out, aux), aux 0.0 for a dense
    layer."""
    if "moe" in lp:
        return moe_apply(lp["moe"], cfg, x, cfg.mlp_activation)
    return mlp(lp["mlp"], x, cfg.mlp_activation), 0.0


def lm_init(cfg: ModelConfig, *, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``seed`` on the CPU, each layer moved
    to ``device`` (default ``cuda``) as it is drawn: one seed gives the
    same weights on every device, and a model of billions of parameters
    never sits whole in host memory.  Every leaf is drawn in
    ``cfg.dtype`` (float32 or bfloat16), as the reference draws them,
    but a MoE router, which is always float32.  On ``device="meta"``
    nothing is drawn: the tree holds every leaf's shape and dtype."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator().manual_seed(seed)

    def to_dev(tree):
        return tree_map(lambda t: t.to(dev), tree)
    with (torch.device("meta") if dev.type == "meta"
          else contextlib.nullcontext()):
        params: Dict[str, Any] = {
            "embed": to_dev({"w": torch.randn((cfg.vocab_size, cfg.d_model),
                                              generator=gen, dtype=dtype)
                             * 0.02}),
            "final_norm": to_dev({"g": torch.ones((cfg.d_model,),
                                                  dtype=dtype)}),
            "layers": [to_dev(block_init(gen, cfg, dtype, block_kind(cfg, i)))
                       for i in range(cfg.num_layers)],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = to_dev(dense_init(gen, cfg.d_model,
                                                  cfg.vocab_size, scale=0.02,
                                                  dtype=dtype))
    return params


def _embed_tokens(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Token embeddings (B, S, d) in the model's dtype, after
    ``prefix_embeds`` (B, P, d) where given."""
    h = params["embed"]["w"][tokens].to(cfg.torch_dtype)
    if prefix_embeds is None:
        return h
    return torch.cat([prefix_embeds.to(h.dtype), h], dim=1)


def _logits(params, cfg: ModelConfig, h):
    # the reference's grad_dtype_boundary (a cast of the cotangent to h's
    # dtype) needs no port: autograd already hands a bf16 h a bf16
    # cotangent
    h = rmsnorm(params["final_norm"], h)
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["w"].to(h.dtype).T
    else:
        logits = dense(params["lm_head"], h)
    return logits.to(torch.float32)


def _block_apply(lp, cfg: ModelConfig, h, positions, layer_global: bool):
    """One layer: (h, aux)."""
    h = h + attn_apply(lp["attn"], cfg, rmsnorm(lp["ln1"], h), positions,
                       layer_global=layer_global)
    m, aux = _ffn(lp, cfg, rmsnorm(lp["ln2"], h))
    return h + m, aux


#: the weight products (a 2-D weight applied as ``x @ w`` runs as one mm
#: on the flattened rows): JAX's ``dots_with_no_batch_dims_saveable``
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` rematerialised in the backward (the reference's ``_remat``):
    ``remat_policy='dots'`` keeps the outputs of the weight products and
    recomputes the rest, ``'none'`` (or ``remat=False``) keeps every
    activation, any other policy recomputes everything.  A recompute runs
    the layer's kernels again on the same inputs, so it gives the
    forward's bits."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_weight_products)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def lm_forward(params, cfg: ModelConfig, tokens, *, prefix_embeds=None):
    """Teacher-forced causal forward.  tokens (B, S) [after prefix_embeds
    (B, P, d), positions running over both] -> (logits (B, S, V) of the
    token positions only, aux_loss): the layers' MoE losses summed, 0.0
    for a dense stack.  Each layer runs through :func:`_remat`."""
    _check_family(cfg)
    h = _embed_tokens(params, cfg, tokens, prefix_embeds)
    B, L = h.shape[:2]
    positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
    aux_total = 0.0
    for i, lp in enumerate(params["layers"]):
        h, aux = _remat(cfg, _block_apply)(lp, cfg, h, positions,
                                           cfg.layer_uses_global_attn(i))
        aux_total = aux_total + aux
    logits = _logits(params, cfg, h)
    return logits[:, L - tokens.shape[1]:], aux_total


def lm_loss(params, cfg: ModelConfig, batch):
    """batch: tokens (B, S) [+ patch_embeds (B, P, d), loss_mask (B, S)].
    Next-token cross entropy of the token positions through
    ``logsumexp``, plus the MoE aux loss; returns (loss, {"nll", "aux",
    "ntok"})."""
    tokens = batch["tokens"]
    logits, aux = lm_forward(params, cfg, tokens,
                             prefix_embeds=batch.get("patch_embeds"))
    tgt = tokens[:, 1:].long()
    lgt = logits[:, :-1]
    mask = batch.get("loss_mask")
    mask = (torch.ones(tgt.shape, dtype=torch.float32, device=lgt.device)
            if mask is None else mask[:, 1:].to(torch.float32))
    logz = torch.logsumexp(lgt, dim=-1)
    gold = torch.gather(lgt, -1, tgt[..., None])[..., 0]
    nll = (logz - gold) * mask
    ntok = mask.sum()
    denom = torch.clamp(ntok, min=1.0)
    loss = nll.sum() / denom + aux
    return loss, {"nll": nll.sum() / denom, "aux": aux, "ntok": ntok}


@torch.inference_mode()
def lm_prefill(params, cfg: ModelConfig, tokens, Lmax: int, *,
               prefix_embeds=None, true_len=None):
    """Teacher-forced pass over the prompt (after ``prefix_embeds`` (B, P,
    d), where given) that also builds the decode caches.  Returns
    (last_logits (B, V), caches (list per layer), next_pos (B,) int32).

    ``true_len`` (int, or a per-row (B,) tensor): logical prompt lengths
    when ``tokens`` is right-padded to a length bucket; logits and
    next_pos then refer to position ``P + true_len - 1`` of each row.
    The padded tail is never attended by decode (causal attention) and
    each of its cache rows is overwritten before its position comes up.
    A MoE layer's aux loss is dropped."""
    _check_family(cfg)
    dev = tokens.device
    h = _embed_tokens(params, cfg, tokens, prefix_embeds)
    B, L = h.shape[:2]
    positions = torch.arange(L, device=dev)[None].expand(B, L)
    caches: List = []
    for i, lp in enumerate(params["layers"]):
        a, cache = prefill_into_cache(
            lp["attn"], cfg, rmsnorm(lp["ln1"], h), positions, Lmax,
            layer_global=cfg.layer_uses_global_attn(i))
        h = h + a
        h = h + _ffn(lp, cfg, rmsnorm(lp["ln2"], h))[0]
        caches.append(cache)
    if true_len is None:
        tl = torch.full((B,), L, dtype=torch.int32, device=dev)
    else:
        tl = (torch.as_tensor(true_len, dtype=torch.int32, device=dev)
              + (L - tokens.shape[1])).expand(B).contiguous()
    # per-row logical lengths: gather each row's last true token
    last = h[torch.arange(B, device=dev), tl.long() - 1][:, None]
    return _logits(params, cfg, last)[:, 0], caches, tl


@torch.inference_mode()
def lm_decode_step(params, cfg: ModelConfig, caches, token, t, *,
                   page_tables=None, sp_tables=None):
    """One decode step.  token (B,) int, t (B,) int32 positions.  Updates
    each layer's cache in place; returns (logits (B, V), caches).

    ``page_tables`` (``core.h1d_decode.PageTables``) switches the layers
    onto the paged pools (``caches`` then holds one pool per layer);
    every layer writes the same positions, so one table pair serves the
    whole stack.  ``sp_tables`` (``parallel.sp_attention.SPTables``) is
    the same for sequence-sharded caches, decoded inside ``sp_scope``."""
    h = _embed_tokens(params, cfg, token[:, None])
    for i, lp in enumerate(params["layers"]):
        a, caches[i] = attn_decode(
            lp["attn"], cfg, rmsnorm(lp["ln1"], h), t, caches[i],
            layer_global=cfg.layer_uses_global_attn(i),
            page_tables=page_tables, sp_tables=sp_tables)
        h = h + a
        h = h + _ffn(lp, cfg, rmsnorm(lp["ln2"], h))[0]
    return _logits(params, cfg, h)[:, 0], caches


def lm_init_decode_caches(params, cfg: ModelConfig, B: int, Lmax: int):
    """Fresh (zero) decode caches, one per layer, on the parameters'
    device."""
    _check_family(cfg)
    dev = params["embed"]["w"].device
    return [init_decode_cache(cfg, B, Lmax,
                              layer_global=cfg.layer_uses_global_attn(i),
                              dtype=cfg.torch_dtype, device=dev)
            for i in range(cfg.num_layers)]
