"""Decoder-only LM (families ``dense``, ``moe``, ``vlm``, ``ssm`` and
``hybrid``): forward, training loss, prefill and single-token decode.

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
the tokens in the forward and the prefill.  Every layer of an ``ssm``
(mamba2) or ``hybrid`` (zamba2) stack is an ``ssm`` block, a Mamba2
mixer (``models/ssm.py``) behind an RMSNorm, whose decode cache is an
``SSMState``; a hybrid also holds one ``shared`` dense attention block,
run after every layer ``i`` with ``cfg.layer_is_attn(i)`` on
``shared_proj[inv](cat[h, e0])`` (``e0`` the embeddings, ``inv`` the
invocation), its output added as ``h + (h2 - xin)``.  The shared block
runs outside the per-layer remat, as in the reference, and its weights
take gradient from every invocation; its hierarchical cache follows the
SSM state of the layer it runs after in the cache list.  The
encoder-decoder family is ``models/encdec.py``'s; these functions refuse
it.

Parameters (all (d_in, d_out) projections applied as ``x @ w``)::

    {"embed": {"w": (V, d)}, "final_norm": {"g": (d,)},
     ["lm_head": {"w": (d, V)}]        # only without tied embeddings
     "layers": [{"ln1": {"g"}, "attn": {"wq", "wkv", "wo"},
                 "ln2": {"g"}, "mlp": {"wg", "wu", "wd"}}, ...]}

with ``"moe": {"router", "w1", "w3", "w2", ["shared", "shared_gate"],
["residual"]}`` in place of ``"mlp"`` in a ``moe`` layer; an ``ssm``
layer is ``{"ln": {"g"}, "mixer": {"in_proj", "out_proj", "conv_w",
"conv_b", "A_log", "D", "dt_bias", "norm"}}``, and a hybrid adds
``"shared"`` (a dense layer) and ``"shared_proj": [{"w": (2d, d)}, ...]``,
one per invocation.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..parallel import tensor
from ..tree import tree_map
from .attention import (attn_init, attn_apply, attn_decode,
                        init_decode_cache, prefill_into_cache)
from .common import (ModelConfig, dense, dense_init, embed_init, norm_init,
                     rmsnorm, twin)
from .ffn import mlp_init, mlp, moe_init, moe_apply
from .ssm import (SSMState, mamba2_apply, mamba2_decode, mamba2_dims,
                  mamba2_init)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "family='encdec' is not a decoder-only stack: its init, loss, "
            "prefill and decode are models/encdec.py's (get_model)")


def block_kind(cfg: ModelConfig, i: int) -> str:
    """The reference's ``block_kind``: ``ssm`` for every layer of an ssm
    or hybrid stack (a hybrid's attention is the shared block, run
    besides), ``moe`` for a config with experts, else ``dense``."""
    if cfg.family in ("ssm", "hybrid"):
        return "ssm"
    return "moe" if cfg.moe_experts > 0 else "dense"


def block_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               kind: str = "dense", *, tp: Optional[int] = None):
    """One layer of ``kind`` (``dense``, ``moe`` or ``ssm``) and its specs,
    the reference's stacked layer spec without the leading layer axis."""
    d = cfg.d_model
    p, s = {}, {}
    if kind == "ssm":
        p["ln"], s["ln"] = norm_init(d, dtype)
        p["mixer"], s["mixer"] = mamba2_init(gen, cfg, dtype, tp=tp)
        return p, s
    p["ln1"], s["ln1"] = norm_init(d, dtype)
    p["attn"], s["attn"] = attn_init(gen, cfg, dtype, tp=tp)
    p["ln2"], s["ln2"] = norm_init(d, dtype)
    if kind == "moe":
        p["moe"], s["moe"] = moe_init(gen, cfg, dtype, tp=tp)
    else:
        p["mlp"], s["mlp"] = mlp_init(gen, d, cfg.d_ff, dtype, tp=tp)
    return p, s


def _ffn(lp, cfg: ModelConfig, x):
    """The layer's feed-forward on ``x``: (out, aux), aux 0.0 for a dense
    layer."""
    if "moe" in lp:
        return moe_apply(lp["moe"], cfg, x, cfg.mlp_activation)
    return mlp(lp["mlp"], x, cfg.mlp_activation), 0.0


def lm_init(cfg: ModelConfig, *, seed: int = 0, device=None,
            tp: Optional[int] = None, specs: bool = False):
    """Random parameters drawn from ``seed`` on the CPU, each layer moved
    to ``device`` (default ``cuda``) as it is drawn: one seed gives the
    same weights on every device, and a model of billions of parameters
    never sits whole in host memory.  Every leaf is drawn in
    ``cfg.dtype`` (float32 or bfloat16), as the reference draws them,
    but a MoE router and a Mamba2 mixer's ``A_log``, ``D`` and
    ``dt_bias``, which are always float32.  On ``device="meta"``
    nothing is drawn: the tree holds every leaf's shape and dtype.

    ``specs=True`` returns ``(params, specs)``: the reference's spec
    tree for TP degree ``tp`` (``None``: nothing sharded), its scanned
    layer stack a list of per-layer specs here, as the layers are."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator().manual_seed(seed)
    d = cfg.d_model
    params: Dict[str, Any] = {}
    spec: Dict[str, Any] = {}

    def put(name, built):
        p, s = built
        params[name], spec[name] = _to(p, dev), s

    with (torch.device("meta") if dev.type == "meta"
          else contextlib.nullcontext()):
        put("embed", embed_init(gen, cfg.vocab_size, d, dtype, tp=tp))
        put("final_norm", norm_init(d, dtype))
        params["layers"], spec["layers"] = [], []
        for i in range(cfg.num_layers):        # each moved as it is drawn
            p, s = block_init(gen, cfg, dtype, block_kind(cfg, i), tp=tp)
            params["layers"].append(_to(p, dev))
            spec["layers"].append(s)
        if not cfg.tie_embeddings:
            put("lm_head", dense_init(gen, d, cfg.vocab_size, scale=0.02,
                                      dtype=dtype, tp=tp))
        if cfg.family == "hybrid":
            put("shared", block_init(gen, cfg, dtype, "dense", tp=tp))
            params["shared_proj"], spec["shared_proj"] = [], []
            for i in range(cfg.num_layers):
                if cfg.layer_is_attn(i):       # one per invocation
                    p, s = dense_init(gen, 2 * d, d, dtype=dtype, tp=tp)
                    params["shared_proj"].append(_to(p, dev))
                    spec["shared_proj"].append(s)
    return twin(params, spec, specs)


def _to(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def _embed_tokens(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Token embeddings (B, S, d) in the model's dtype, after
    ``prefix_embeds`` (B, P, d) where given; over a vocabulary split by
    a model axis each rank looks up its rows and the ranks' rows are
    summed (``parallel.tensor.embed``)."""
    h = tensor.embed(params["embed"]["w"], tokens).to(cfg.torch_dtype)
    if prefix_embeds is None:
        return h
    return torch.cat([prefix_embeds.to(h.dtype), h], dim=1)


def _logits(params, cfg: ModelConfig, h):
    # the reference's grad_dtype_boundary (a cast of the cotangent to h's
    # dtype) needs no port: autograd already hands a bf16 h a bf16
    # cotangent
    # under a model axis the logits of this rank's vocabulary rows (tied)
    # or columns (lm_head) only
    h = rmsnorm(params["final_norm"], h)
    if cfg.tie_embeddings:
        w = params["embed"]["w"]
        if tensor.sharded(w, 0):
            h = tensor.copy_to(h)
        logits = h @ w.to(h.dtype).T
    else:
        logits, = tensor.column(h, params["lm_head"])
    return logits.to(torch.float32)


def _block_apply(lp, cfg: ModelConfig, h, positions, layer_global: bool):
    """One layer: (h, aux)."""
    if "mixer" in lp:
        return h + mamba2_apply(lp["mixer"], cfg, rmsnorm(lp["ln"], h)), 0.0
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


def _shared_input(params, inv: int, h, e0):
    """The hybrid's shared block input of invocation ``inv``."""
    return dense(params["shared_proj"][inv], torch.cat([h, e0], dim=-1))


def lm_forward(params, cfg: ModelConfig, tokens, *, prefix_embeds=None):
    """Teacher-forced causal forward.  tokens (B, S) [after prefix_embeds
    (B, P, d), positions running over both] -> (logits (B, S, V) of the
    token positions only, aux_loss): the layers' MoE losses summed, 0.0
    for a dense stack.  Each layer runs through :func:`_remat`; a
    hybrid's shared block runs after its layers, outside the remat."""
    _check_family(cfg)
    h = _embed_tokens(params, cfg, tokens, prefix_embeds)
    e0 = h
    B, L = h.shape[:2]
    positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
    aux_total = 0.0
    inv = 0
    for i, lp in enumerate(params["layers"]):
        h, aux = _remat(cfg, _block_apply)(lp, cfg, h, positions,
                                           cfg.layer_uses_global_attn(i))
        aux_total = aux_total + aux
        if cfg.family == "hybrid" and cfg.layer_is_attn(i):
            xin = _shared_input(params, inv, h, e0)
            h2, _ = _block_apply(params["shared"], cfg, xin, positions, True)
            h = h + (h2 - xin)        # the residual of the shared block only
            inv += 1
    logits = _logits(params, cfg, h)
    return logits[:, L - tokens.shape[1]:], aux_total


def lm_loss(params, cfg: ModelConfig, batch):
    """batch: tokens (B, S) [+ patch_embeds (B, P, d), loss_mask (B, S)].
    Next-token cross entropy of the token positions through
    ``logsumexp``, plus the MoE aux loss; returns (loss, {"nll", "aux",
    "ntok"}).  Over a vocabulary split by a model axis the cross entropy
    runs on each rank's logits (``parallel.tensor.sharded_xent``); over a
    data axis the loss divides by the tokens of every data rank, so it is
    this rank's part of the whole batch's mean (the data ranks' parts sum
    to it, and so do their gradients, the MoE aux's too: ``ffn.assign``),
    and ``nll``, ``aux`` and ``ntok`` are the whole batch's."""
    tokens = batch["tokens"]
    logits, aux = lm_forward(params, cfg, tokens,
                             prefix_embeds=batch.get("patch_embeds"))
    tgt = tokens[:, 1:].long()
    lgt = logits[:, :-1]
    mask = batch.get("loss_mask")
    mask = (torch.ones(tgt.shape, dtype=torch.float32, device=lgt.device)
            if mask is None else mask[:, 1:].to(torch.float32))
    head = params["embed" if cfg.tie_embeddings else "lm_head"]["w"]
    vocab = tensor.vocab_range(head, 0 if cfg.tie_embeddings else 1)
    if vocab is None:
        logz = torch.logsumexp(lgt, dim=-1)
        gold = torch.gather(lgt, -1, tgt[..., None])[..., 0]
        nll = (logz - gold) * mask
    else:
        nll = tensor.sharded_xent(lgt, tgt, vocab[0]) * mask
    ntok = tensor.data_sum(mask.sum())
    denom = torch.clamp(ntok, min=1.0)
    loss = nll.sum() / denom + aux
    if isinstance(aux, torch.Tensor):
        aux = tensor.data_sum(aux)
    return loss, {"nll": tensor.data_sum(nll.sum()) / denom, "aux": aux,
                  "ntok": ntok}


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
    each of its cache rows is overwritten before its position comes up;
    an SSM layer's state runs over the whole of ``tokens`` (the engine
    does not pad these families).  A MoE layer's aux loss is dropped."""
    _check_family(cfg)
    dev = tokens.device
    h = _embed_tokens(params, cfg, tokens, prefix_embeds)
    e0 = h
    B, L = h.shape[:2]
    positions = torch.arange(L, device=dev)[None].expand(B, L)
    caches: List = []
    inv = 0
    for i, lp in enumerate(params["layers"]):
        h, cache = _block_prefill(lp, cfg, h, positions, Lmax,
                                  cfg.layer_uses_global_attn(i))
        caches.append(cache)
        if cfg.family == "hybrid" and cfg.layer_is_attn(i):
            xin = _shared_input(params, inv, h, e0)
            h2, cache = _block_prefill(params["shared"], cfg, xin, positions,
                                       Lmax, True)
            h = h + (h2 - xin)
            caches.append(cache)
            inv += 1
    if true_len is None:
        tl = torch.full((B,), L, dtype=torch.int32, device=dev)
    else:
        tl = (torch.as_tensor(true_len, dtype=torch.int32, device=dev)
              + (L - tokens.shape[1])).expand(B).contiguous()
    # per-row logical lengths: gather each row's last true token
    last = h[torch.arange(B, device=dev), tl.long() - 1][:, None]
    return _logits(params, cfg, last)[:, 0], caches, tl


def _block_prefill(lp, cfg: ModelConfig, h, positions, Lmax: int,
                   layer_global: bool):
    """One layer over the prompt: (h, its decode cache)."""
    if "mixer" in lp:
        out, state = mamba2_apply(lp["mixer"], cfg, rmsnorm(lp["ln"], h),
                                  return_state=True)
        return h + out, state
    a, cache = prefill_into_cache(lp["attn"], cfg, rmsnorm(lp["ln1"], h),
                                  positions, Lmax, layer_global=layer_global)
    h = h + a
    return h + _ffn(lp, cfg, rmsnorm(lp["ln2"], h))[0], cache


def _block_decode(lp, cfg: ModelConfig, h, t, cache, layer_global: bool,
                  page_tables, sp_tables):
    """One layer on one token: (h, its updated cache)."""
    if "mixer" in lp:
        out, state = mamba2_decode(lp["mixer"], cfg, rmsnorm(lp["ln"], h),
                                   cache)
        return h + out, state
    a, cache = attn_decode(lp["attn"], cfg, rmsnorm(lp["ln1"], h), t, cache,
                           layer_global=layer_global,
                           page_tables=page_tables, sp_tables=sp_tables)
    h = h + a
    return h + _ffn(lp, cfg, rmsnorm(lp["ln2"], h))[0], cache


@torch.inference_mode()
def lm_decode_step(params, cfg: ModelConfig, caches, token, t, *,
                   page_tables=None, sp_tables=None):
    """One decode step.  token (B,) int, t (B,) int32 positions.  Updates
    each attention layer's cache in place and puts each SSM layer's new
    state in its place in the list; returns (logits (B, V), caches).

    ``page_tables`` (``core.h1d_decode.PageTables``) switches the layers
    onto the paged pools (``caches`` then holds one pool per layer);
    every layer writes the same positions, so one table pair serves the
    whole stack.  ``sp_tables`` (``parallel.sp_attention.SPTables``) is
    the same for sequence-sharded caches, decoded inside ``sp_scope``."""
    h = _embed_tokens(params, cfg, token[:, None])
    e0 = h
    ci = inv = 0
    for i, lp in enumerate(params["layers"]):
        h, caches[ci] = _block_decode(
            lp, cfg, h, t, caches[ci], cfg.layer_uses_global_attn(i),
            page_tables, sp_tables)
        ci += 1
        if cfg.family == "hybrid" and cfg.layer_is_attn(i):
            xin = _shared_input(params, inv, h, e0)
            h2, caches[ci] = _block_decode(params["shared"], cfg, xin, t,
                                           caches[ci], True, page_tables,
                                           sp_tables)
            h = h + (h2 - xin)
            ci += 1
            inv += 1
    return _logits(params, cfg, h)[:, 0], caches


def lm_init_decode_caches(params, cfg: ModelConfig, B: int, Lmax: int):
    """Fresh (zero) decode caches, one per layer (a hybrid's shared block
    adds one after each layer it runs after), on the parameters'
    device."""
    _check_family(cfg)
    dev = params["embed"]["w"].device
    caches: List = []
    for i in range(cfg.num_layers):
        if block_kind(cfg, i) == "ssm":
            _, H, _, N, conv_dim = mamba2_dims(cfg)
            caches.append(SSMState(
                torch.zeros((B, H, N, cfg.ssm_head_dim), dtype=torch.float32,
                            device=dev),
                torch.zeros((B, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=cfg.torch_dtype, device=dev)))
        else:
            caches.append(init_decode_cache(
                cfg, B, Lmax, layer_global=cfg.layer_uses_global_attn(i),
                dtype=cfg.torch_dtype, device=dev))
        if cfg.family == "hybrid" and cfg.layer_is_attn(i):
            caches.append(init_decode_cache(cfg, B, Lmax,
                                            dtype=cfg.torch_dtype,
                                            device=dev))
    return caches
