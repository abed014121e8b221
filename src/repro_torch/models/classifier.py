"""Encoder classifier for LRA-style tasks (paper section 8.1).

Port of ``repro.models.classifier``: a bidirectional H1D (or full, or
sliding-window) encoder (embedding, pre-norm blocks with RoPE positions,
final RMSNorm), masked mean pooling over the true tokens and a linear
``head`` to ``num_classes`` -- the configuration the paper uses on the
Long Range Arena benchmark (``h1d-lra-encoder``).  Differentiable: the band kernels
of the bidirectional and coarse modes carry their backward.

Parameters::

    {"embed": {"w": (V, d)}, "final_norm": {"g": (d,)},
     "head": {"w": (d, num_classes)},
     "layers": [{"ln1": {"g"}, "attn": {"wq", "wkv", "wo"},
                 "ln2": {"g"}, "mlp": {"wg", "wu", "wd"}}, ...]}
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..tree import tree_map
from .attention import attn_apply
from .common import (ModelConfig, dense, dense_init, embed_init, norm_init,
                     rmsnorm, twin)
from .ffn import mlp
from .transformer import block_init


def classifier_init(cfg: ModelConfig, num_classes: int, *, seed: int = 0,
                    device=None, tp: Optional[int] = None,
                    specs: bool = False):
    """Random parameters drawn from ``seed`` with an explicit
    ``torch.Generator`` on the CPU, then moved to ``device`` (default
    ``cuda``), as ``lm_init``; ``specs=True`` returns ``(params,
    specs)`` for TP degree ``tp`` (the head replicated)."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator().manual_seed(seed)
    d = cfg.d_model
    params: Dict[str, Any] = {}
    spec: Dict[str, Any] = {}
    params["embed"], spec["embed"] = embed_init(gen, cfg.vocab_size, d,
                                                dtype, tp=tp)
    layers = [block_init(gen, cfg, dtype, tp=tp)
              for _ in range(cfg.num_layers)]
    params["layers"] = [p for p, _ in layers]
    spec["layers"] = [s for _, s in layers]
    params["final_norm"], spec["final_norm"] = norm_init(d, dtype)
    params["head"], spec["head"] = dense_init(
        gen, d, num_classes, dtype=dtype, out_shard=False, tp=tp)
    return twin(tree_map(lambda t: t.to(dev), params), spec, specs)


def classifier_logits(params, cfg: ModelConfig, tokens, mask=None):
    """tokens (B, S) int, mask (B, S) 0/1 or None -> float32 logits
    (B, num_classes).  The mask weights the keys of every layer and the
    mean pooling.  Under a sliding window a layer that
    ``cfg.layer_uses_global_attn`` leaves local attends within its
    window (``l0_bidir``), as the LM's layers do: the reference's
    classifier passes no ``layer_global`` and so runs every layer global,
    which makes its Table 1 "local" encoder (``attention='full'`` with
    ``window=16``) a full one (ROADMAP C)."""
    B, S = tokens.shape
    h = params["embed"]["w"][tokens.long()].to(cfg.torch_dtype)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for i, lp in enumerate(params["layers"]):
        h = h + attn_apply(lp["attn"], cfg, rmsnorm(lp["ln1"], h), positions,
                           causal=False, kv_weight=mask,
                           layer_global=cfg.layer_uses_global_attn(i))
        h = h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h), cfg.mlp_activation)
    h = rmsnorm(params["final_norm"], h)
    if mask is not None:
        w = mask[..., None].to(h.dtype)
        pooled = (h * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    else:
        pooled = h.mean(1)
    return dense(params["head"], pooled).to(torch.float32)


def classifier_loss(params, cfg: ModelConfig, batch):
    """batch: tokens (B, S), label (B,) [, mask (B, S)].  Mean
    cross-entropy through ``logsumexp``; returns (loss, {"acc"})."""
    logits = classifier_logits(params, cfg, batch["tokens"],
                               batch.get("mask"))
    labels = batch["label"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, {"acc": acc}
