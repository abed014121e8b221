"""Unified model API: init / forward / loss / prefill / decode_step /
init_caches.

Port of ``repro.models.registry``: the decoder-only stack (the dense,
moe, vlm, ssm (mamba2) and hybrid (zamba2) families) and the
encoder-decoder (``family='encdec'``, seamless-m4t), whose batches carry
``frames`` beside ``tokens`` and whose decode caches only its prefill
builds.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .common import ModelConfig
from . import encdec as ED
from . import transformer as T


class ModelFns(NamedTuple):
    init: Callable          # (cfg, *, seed, device) -> params
    forward: Callable       # (params, cfg, tokens, *, prefix_embeds=None)
                            #   -> (logits, aux); encdec: (params, cfg,
                            #   batch with frames) -> (logits, 0.0)
    loss: Callable          # (params, cfg, batch) -> (loss, metrics)
    prefill: Callable       # (params, cfg, batch, Lmax, *, true_len=None)
                            #   -> (logits, caches, pos)
    decode_step: Callable   # (params, cfg, caches, token, t, *,
                            #  page_tables=None, sp_tables=None)
                            #   -> (logits, caches); encdec: no keywords
    init_caches: Callable   # (params, cfg, B, Lmax) -> caches


def _lm_prefill(params, cfg, batch, Lmax, *, true_len=None):
    return T.lm_prefill(params, cfg, batch["tokens"], Lmax,
                        prefix_embeds=batch.get("patch_embeds"),
                        true_len=true_len)


def _ed_prefill(params, cfg, batch, Lmax, *, true_len=None):
    # no bucketed prompts (the engine does not serve encdec): true_len is
    # taken for the signature and must be the token length
    Sd = batch["tokens"].shape[1]
    if true_len is not None and bool((torch.as_tensor(true_len) != Sd)
                                     .any()):
        raise ValueError("enc-dec prefill takes no bucketed prompts: "
                         f"true_len must be the token length {Sd}")
    return ED.encdec_prefill(params, cfg, batch["frames"], batch["tokens"],
                             Lmax)


def _ed_init_caches(params, cfg, B, Lmax):
    raise NotImplementedError(
        "enc-dec caches are built by prefill (need encoder memory)")


def get_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family == "encdec":
        return ModelFns(init=ED.encdec_init, forward=ED.encdec_forward,
                        loss=ED.encdec_loss, prefill=_ed_prefill,
                        decode_step=ED.encdec_decode_step,
                        init_caches=_ed_init_caches)
    return ModelFns(init=T.lm_init, forward=T.lm_forward, loss=T.lm_loss,
                    prefill=_lm_prefill, decode_step=T.lm_decode_step,
                    init_caches=T.lm_init_decode_caches)
