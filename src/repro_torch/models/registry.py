"""Unified model API: init / forward / loss / prefill / decode_step /
init_caches.

Port of ``repro.models.registry`` for the decoder-only stack.  The
encoder-decoder family comes later.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from .common import ModelConfig
from . import transformer as T


class ModelFns(NamedTuple):
    init: Callable          # (cfg, *, seed, device) -> params
    forward: Callable       # (params, cfg, tokens, *, prefix_embeds=None)
                            #   -> (logits, aux)
    loss: Callable          # (params, cfg, batch) -> (loss, metrics)
    prefill: Callable       # (params, cfg, batch, Lmax, *, true_len=None)
                            #   -> (logits, caches, pos)
    decode_step: Callable   # (params, cfg, caches, token, t, *,
                            #  page_tables=None, sp_tables=None)
                            #   -> (logits, caches)
    init_caches: Callable   # (params, cfg, B, Lmax) -> caches


def _lm_prefill(params, cfg, batch, Lmax, *, true_len=None):
    return T.lm_prefill(params, cfg, batch["tokens"], Lmax,
                        prefix_embeds=batch.get("patch_embeds"),
                        true_len=true_len)


def get_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family == "encdec":
        raise NotImplementedError("the encoder-decoder family is not "
                                  "ported yet")
    return ModelFns(init=T.lm_init, forward=T.lm_forward, loss=T.lm_loss,
                    prefill=_lm_prefill, decode_step=T.lm_decode_step,
                    init_caches=T.lm_init_decode_caches)
