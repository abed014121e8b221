"""Meta-tensor input builders for every (arch x shape) dry-run cell.

Port of ``repro.launch.specs``: ``torch.empty(..., device="meta")``
tensors stand where the reference has ``ShapeDtypeStruct`` s -- shapes
and dtypes, no allocation.  The decode caches come from the model's own
cache init on meta parameters, and the encoder-decoder's from its
prefill run on meta tensors (the reference's ``eval_shape`` of its
prefill): the kernel wrappers take meta tensors and hand back empty
outputs of the kernels' shapes (``kernels._build.on_meta``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs import SHAPES
from repro_torch.configs.seamless_m4t_medium import DECODER_LEN
from repro_torch.models import ModelConfig, get_model

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int) -> Dict:
    i32 = torch.int32
    if cfg.family == "encdec":
        return {"frames": _sds((batch, seq, cfg.d_model), cfg.torch_dtype),
                "tokens": _sds((batch, min(DECODER_LEN, seq)), i32)}
    if cfg.family == "vlm":
        toks = max(seq - cfg.prefix_len, cfg.nr)
        return {"tokens": _sds((batch, toks), i32),
                "patch_embeds": _sds((batch, cfg.prefix_len, cfg.d_model),
                                     cfg.torch_dtype)}
    return {"tokens": _sds((batch, seq), i32)}


def prefill_batch_specs(cfg: ModelConfig, seq: int, batch: int) -> Dict:
    return train_batch_specs(cfg, seq, batch)


def decode_arg_specs(cfg: ModelConfig, seq: int, batch: int):
    """Returns (caches, token, t): the caches for ``batch`` rows of
    ``seq`` positions, token and t (batch,) int32."""
    fns = get_model(cfg)
    i32 = torch.int32
    if cfg.family == "encdec":
        # caches come from prefill (they hold the encoder memory)
        _, caches, _ = fns.prefill(param_struct(cfg), cfg,
                                   train_batch_specs(cfg, seq, batch),
                                   min(DECODER_LEN, seq))
    else:
        caches = fns.init_caches(param_struct(cfg), cfg, batch, seq)
    return caches, _sds((batch,), i32), _sds((batch,), i32)


_PSTRUCT_CACHE: Dict[Tuple, Tuple] = {}


def _param_struct_cached(cfg: ModelConfig, tp):
    key = (dataclasses.astuple(cfg), tp)
    if key not in _PSTRUCT_CACHE:
        _PSTRUCT_CACHE[key] = get_model(cfg).init(cfg, device=META, tp=tp,
                                                  specs=True)
    return _PSTRUCT_CACHE[key]


def param_struct(cfg: ModelConfig, tp=None):
    """The parameter tree on meta tensors."""
    return _param_struct_cached(cfg, tp)[0]


def param_specs(cfg: ModelConfig, tp=None):
    """The init's spec tree for TP degree ``tp``."""
    return _param_struct_cached(cfg, tp)[1]


def cell(cfg: ModelConfig, shape) -> Tuple[str, int, int]:
    """Returns (kind, seq, batch) of a ``SHAPES`` name, or of an explicit
    ``(seq, batch, kind)``."""
    seq, batch, kind = SHAPES[shape] if isinstance(shape, str) else shape
    return kind, seq, batch
