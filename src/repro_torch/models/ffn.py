"""Feed-forward layer: gated MLP (SwiGLU / GeGLU).

Port of ``repro.models.ffn.mlp_*``: separate gate ``wg``, up ``wu`` and
down ``wd`` projections.  Mixture-of-experts is a later slice.
"""
from __future__ import annotations

import torch

from .common import activation, dense, dense_init


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32):
    return {"wg": dense_init(gen, d, d_ff, dtype=dtype),
            "wu": dense_init(gen, d, d_ff, dtype=dtype),
            "wd": dense_init(gen, d_ff, d, dtype=dtype)}


def mlp(p, x: torch.Tensor, act_name: str) -> torch.Tensor:
    act = activation(act_name)
    return dense(p["wd"], act(dense(p["wg"], x)) * dense(p["wu"], x))
