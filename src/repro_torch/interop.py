"""Parameters of the JAX package in the port's layout.

``params_from_jax`` takes the JAX LM's or the JAX encoder classifier's
parameter tree with every leaf
already converted to a numpy array (``jax.tree.map(np.asarray, params)``
on the caller's side), so this module imports neither ``jax`` nor the
JAX package.  The dense JAX stack keeps its layers stacked on a leading
axis (it scans over them); the port keeps one dictionary per layer.
Every projection has the same (d_in, d_out) layout in both packages, so
no weight is transposed.  bfloat16 leaves (``ml_dtypes.bfloat16``
arrays on the numpy side) are carried bit for bit through their 16-bit
pattern, so neither side of the copy needs ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .models.common import ModelConfig
from .tree import tree_map

# what every layer must hold, by the layer's kind: block -> entries
_COMMON_KEYS = {"ln1": ("g",), "attn": ("wq", "wkv", "wo"), "ln2": ("g",)}
_MLP_KEYS = ("wg", "wu", "wd")


def _layer_keys(cfg: ModelConfig) -> Dict[str, tuple]:
    """Block -> entries a layer of ``cfg`` holds: ``mlp``'s gated MLP, or
    a MoE layer's router and experts (with the shared expert and its gate,
    or the dense residual branch, where the config has them)."""
    if cfg.moe_experts <= 0:
        return {**_COMMON_KEYS, "mlp": _MLP_KEYS}
    moe = ("router", "w1", "w3", "w2")
    if cfg.moe_shared_d_ff:
        moe += ("shared", "shared_gate")
    if cfg.moe_dense_residual:
        moe += ("residual",)
    return {**_COMMON_KEYS, "moe": moe}


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device=None) -> Dict[str, Any]:
    """JAX LM or classifier parameters (numpy leaves) -> the port's
    parameter tree on ``device`` (default ``cuda``).  Carries ``embed.w``,
    ``final_norm.g``, ``lm_head.w`` (untied heads only), the classifier's
    ``head.w`` (and ``head.b``) when the tree has a ``head``, and per
    layer ``ln1.g``, ``ln2.g``, ``attn.{wq,wkv,wo}`` (with any bias and
    q/k norms) and ``mlp.{wg,wu,wd}``, or in a MoE layer
    ``moe.{router,w1,w3,w2}`` with ``moe.shared.{wg,wu,wd}`` and
    ``moe.shared_gate`` or ``moe.residual.{wg,wu,wd}``."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if isinstance(layers, dict):          # the scanned stack: unstack
        n = np.asarray(layers["ln1"]["g"]).shape[0]
        layers = [tree_map(lambda a, i=i: np.asarray(a)[i], layers)
                  for i in range(n)]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, cfg has "
                         f"{cfg.num_layers}")
    need = _layer_keys(cfg)
    for i, lp in enumerate(layers):
        missing = [f"layers[{i}].{b}.{k}" for b, keys in need.items()
                   for k in keys if k not in lp.get(b, {})]
        if missing:
            raise KeyError(f"JAX tree lacks {missing}")
    out: Dict[str, Any] = {"embed": {"w": tree["embed"]["w"]},
                           "final_norm": {"g": tree["final_norm"]["g"]},
                           "layers": layers}
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": tree["lm_head"]["w"]}
    if "head" in tree:
        out["head"] = {k: tree["head"][k] for k in ("w", "b")
                       if k in tree["head"]}
    return tree_map(lambda a: _tensor(a).to(dev), out)


def _tensor(a) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same dtype and bits; numpy
    knows bfloat16 only through ``ml_dtypes``, whose arrays are read as
    their int16 bit patterns and viewed as ``torch.bfloat16``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))
