"""H-Transformer-1D in PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout and function names (``core/``, ``kernels/``,
``models/``, ``parallel/``, ``serve/``, ``launch/``) so each ported
function sits at the same path as its counterpart.  It imports
``torch`` and numpy only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no such argument they raise instead of quietly running
on the CPU.  Kernel wrappers choose by the tensor's device: a CPU tensor
takes the plain PyTorch version, a CUDA tensor launches the kernel.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "exact_products"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is asked for and no card is present.
    ``meta`` is accepted where only shapes matter (sizing a cache pool
    by its bytes without allocating it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def exact_products() -> None:
    """The card's matrix products in the reference's numerics: float32
    products in full float32 (no TF32) and bfloat16 products summed in
    float32 (no reduced-precision reduction), as the TPU's matrix unit
    sums them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
