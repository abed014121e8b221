"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Twelve kernels carry the serving (dense slots, paged and int8 pools,
sequence-parallel shards) and training paths of the paper LM and the
classify and train paths of the LRA encoder (sources in ``csrc/``, built
by ``_build`` with ``nvcc`` at first use).  ``band_attention_fwd`` and ``band_attention_bwd`` take every
band mode: ``l0_causal`` (the LM's level 0), ``l0_bidir`` and
``coarse_bidir`` (the encoder's level 0 and coarse levels) and
``coarse_causal`` (the coarse-q decoder's coarse levels); the ``sub``
kernels run the fine-q LM's coarse levels.  In ``l0_causal`` the forward
and the backward have a second, streamed body for windows too wide to
stage (gemma3's sliding-window layers, nr = 1024), counted under
``l0_causal_stream``.  ``ref.band_attention_ref`` is the dense oracle of
#1 and #2 (one masked product over every key), for tests and the smoke.

======================== ============================== ==================
wrapper                  replaces (repro/kernels/...)   plain version
======================== ============================== ==================
band_attention_fwd       h1d_block.band_attention_fwd   band_attention_fwd_ref
band_attention_sub_fwd   h1d_block.band_attention_sub_fwd
                                                        band_attention_sub_fwd_ref
band_attention_bwd       h1d_block_bwd.band_attention_bwd
                                                        band_attention_bwd_ref
band_attention_sub_bwd   h1d_block_bwd.band_attention_sub_bwd
                                                        band_attention_sub_bwd_ref
decode_attend_fused      h1d_decode_kernel.decode_attend_fused
                                                        decode_attend_ref
update_cache_fused       h1d_decode_kernel.update_cache_fused
                                                        update_cache_ref
decode_attend_paged      h1d_decode_kernel.decode_attend_paged
                                                        decode_attend_paged_ref
decode_attend_paged_quant
                         h1d_decode_kernel.decode_attend_paged_quant
                                                        decode_attend_paged_quant_ref
update_cache_paged       h1d_decode_kernel.update_cache_paged
                                                        update_cache_paged_ref
update_cache_paged_quant h1d_decode_kernel.update_cache_paged_quant
                                                        update_cache_paged_quant_ref
decode_attend_partial    h1d_decode_kernel.decode_attend_partial
                                                        decode_attend_partial_ref
update_cache_partial     h1d_decode_kernel.update_cache_partial
                                                        update_cache_partial_ref
======================== ============================== ==================
"""
from .h1d_block import (band_attention_fwd, band_attention_sub_fwd,
                        band_attention_fwd_ref, band_attention_sub_fwd_ref,
                        band_mask, MODES, SUB_MODE)
from .h1d_block_bwd import (band_attention_bwd, band_attention_sub_bwd,
                            band_attention_bwd_ref,
                            band_attention_sub_bwd_ref)
from .h1d_decode_kernel import (decode_attend_fused, update_cache_fused,
                                decode_attend_ref, update_cache_ref,
                                decode_attend_paged, decode_attend_paged_ref,
                                decode_attend_paged_quant,
                                decode_attend_paged_quant_ref,
                                update_cache_paged, update_cache_paged_ref,
                                update_cache_paged_quant,
                                update_cache_paged_quant_ref,
                                decode_attend_partial,
                                decode_attend_partial_ref,
                                update_cache_partial,
                                update_cache_partial_ref)
from .ops import band_attention
from .ref import band_attention_ref

#: (kernel wrapper, its plain version) for every kernel of the package
KERNELS = {
    "band_attention_fwd": (band_attention_fwd, band_attention_fwd_ref),
    "band_attention_sub_fwd": (band_attention_sub_fwd,
                               band_attention_sub_fwd_ref),
    "band_attention_bwd": (band_attention_bwd, band_attention_bwd_ref),
    "band_attention_sub_bwd": (band_attention_sub_bwd,
                               band_attention_sub_bwd_ref),
    "decode_attend_fused": (decode_attend_fused, decode_attend_ref),
    "update_cache_fused": (update_cache_fused, update_cache_ref),
    "decode_attend_paged": (decode_attend_paged, decode_attend_paged_ref),
    "decode_attend_paged_quant": (decode_attend_paged_quant,
                                  decode_attend_paged_quant_ref),
    "update_cache_paged": (update_cache_paged, update_cache_paged_ref),
    "update_cache_paged_quant": (update_cache_paged_quant,
                                 update_cache_paged_quant_ref),
    "decode_attend_partial": (decode_attend_partial,
                              decode_attend_partial_ref),
    "update_cache_partial": (update_cache_partial, update_cache_partial_ref),
}

#: the kernels a dense-slot serving run launches, those a paged serving
#: run adds (#7/#9 on fp32 pools, #8/#10 on int8 pools), those a
#: sequence-parallel serving run launches (#6 on the replicated deep
#: levels) and those a training step launches
SERVE_KERNELS = ("band_attention_fwd", "band_attention_sub_fwd",
                 "decode_attend_fused", "update_cache_fused")
PAGED_SERVE_KERNELS = ("decode_attend_paged", "decode_attend_paged_quant",
                       "update_cache_paged", "update_cache_paged_quant")
SP_SERVE_KERNELS = ("band_attention_fwd", "band_attention_sub_fwd",
                    "decode_attend_partial", "update_cache_partial",
                    "update_cache_fused")
TRAIN_KERNELS = ("band_attention_fwd", "band_attention_sub_fwd",
                 "band_attention_bwd", "band_attention_sub_bwd")

#: (kernel, mode) pairs: those the LRA encoder's classification launches
#: (its training adds the backward of each), and those a coarse-q LM's
#: training step launches
LRA_KERNELS = (("band_attention_fwd", "l0_bidir"),
               ("band_attention_fwd", "coarse_bidir"),
               ("band_attention_bwd", "l0_bidir"),
               ("band_attention_bwd", "coarse_bidir"))
COARSE_Q_KERNELS = (("band_attention_fwd", "l0_causal"),
                    ("band_attention_fwd", "coarse_causal"),
                    ("band_attention_bwd", "l0_causal"),
                    ("band_attention_bwd", "coarse_causal"))


def reset_counts() -> None:
    """Set every kernel's launch count (and its count per mode, where it
    keeps one) and every plain version's call count to 0."""
    for kernel, plain in KERNELS.values():
        kernel.launches = 0
        plain.calls = 0
        if hasattr(kernel, "mode_launches"):
            kernel.mode_launches = {}


def mode_launches() -> dict:
    """Launches per (kernel, mode) since the last :func:`reset_counts`."""
    return {(name, mode): n for name, (kernel, _) in KERNELS.items()
            for mode, n in getattr(kernel, "mode_launches", {}).items()}


__all__ = ["band_attention", "band_attention_ref", "band_attention_fwd",
           "band_attention_sub_fwd",
           "band_attention_fwd_ref", "band_attention_sub_fwd_ref",
           "band_attention_bwd", "band_attention_sub_bwd",
           "band_attention_bwd_ref", "band_attention_sub_bwd_ref",
           "band_mask", "decode_attend_fused", "update_cache_fused",
           "decode_attend_ref", "update_cache_ref", "decode_attend_paged",
           "decode_attend_paged_ref", "decode_attend_paged_quant",
           "decode_attend_paged_quant_ref", "update_cache_paged",
           "update_cache_paged_ref", "update_cache_paged_quant",
           "update_cache_paged_quant_ref", "decode_attend_partial",
           "decode_attend_partial_ref", "update_cache_partial",
           "update_cache_partial_ref", "MODES", "SUB_MODE", "KERNELS",
           "SERVE_KERNELS", "PAGED_SERVE_KERNELS", "SP_SERVE_KERNELS",
           "TRAIN_KERNELS",
           "LRA_KERNELS", "COARSE_Q_KERNELS", "reset_counts",
           "mode_launches"]
