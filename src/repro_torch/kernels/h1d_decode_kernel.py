"""Single-token decode on the hierarchical KV cache: plain versions and
CUDA kernel wrappers.

Port of the dense-cache kernels of ``repro.kernels.h1d_decode_kernel``:

* :func:`decode_attend_fused` -- every cache row ``r`` (slots x kv-heads)
  attends, at its position ``t[r]``, its own level-0 block (causal), the
  previous level-0 block and one coarse block ``I_l - 1`` per level under
  the quadrant mask, with weight ``2**l`` in the denominator only; one
  max over all bands.  Returns the normalised (R, G, Dv) in ``q.dtype``.
* :func:`update_cache_fused` -- appends one token: the level-l ancestor
  row ``t >> l`` becomes the pairwise mean (k) or sum (v) of its updated
  children, for every level.  Updates the cache IN PLACE (the JAX
  version returns a new cache; PyTorch lets the port save the copy) and
  returns it.

``cache`` is a ``core.h1d_decode.H1DCache``.  Each wrapper chooses by the
device of its tensors: CPU tensors take the plain version (mirrors of the
jnp paths ``core.h1d_decode.decode_attend`` and ``_update_one``), CUDA
tensors launch the kernels in ``csrc/h1d_decode.cu``.
``<wrapper>.launches`` counts kernel launches and ``<plain>.calls``
counts runs of the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import hierarchy as hc
from . import _build

_MIN_M = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    "h1d_decode_attend": [_P, _P, _P, _PP, _PP, _P, _P] + [_I] * 7
                         + [ctypes.c_float, _P],
    "h1d_update_cache": [_P, _P, _P, _PP, _PP] + [_I] * 5 + [_P],
}


def _lib():
    return _build.library("h1d_decode", _SIGNATURES)


def _ptrs(tensors):
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() for t in tensors])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _block_read_rows(arr, blk, size):
    """Per-row block read: arr (R, L, D), blk (R,) -> (R, size, D)."""
    R, L, D = arr.shape
    rows = torch.arange(R, device=arr.device)
    return arr.reshape(R, L // size, size, D)[rows, blk]


def decode_attend_ref(cache, q, t, *, nr: int, softmax_scale=None):
    """Plain PyTorch batched single-token attention (mirror of the jnp
    path of ``repro.core.h1d_decode.decode_attend``).  q (R, G, D), t
    (R,) positions.  Returns (R, G, Dv) in q.dtype."""
    decode_attend_ref.calls += 1
    f32 = torch.float32
    R, G, D = q.shape
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    qs = q.to(f32) * scale
    t = t.to(torch.long)
    Lmax = cache.k.shape[-2]
    M = hc.num_levels(Lmax, nr)
    dev = q.device
    j = torch.arange(nr, device=dev)

    logits, values, weights = [], [], []

    def band(keys, vals, mask, wgt):
        s = torch.einsum("bgd,bkd->bgk", qs, keys.to(f32))
        logits.append(torch.where(mask[:, None, :], s, hc.NEG_INF))
        values.append(vals.to(f32))
        weights.append(torch.where(mask, wgt, 0.0))

    blk0 = torch.div(t, nr, rounding_mode="floor")
    pos = blk0[:, None] * nr + j[None, :]
    ones = torch.ones((R, nr), dtype=f32, device=dev)
    band(_block_read_rows(cache.k, blk0, nr),
         _block_read_rows(cache.v, blk0, nr), pos <= t[:, None], ones)
    prev = torch.clamp(blk0 - 1, min=0)
    band(_block_read_rows(cache.k, prev, nr),
         _block_read_rows(cache.v, prev, nr),
         (blk0 >= 1)[:, None].expand(R, nr), ones)
    for l in range(1, M):
        span = nr << l
        Il = torch.div(t, span, rounding_mode="floor")
        blk = torch.clamp(Il - 1, min=0)
        first_half_q = (t % span) < (span // 2)
        key_last_half = j >= nr // 2
        mask = (Il >= 1)[:, None] & ~(first_half_q[:, None]
                                      & key_last_half[None, :])
        band(_block_read_rows(cache.ck[l - 1], blk, nr),
             _block_read_rows(cache.cv[l - 1], blk, nr),
             mask, torch.full((R, nr), float(1 << l), dtype=f32, device=dev))

    s = torch.cat(logits, dim=-1)                      # (R, G, K)
    vcat = torch.cat(values, dim=-2)                   # (R, K, Dv)
    wcat = torch.cat(weights, dim=-1)                  # (R, K)
    m = torch.clamp(s.amax(-1, keepdim=True), min=_MIN_M)
    a = torch.exp(s - m)
    num = torch.einsum("bgk,bkv->bgv", a, vcat)
    den = torch.einsum("bgk,bk->bg", a, wcat)
    return (num / torch.clamp(den, min=1e-9)[..., None]).to(q.dtype)


decode_attend_ref.calls = 0


def update_cache_ref(cache, k_new, v_new, t):
    """Plain PyTorch ancestor update, in place (mirror of the jnp
    ``repro.core.h1d_decode._update_one`` over rows).  k_new (R, D),
    v_new (R, Dv), t (R,) positions in [0, Lmax)."""
    update_cache_ref.calls += 1
    R = k_new.shape[0]
    rows = torch.arange(R, device=k_new.device)
    t = t.to(torch.long)
    cache.k[rows, t] = k_new.to(cache.k.dtype)
    cache.v[rows, t] = v_new.to(cache.v.dtype)
    k_lo, v_lo = cache.k, cache.v
    for l, (ckl, cvl) in enumerate(zip(cache.ck, cache.cv), start=1):
        c = t >> l                  # this token's ancestor at level l
        ckl[rows, c] = (k_lo[rows, 2 * c] + k_lo[rows, 2 * c + 1]) * 0.5
        cvl[rows, c] = v_lo[rows, 2 * c] + v_lo[rows, 2 * c + 1]
        k_lo, v_lo = ckl, cvl
    return cache


update_cache_ref.calls = 0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cache(cache, R, D, Dv):
    Lmax = cache.k.shape[-2]
    _build.expect(cache.k, "cache.k", (R, Lmax, D))
    _build.expect(cache.v, "cache.v", (R, Lmax, Dv))
    for l, (ckl, cvl) in enumerate(zip(cache.ck, cache.cv), start=1):
        _build.expect(ckl, f"cache.ck[{l - 1}]", (R, Lmax >> l, D))
        _build.expect(cvl, f"cache.cv[{l - 1}]", (R, Lmax >> l, Dv))
    return Lmax


def decode_attend_fused(cache, q, t, *, nr: int, softmax_scale=None):
    """Batched single-token attention.  q (R, G, D), t (R,) int32.  CPU
    tensors take :func:`decode_attend_ref`; CUDA tensors launch
    ``h1d_decode_attend``."""
    if q.device.type == "cpu":
        return decode_attend_ref(cache, q, t, nr=nr,
                                 softmax_scale=softmax_scale)
    lib = _lib()
    R, G, D = q.shape
    Dv = cache.v.shape[-1]
    Lmax = _check_cache(cache, R, D, Dv)
    M = hc.num_levels(Lmax, nr)
    if len(cache.ck) != max(M - 1, 0):
        raise ValueError(f"cache has {len(cache.ck)} coarse levels, "
                         f"Lmax={Lmax} and nr={nr} need {max(M - 1, 0)}")
    _build.expect(q, "q", (R, G, D))
    _build.expect(t, "t", (R,), torch.int32)
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    out = torch.empty((R, G, Dv), dtype=torch.float32, device=q.device)
    _build.check(lib.h1d_decode_attend(
        q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        _ptrs(cache.ck), _ptrs(cache.cv), t.data_ptr(), out.data_ptr(),
        R, G, Lmax, D, Dv, nr, len(cache.ck), float(scale),
        _build.stream()), "h1d_decode_attend")
    decode_attend_fused.launches += 1
    return out


decode_attend_fused.launches = 0


def update_cache_fused(cache, k_new, v_new, t):
    """In-place cache append.  k_new (R, D), v_new (R, Dv), t (R,) int32.
    CPU tensors take :func:`update_cache_ref`; CUDA tensors launch
    ``h1d_update_cache``.  Returns ``cache``."""
    if k_new.device.type == "cpu":
        return update_cache_ref(cache, k_new, v_new, t)
    lib = _lib()
    R, D = k_new.shape
    Dv = v_new.shape[-1]
    Lmax = _check_cache(cache, R, D, Dv)
    _build.expect(k_new, "k_new", (R, D))
    _build.expect(v_new, "v_new", (R, Dv))
    _build.expect(t, "t", (R,), torch.int32)
    ks = [cache.k, *cache.ck]
    vs = [cache.v, *cache.cv]
    _build.check(lib.h1d_update_cache(
        k_new.data_ptr(), v_new.data_ptr(), t.data_ptr(), _ptrs(ks),
        _ptrs(vs), R, Lmax, D, Dv, len(ks), _build.stream()),
        "h1d_update_cache")
    update_cache_fused.launches += 1
    return cache


update_cache_fused.launches = 0
