"""Launch records of the CUDA kernel wrappers.

The port's counterpart of the launch-record half of
``repro.analysis.contracts``.  The reference records a ``LaunchContract``
(grid, BlockSpecs, index maps) for every traced ``pallas_call``; the
port's kernels are hand-written CUDA launched by ``ctypes``, so what a
wrapper hands over after each launch is a frozen :class:`LaunchRecord`:

* ``family``, in the reference's names (``band_fwd``, ``sub_fwd``,
  ``band_bwd``, ``sub_bwd``, ``decode_attend``, ``decode_update``, their
  ``_paged``, ``_paged_quant`` and ``_partial`` forms; ``kernels.FAMILY``
  maps each wrapper to its family);
* ``grid``, the CUDA grid of each kernel the launcher runs (the
  two-kernel backward has two);
* the operands' shapes and dtypes as the kernels read and write them
  (q, k_new and v_new widened to float32, as the wrappers pass them);
* ``meta``: ``mode``, ``nr``, ``ratio``, ``Lmax``, ``levels``, ``G``,
  ``d``, ``dv``, ``half`` where they apply, ``impl="cuda"``, and
  ``body`` for #1 / #3's streamed ``l0_causal`` body.

One function per family makes the record from the wrapper's operands.
It reads shapes, dtypes and Python ints only: it never reads tensor
data, so it never synchronises (the tests run every one on ``meta``
tensors).  A wrapper builds a record only while a hook is registered or
a :func:`capture` is open (:data:`ACTIVE`), so telemetry that is off
costs the launch one branch.  The CPU path (the plain versions) launches
nothing and records nothing.

Unlike the reference, which records once per traced shape, every launch
is recorded: the port runs eagerly.

This module imports only torch and the standard library, so that the
kernel modules can import it without a cycle.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

Grid = Tuple[Tuple[int, ...], ...]


class Operand(NamedTuple):
    """One kernel operand: its name, shape (a ``torch.Size``, a tuple of
    ints) and ``torch.dtype``.  A tuple, not a dataclass: a wrapper makes
    a dozen a launch, and a tuple is the cheapest immutable record to
    build and to hash."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True, eq=False)
class LaunchRecord:
    """What one wrapper call launched (see the module docstring).
    Compared and hashed by identity: a record function hands over one record
    again for every launch of the same shapes (:func:`_seen`).  ``memo``
    holds what a consumer derives from the record once (the traffic
    model's counts), so it lives and goes with the record."""
    family: str
    grid: Grid
    inputs: Tuple[Operand, ...]
    outputs: Tuple[Operand, ...]
    meta: Dict[str, Any]
    memo: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                             repr=False)

    def operand(self, name: str) -> Operand:
        for op in self.inputs + self.outputs:
            if op.name == name:
                return op
        raise KeyError(f"{self.family}: no operand {name!r}")

    def describe(self) -> str:
        ins = ", ".join(f"{o.name}{list(o.shape)}" for o in self.inputs)
        outs = ", ".join(f"{o.name}{list(o.shape)}" for o in self.outputs)
        return (f"{self.family} grid={[list(g) for g in self.grid]} "
                f"in=[{ins}] out=[{outs}] meta={self.meta}")


# -- recording --------------------------------------------------------------

_RECENT: collections.deque = collections.deque(maxlen=256)
_CAPTURES: List[List[LaunchRecord]] = []
_LAUNCH_HOOKS: List[Callable[[LaunchRecord], None]] = []
#: True while a hook is registered or a capture is open: the wrappers
#: build and hand over a record only then
ACTIVE = False


def _refresh() -> None:
    global ACTIVE
    ACTIVE = bool(_LAUNCH_HOOKS or _CAPTURES)


def record(rec: LaunchRecord) -> None:
    """Hand over one launch: kept in :func:`recent`, appended to every
    open capture, passed to every hook."""
    _RECENT.append(rec)
    for buf in _CAPTURES:
        buf.append(rec)
    for hook in _LAUNCH_HOOKS:
        hook(rec)


def add_launch_hook(hook: Callable[[LaunchRecord], None]) -> None:
    """Register a callback fired on every recorded launch.  This is how
    the telemetry layer (``repro_torch.obs``) observes launches without
    this module importing it."""
    if hook not in _LAUNCH_HOOKS:
        _LAUNCH_HOOKS.append(hook)
    _refresh()


def remove_launch_hook(hook: Callable[[LaunchRecord], None]) -> None:
    if hook in _LAUNCH_HOOKS:
        _LAUNCH_HOOKS.remove(hook)
    _refresh()


@contextlib.contextmanager
def capture():
    """Collect every record made while the context is active."""
    buf: List[LaunchRecord] = []
    _CAPTURES.append(buf)
    _refresh()
    try:
        yield buf
    finally:
        _CAPTURES.remove(buf)
        _refresh()


def recent(family: Optional[str] = None) -> List[LaunchRecord]:
    """Recently recorded launches (newest last), optionally filtered."""
    return [r for r in _RECENT if family is None or r.family == family]


# -- record functions -------------------------------------------------------

def _op(name: str, t: torch.Tensor) -> Operand:
    return Operand(name, t.shape, t.dtype)


def _f32(name: str, *shape: int) -> Operand:
    return Operand(name, torch.Size(shape), torch.float32)


def _make(family: str, grid: Grid, inputs: Sequence[Operand],
          outputs: Sequence[Operand], **meta) -> LaunchRecord:
    meta["impl"] = "cuda"
    return LaunchRecord(family, tuple(grid), tuple(inputs), tuple(outputs),
                        meta)


#: records by launch signature: a decode loop launches the same shapes
#: every tick and a training step the same ones every step, so each
#: record is built once and handed over again
_SEEN: Dict[tuple, LaunchRecord] = {}
_SEEN_MAX = 4096


def _seen(family, grid, options, tensors, build) -> LaunchRecord:
    """The record of ``build()``, made once per signature: the family,
    grid and options and every operand tensor's shape and dtype (all a
    record depends on)."""
    key = (family, grid, options, *[(x.shape, x.dtype) for x in tensors])
    rec = _SEEN.get(key)
    if rec is None:
        if len(_SEEN) >= _SEEN_MAX:
            _SEEN.clear()
        rec = _SEEN[key] = build()
    return rec


def _band_meta(q, k, v, nr, mode, ratio):
    B, G, Lq, d = q.shape
    return dict(mode=mode, nr=nr, ratio=ratio, G=G, d=d, dv=v.shape[-1],
                Lq=Lq, Lk=k.shape[-2])


def _band_fwd_ops(q, k, v, w):
    B, G, Lq, _ = q.shape
    dv = v.shape[-1]
    return ((_op("q", q), _op("k", k), _op("v", v), _op("w", w)),
            (_f32("y", B, G, Lq, dv), _f32("dn", B, G, Lq),
             _f32("m", B, G, Lq)))


def _band_bwd_ops(q, k, v, w):
    B, G, Lq, d = q.shape
    Lk, dv = k.shape[-2], v.shape[-1]
    ins, outs = _band_fwd_ops(q, k, v, w)
    cot = (_f32("gy", B, G, Lq, dv), _f32("gdn", B, G, Lq),
           _f32("gm", B, G, Lq))
    return (ins + outs + cot,
            (_f32("dq", B, G, Lq, d), _f32("gmn", B, G, Lq),
             _f32("dk", B, Lk, d), _f32("dv", B, Lk, dv), _f32("dw", B, Lk)))


def _band(family, ops, q, k, v, w, nr, mode, ratio, grid, body):
    def build():
        ins, outs = ops(q, k, v, w)
        meta = _band_meta(q, k, v, nr, mode, ratio)
        if body is not None:
            meta["body"] = body
        return _make(family, grid, ins, outs, **meta)
    return _seen(family, grid, (nr, mode, ratio, body), (q, k, v, w), build)


def band_fwd(q, k, v, w, *, nr: int, mode: str, grid: Grid = (),
             body: str = "band") -> LaunchRecord:
    """#1 (``band_attention_fwd``) in ``mode``: q (B, G, L, d), k (B, L,
    d), v (B, L, dv), w (B, L) -> y, dn, m; ``body`` the staged
    (``band``) or streamed (``stream``) one."""
    return _band("band_fwd", _band_fwd_ops, q, k, v, w, nr, mode, 1, grid,
                 body)


def sub_fwd(q, k, v, w, *, nr: int, ratio: int, grid: Grid = ()
            ) -> LaunchRecord:
    """#2 (``band_attention_sub_fwd``): fine q (B, G, Lq, d) against the
    coarse k (B, Lk, d), v, w, Lq = Lk * ratio."""
    return _band("sub_fwd", _band_fwd_ops, q, k, v, w, nr, "sub", ratio,
                 grid, None)


def band_bwd(q, k, v, w, *, nr: int, mode: str, grid: Grid = (),
             body: str = "band") -> LaunchRecord:
    """#3 (``band_attention_bwd``): the saved q, k, v, w, y, dn, m and
    the cotangents gy, gdn, gm -> dq, gmn, dk, dv, dw."""
    return _band("band_bwd", _band_bwd_ops, q, k, v, w, nr, mode, 1, grid,
                 body)


def sub_bwd(q, k, v, w, *, nr: int, ratio: int, grid: Grid = ()
            ) -> LaunchRecord:
    """#4 (``band_attention_sub_bwd``), as :func:`band_bwd` at a sub
    level."""
    return _band("sub_bwd", _band_bwd_ops, q, k, v, w, nr, "sub", ratio,
                 grid, None)


#: operand names of the levels (a pool or cache holds at most 32)
_LEVEL_NAMES = tuple((f"k{l}", f"v{l}", f"ksc{l}", f"vsc{l}")
                     for l in range(32))


def _levels(ks, vs, scales=None) -> List[Operand]:
    ops = []
    for names, k, v in zip(_LEVEL_NAMES, ks, vs):
        ops.append(Operand(names[0], k.shape, k.dtype))
        ops.append(Operand(names[1], v.shape, v.dtype))
    if scales is not None:
        for names, ksc, vsc in zip(_LEVEL_NAMES, *scales):
            ops.append(Operand(names[2], ksc.shape, ksc.dtype))
            ops.append(Operand(names[3], vsc.shape, vsc.dtype))
    return ops


def _half(ks, quant: bool = False) -> int:
    plain = [k.dtype for k in ks if not (quant and k.dtype == torch.int8)]
    return int(bool(plain) and plain[0] == torch.bfloat16)


def _attend(family, q, ks, vs, t, tables, nr, grid, scales=None, out=None,
            **extra):
    def build():
        R, G, D = q.shape
        Dv = vs[0].shape[-1]
        ins = ([_f32("q", R, G, D)] + _levels(ks, vs, scales)
               + [_op("t", t)] + [_op(name, tab) for name, tab in tables])
        outs = out() if out else [_f32("out", R, G, Dv)]
        return _make(family, grid, ins, outs, nr=nr, levels=len(ks), G=G,
                     d=D, dv=Dv, half=_half(ks, scales is not None), **extra)
    tensors = [q, t, *ks, *vs, *(tab for _, tab in tables)]
    if scales is not None:
        tensors += [*scales[0], *scales[1]]
    return _seen(family, grid, (nr, *extra.items()), tensors, build)


def decode_attend(cache, q, t, *, nr: int, grid: Grid = ()) -> LaunchRecord:
    """#5 (``decode_attend_fused``) on a dense cache: q (R, G, D), t (R,);
    every level's k and v."""
    return _attend("decode_attend", q, [cache.k, *cache.ck],
                   [cache.v, *cache.cv], t, (), nr, grid,
                   Lmax=cache.k.shape[-2])


def decode_attend_paged(pool, q, t, bidx, *, nr: int, grid: Grid = ()
                        ) -> LaunchRecord:
    """#7 (``decode_attend_paged``): every pool level, the page table
    ``bidx`` (R, 2 + levels)."""
    return _attend("decode_attend_paged", q, [pool.k, *pool.ck],
                   [pool.v, *pool.cv], t, (("bidx", bidx),), nr, grid)


def decode_attend_paged_quant(pool, q, t, bidx, *, nr: int, grid: Grid = ()
                              ) -> LaunchRecord:
    """#8 (``decode_attend_paged_quant``): as #7 with every level's
    per-row scales (an int8 level's rows are ``int8``)."""
    scales = ([pool.ksc, *pool.cksc], [pool.vsc, *pool.cvsc])
    return _attend("decode_attend_paged_quant", q, [pool.k, *pool.ck],
                   [pool.v, *pool.cv], t, (("bidx", bidx),), nr, grid,
                   scales=scales)


def decode_attend_partial(cache, q, t, bidx, owned, *, nr: int,
                          grid: Grid = ()) -> LaunchRecord:
    """#11 (``decode_attend_partial``) on one shard's slab: the shard's
    levels, ``bidx`` and ``owned`` (R, 2 + levels) -> num, den, m."""
    R, G, _ = q.shape
    Dv = cache.v.shape[-1]
    return _attend("decode_attend_partial", q, [cache.k, *cache.ck],
                   [cache.v, *cache.cv], t, (("bidx", bidx),
                                             ("owned", owned)), nr, grid,
                   out=lambda: [_f32("num", R, G, Dv), _f32("den", R, G),
                                _f32("m", R, G)])


def _update(family, ks, vs, k_new, v_new, t, tables, grid, scales=None,
            extra_out=(), **extra):
    def build():
        R, D = k_new.shape
        Dv = v_new.shape[-1]
        ins = ([_f32("k_new", R, D), _f32("v_new", R, Dv), _op("t", t)]
               + [_op(name, tab) for name, tab in tables]
               + _levels(ks, vs, scales))
        # in place: every level is read and written
        outs = _levels(ks, vs, scales) + list(extra_out)
        return _make(family, grid, ins, outs, levels=len(ks), d=D, dv=Dv,
                     half=_half(ks, scales is not None), **extra)
    tensors = [k_new, v_new, t, *ks, *vs, *(tab for _, tab in tables)]
    if scales is not None:
        tensors += [*scales[0], *scales[1]]
    return _seen(family, grid, tuple(extra.items()), tensors, build)


def decode_update(cache, k_new, v_new, t, *, grid: Grid = ()
                  ) -> LaunchRecord:
    """#6 (``update_cache_fused``), in place on every level."""
    return _update("decode_update", [cache.k, *cache.ck],
                   [cache.v, *cache.cv], k_new, v_new, t, (), grid,
                   Lmax=cache.k.shape[-2])


def decode_update_paged(pool, k_new, v_new, t, utab, *, grid: Grid = ()
                        ) -> LaunchRecord:
    """#9 (``update_cache_paged``): the write-page table ``utab`` (R,
    levels)."""
    return _update("decode_update_paged", [pool.k, *pool.ck],
                   [pool.v, *pool.cv], k_new, v_new, t, (("utab", utab),),
                   grid, nr=pool.k.shape[-2])


def decode_update_paged_quant(pool, k_new, v_new, t, utab, *,
                              grid: Grid = ()) -> LaunchRecord:
    """#10 (``update_cache_paged_quant``): as #9 with the scales."""
    scales = ([pool.ksc, *pool.cksc], [pool.vsc, *pool.cvsc])
    return _update("decode_update_paged_quant", [pool.k, *pool.ck],
                   [pool.v, *pool.cv], k_new, v_new, t, (("utab", utab),),
                   grid, scales=scales, nr=pool.k.shape[-2])


def decode_update_partial(cache, k_new, v_new, t_loc, owned, *,
                          grid: Grid = ()) -> LaunchRecord:
    """#12 (``update_cache_partial``) on one shard's sharded levels: the
    carried row of the first replicated level is written beside them."""
    R, D = k_new.shape
    Dv = v_new.shape[-1]
    dt = cache.k.dtype
    carry = (Operand("carry_k", torch.Size((R, D)), dt),
             Operand("carry_v", torch.Size((R, Dv)), dt))
    return _update("decode_update_partial", [cache.k, *cache.ck],
                   [cache.v, *cache.cv], k_new, v_new, t_loc,
                   (("owned", owned),), grid, extra_out=carry)
