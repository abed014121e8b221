"""Ranks: one shard a process over a ``torch.distributed`` process group,
and the collectives of the sequence-parallel path and the pipeline.

The reference runs sequence parallelism and the GPipe pipeline as
``shard_map`` over devices, with ``ppermute``, ``all_gather``, ``pmax``
and ``psum`` between them.  Here each shard is a process (a rank) and
the same collectives run over the process group:

* joining: :func:`init_from_env` under ``torchrun`` (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, rendezvous ``env://``); :func:`init`
  with an explicit rank, world size and ``init_method`` (the tests
  rendezvous through a file);
* placement: rank r runs on ``cuda:LOCAL_RANK`` by default (every rank
  its own card); an explicit ``cuda:N`` puts every rank on card N (the
  ranks share it); ``cpu`` puts them on the CPU;
* the backend follows from the placement alone (:data:`BACKENDS`):
  ``nccl`` when every rank owns its card, ``gloo`` on the CPU, and
  ``gloo`` when the ranks share a card, which NCCL refuses.  It is
  printed once, by rank 0, and never retried with another backend.

The collectives are autograd Functions with the reference's semantics:
:func:`ppermute` (an edge rank of an open shift receives zeros; the
backward is the opposite shift; ``cyclic`` is the pipeline's ring),
:func:`all_gather` (tiled along ``dim``), :func:`psum`, :func:`pmax`
(no gradient, as ``jax.lax.pmax`` has none) and :func:`scatter`.  Each
runs over one :class:`RankGroup`: the whole world, or one axis of a
two-axis mesh (:func:`axis_groups`: a data column or a model row, each a
``dist.new_group`` of its own).

Tensor parallelism (``parallel/tensor.py``) adds the conjugate pair of
Megatron's column- and row-parallel products: :func:`copy_to` (identity
forward, psum backward) where a replicated activation enters a
column-parallel product, and :func:`reduce_from` (psum forward,
identity backward) where a row-parallel product's partial sums leave.
:func:`psum`'s psum backward is the pipeline's rule; at a row-parallel
output, whose upstream gradient every rank of the row already holds
whole, it would multiply that gradient by the row's size.

Gradients across the boundary between replicated and sharded values.
Outside the attention every rank computes the same thing, so a
replicated value's gradient is the whole gradient on every rank; inside,
each rank holds the gradient of its own use of a value.  Three rules
convert between the two, and each is one argument of this module:

1. **scatter** (:func:`scatter`): rank r takes its slice of a replicated
   tensor.  Backward: an all-gather of the slices' gradients, so the
   replicated producer gets the whole gradient on every rank.
2. **the output gather** (:func:`all_gather` with ``grad="slice"``): the
   sharded output gathered for replicated use.  Backward: rank r's slice
   of the upstream gradient, with no sum, because every rank already
   holds the same upstream gradient.
3. **the coarse-KV gather** (:func:`all_gather` with ``grad="sum"``):
   each rank uses the gathered transition-level coarse KV for its own
   query rows only, so the upstream gradients differ by rank and the
   backward sums them over ranks and keeps rank r's slice (a
   reduce-scatter).

:func:`psum`'s backward is a psum, for the same reason as rule 3: the
pipeline splits its output by rank before the output gather.

Transport.  P2P runs through ``dist.batch_isend_irecv``, so a ring of
sends and receives cannot deadlock under NCCL.  gloo (torch 2.11) takes
CUDA tensors in its all-reduce (sum and max), all-gather and broadcast,
but its sends and receives fail on them (the TCP pair writes from the
device pointer: ``writev ... Bad address``), so on a shared card a P2P
message is staged through pinned host memory: the shared-card
transport, :func:`_p2p`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

#: the backend of each placement of the ranks
BACKENDS = {"own": "nccl", "shared": "gloo", "cpu": "gloo"}

#: why each placement takes its backend (printed once, by rank 0)
_WHY = {"own": "every rank owns its card",
        "shared": "the ranks share one card, which NCCL refuses",
        "cpu": "the ranks run on the CPU"}


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place in a group: its rank within the group, the
    group's size, the device its shard lives on, the placement of the
    ranks (``own``, ``shared`` or ``cpu``) and the backend that placement
    takes.  The world is the default group (``pg`` None, ``ranks`` empty,
    no ``axis``); a group of one mesh axis holds its ``dist.new_group``
    handle ``pg``, the global ranks it spans in order and its axis name,
    which the collectives' counts carry (``psum@model``)."""
    rank: int
    world: int
    device: torch.device
    placement: str
    pg: Any = None
    ranks: Tuple[int, ...] = ()
    axis: str = ""

    @property
    def backend(self) -> str:
        return BACKENDS[self.placement]

    def peer(self, r: int) -> int:
        """The global rank of the group's rank ``r``."""
        return self.ranks[r] if self.ranks else r


@dataclasses.dataclass
class CommStats:
    """Collective calls, bytes sent and seconds of host wall, by op.  The
    seconds are counted only with ``timed`` on, which synchronizes the
    card before and after each call so that a collective's time is its
    own and not the kernels queued ahead of it.  Nothing is counted
    inside :meth:`paused`."""
    timed: bool = False
    counting: bool = True
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    nbytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def clear(self) -> None:
        self.calls.clear()
        self.nbytes.clear()
        self.seconds.clear()

    def total_s(self) -> float:
        return sum(self.seconds.values())

    @contextlib.contextmanager
    def paused(self):
        """Count no collective inside: a checkpoint's gathers, which are
        no step's."""
        was, self.counting = self.counting, False
        try:
            yield
        finally:
            self.counting = was


_current: Optional[RankGroup] = None
#: the axis groups built in this process, by mesh shape
_axis_groups: Dict[Tuple[int, int], Tuple[RankGroup, RankGroup]] = {}
#: the collectives' counts (``STATS.timed = True`` to time them too)
STATS = CommStats()


def placement(device, local_rank: int) -> tuple:
    """(device, placement) of a rank: ``device`` None or ``cuda`` gives
    ``cuda:local_rank`` (every rank its own card), ``cuda:N`` card N for
    every rank (shared), ``cpu`` the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev, "cpu"
    if dev.type != "cuda":
        raise ValueError(f"ranks run on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the ranks on the CPU")
    if dev.index is None:
        if local_rank >= torch.cuda.device_count():
            raise ValueError(
                f"local rank {local_rank} has no card of its own "
                f"({torch.cuda.device_count()} visible); pass an explicit "
                f"cuda:N to put every rank on card N")
        return torch.device("cuda", local_rank), "own"
    return dev, "shared"


def current() -> Optional[RankGroup]:
    """The group this process joined, or None."""
    return _current


def launched() -> bool:
    """True when ``torchrun`` (or another launcher) set this process's
    ``RANK`` and ``WORLD_SIZE``."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(rank: int, world: int, init_method: str, *, device=None,
         local_rank: Optional[int] = None) -> RankGroup:
    """Join a group of ``world`` ranks as ``rank`` through
    ``init_method`` (``env://``, ``file://...``, ``tcp://...``).  The
    backend follows from the placement (module docstring); every rank's
    device is checked against it once the group stands."""
    global _current
    if _current is not None:
        raise RuntimeError(f"this process already is rank {_current.rank} "
                           f"of {_current.world}")
    dev, where = placement(device, rank if local_rank is None
                           else local_rank)
    backend = BACKENDS[where]
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    devs = [None] * world
    dist.all_gather_object(devs, str(dev))
    distinct = len(set(devs)) == world
    if (where == "own" and not distinct) or (
            where == "shared" and len(set(devs)) != 1):
        dist.destroy_process_group()
        raise ValueError(f"placement {where!r} does not hold: the ranks' "
                         f"devices are {devs}")
    _current = RankGroup(rank=rank, world=world, device=dev, placement=where)
    if rank == 0:
        print(f"[ranks] {world} ranks on {', '.join(devs)}: backend "
              f"{backend} ({_WHY[where]})", flush=True)
    return _current


def init_from_env(device=None) -> RankGroup:
    """Join the group ``torchrun`` describes in this process's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``env://``)."""
    return init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                "env://", device=device,
                local_rank=int(os.environ.get("LOCAL_RANK", "0")))


def destroy() -> None:
    """Leave the group (every rank calls it at the end)."""
    global _current
    if _current is not None:
        _axis_groups.clear()
        dist.destroy_process_group()
        _current = None


def axis_groups(g: RankGroup, shape) -> Tuple[RankGroup, RankGroup]:
    """(data group, model group) of this rank on a ``(D, M)`` mesh over
    the world ``g`` of ``D * M`` ranks.  Rank r sits at ``(r // M, r %
    M)``: its model row holds ranks ``[d M, (d + 1) M)``, adjacent ones
    (one NVLink node under torchrun), and its data column ranks ``m, m +
    M, ...``.  Every rank creates every row and every column, in the same
    order (``dist.new_group`` is collective over the world), once a
    shape."""
    D, M = shape
    if D * M != g.world or g.pg is not None:
        raise ValueError(f"a {D}x{M} mesh needs the world of {D * M} ranks, "
                         f"got a group of {g.world}")
    if (D, M) not in _axis_groups:
        d, m = divmod(g.rank, M)
        mine = {}
        for axis, sets in (("model", [[i * M + j for j in range(M)]
                                      for i in range(D)]),
                           ("data", [[i * M + j for i in range(D)]
                                     for j in range(M)])):
            for ranks in sets:
                pg = dist.new_group(ranks)
                if g.rank in ranks:
                    mine[axis] = RankGroup(
                        rank=ranks.index(g.rank), world=len(ranks),
                        device=g.device, placement=g.placement, pg=pg,
                        ranks=tuple(ranks), axis=axis)
        _axis_groups[(D, M)] = (mine["data"], mine["model"])
    return _axis_groups[(D, M)]


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

class _counted:
    """Count one collective call of ``op`` over ``g`` moving ``nbytes``
    (under ``op@axis`` for a group of one mesh axis); with
    ``STATS.timed`` on, time it between two synchronizations."""

    def __init__(self, op: str, nbytes: int, g: RankGroup):
        self.op = f"{op}@{g.axis}" if g.axis else op
        self.nbytes, self.device = nbytes, g.device

    def __enter__(self):
        self.on = STATS.counting
        if not self.on:
            return
        STATS.calls[self.op] = STATS.calls.get(self.op, 0) + 1
        STATS.nbytes[self.op] = STATS.nbytes.get(self.op, 0) + self.nbytes
        if STATS.timed:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.on and STATS.timed and exc[0] is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            STATS.seconds[self.op] = (STATS.seconds.get(self.op, 0.0)
                                      + time.perf_counter() - self.t0)


def _staged(g: RankGroup) -> bool:
    """True on a shared card: gloo's sends and receives take host memory
    only."""
    return g.backend == "gloo" and g.device.type == "cuda"


def _p2p(x: torch.Tensor, g: RankGroup, dst: Optional[int],
         src: Optional[int]) -> torch.Tensor:
    """Send ``x`` to rank ``dst`` and receive a tensor of its shape from
    rank ``src`` (zeros where ``src`` is None) in one
    ``batch_isend_irecv``.  The shared-card transport stages both
    through pinned host memory."""
    x = x.contiguous()
    staged = _staged(g)
    if staged:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        send = host.copy_(x)
        recv = torch.empty_like(host, pin_memory=True)
    else:
        send, recv = x, torch.empty_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send, g.peer(dst), g.pg))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv, g.peer(src), g.pg))
    with _counted("ppermute", x.numel() * x.element_size() * (
            dst is not None), g):
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    if src is None:
        return torch.zeros_like(x)
    return recv.to(x.device, non_blocking=True) if staged else recv


def _all_gather(x: torch.Tensor, g: RankGroup, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(g.world)]
    with _counted("all_gather", x.numel() * x.element_size(), g):
        dist.all_gather(parts, x, group=g.pg)
    return torch.cat(parts, dim)


#: the reductions of :func:`all_reduce_`: (torch's op, the name counted)
_REDUCE = {"sum": (dist.ReduceOp.SUM, "psum"),
           "max": (dist.ReduceOp.MAX, "pmax")}


def all_reduce_(x: torch.Tensor, g: RankGroup, op: str = "sum"):
    """Reduce the contiguous ``x`` over every rank of ``g`` in place
    (``op`` ``"sum"`` or ``"max"``) and return it, counted as a psum or
    a pmax.  No gradient: for values autograd does not follow (a token
    count, the loss reported, the gradients summed over the data axis, a
    norm's or a scale's partial values).  Inside a forward use
    :func:`psum`, :func:`pmax` or :func:`reduce_from`."""
    if not x.is_contiguous():
        raise ValueError("all_reduce_ reduces a contiguous tensor in place")
    rop, name = _REDUCE[op]
    with _counted(name, x.numel() * x.element_size(), g):
        dist.all_reduce(x, op=rop, group=g.pg)
    return x


def _all_reduce(x: torch.Tensor, g: RankGroup, op: str) -> torch.Tensor:
    return all_reduce_(x.contiguous().clone(), g, op)


def _slice(x: torch.Tensor, g: RankGroup, dim: int) -> torch.Tensor:
    return torch.chunk(x, g.world, dim)[g.rank].contiguous()


# ---------------------------------------------------------------------------
# the collectives, as autograd Functions
# ---------------------------------------------------------------------------

def _shift_peers(g: RankGroup, shift: int, cyclic: bool):
    """(dst, src) of a shift by ``shift`` ranks; None past an edge of an
    open shift."""
    dst, src = g.rank + shift, g.rank - shift
    if cyclic:
        return dst % g.world, src % g.world
    return (dst if 0 <= dst < g.world else None,
            src if 0 <= src < g.world else None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, shift, cyclic):
        ctx.g, ctx.shift, ctx.cyclic = g, shift, cyclic
        return _p2p(x, g, *_shift_peers(g, shift, cyclic))

    @staticmethod
    def backward(ctx, gy):
        return (_p2p(gy, ctx.g, *_shift_peers(ctx.g, -ctx.shift,
                                              ctx.cyclic)), None, None, None)


def ppermute(x: torch.Tensor, g: RankGroup, shift: int = 1,
             cyclic: bool = False) -> torch.Tensor:
    """Rank r receives rank r - shift's ``x``.  An open shift
    (``cyclic=False``, the SP halo) gives the edge ranks zeros, a cyclic
    one is the pipeline's ring.  Backward: the opposite shift."""
    return _PPermute.apply(x, g, shift, cyclic)


def ppermute_right(x, g: RankGroup):
    """Rank r receives rank r-1's ``x``; rank 0 receives zeros."""
    return ppermute(x, g, 1)


def ppermute_left(x, g: RankGroup):
    """Rank r receives rank r+1's ``x``; the last rank receives zeros."""
    return ppermute(x, g, -1)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim, grad):
        ctx.g, ctx.dim, ctx.grad = g, dim, grad
        return _all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        if ctx.grad == "sum":           # rule 3: a reduce-scatter
            gy = _all_reduce(gy, ctx.g, "sum")
        return _slice(gy, ctx.g, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, g: RankGroup, dim: int,
               grad: str) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order.
    ``grad`` says what the ranks do with the result (module docstring):
    ``"slice"`` for replicated use (rule 2: the backward keeps rank r's
    slice), ``"sum"`` where each rank uses it for its own rows (rule 3:
    the backward sums over ranks, then keeps rank r's slice)."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad is 'slice' or 'sum', not {grad!r}")
    return _AllGather.apply(x, g, dim, grad)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _slice(x, g, dim)

    @staticmethod
    def backward(ctx, gy):                # rule 1
        return _all_gather(gy, ctx.g, ctx.dim), None, None


def scatter(x: torch.Tensor, g: RankGroup, dim: int) -> torch.Tensor:
    """Rank r's slice (one of ``world`` equal chunks along ``dim``,
    contiguous) of a replicated ``x``.  Backward: an all-gather (rule
    1)."""
    return _Scatter.apply(x, g, dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_reduce(x, g, "sum")

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce(gy, ctx.g, "sum"), None


def psum(x: torch.Tensor, g: RankGroup) -> torch.Tensor:
    """The sum of every rank's ``x``, on every rank.  Backward: a psum
    of the ranks' gradients (each holds the gradient of its own use)."""
    return _PSum.apply(x, g)


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        out = _all_reduce(x, g, "max")
        ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, gy):
        raise RuntimeError("pmax has no gradient (nor has jax.lax.pmax)")


def pmax(x: torch.Tensor, g: RankGroup) -> torch.Tensor:
    """The elementwise max over every rank's ``x``, on every rank; not
    differentiable (the decode merge's shift)."""
    return _PMax.apply(x, g)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce(gy, ctx.g, "sum"), None


def copy_to(x: torch.Tensor, g: RankGroup) -> torch.Tensor:
    """``x`` as it is, where a value every rank of ``g`` holds enters
    work split over the group (a column-parallel product, a replicated
    weight used for this rank's heads only).  Backward: a psum, as each
    rank holds the gradient of its own part of the work."""
    return _CopyTo.apply(x, g)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g, "sum")

    @staticmethod
    def backward(ctx, gy):
        return gy, None


def reduce_from(x: torch.Tensor, g: RankGroup) -> torch.Tensor:
    """The sum of every rank's partial ``x`` (a row-parallel product's
    output, a sharded vocabulary's exp sum), on every rank.  Backward:
    the upstream gradient as it is, which every rank already holds
    whole."""
    return _ReduceFrom.apply(x, g)
