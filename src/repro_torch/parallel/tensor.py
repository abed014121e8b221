"""Tensor and data parallelism over a ``DATAxMODEL`` mesh, one shard a
process.

The reference places every parameter by its init's spec
(``param_shardings``) and lets GSPMD partition the train step; it has no
file for what this module does.  The port partitions the step by hand,
in the Megatron style, over the two axis groups of
``parallel.group.axis_groups``:

* ``"model"`` (tensor parallelism): a leaf whose spec puts an output
  axis over ``"model"`` makes a column-parallel product (:func:`column`:
  :func:`~repro_torch.parallel.group.copy_to` on the input, this rank's
  columns); one whose spec puts its input axis there a row-parallel one
  (:func:`row`: this rank's rows, then
  :func:`~repro_torch.parallel.group.reduce_from`).  A leaf that
  ``shard_if_divisible`` left replicated (heads, ``d_ff`` or the vocab
  not divisible by M) runs whole, with no collective.  The helpers read
  each leaf's spec, bound for the step by :func:`bound`, never the
  config alone.  Attention runs on the rank's ``hq / M`` heads
  (``models/attention.py``), the embedding and the tied logits over the
  rank's vocabulary rows, and the cross-entropy over the sharded
  vocabulary (``models/transformer.py``); the full logits are never
  gathered.
* ``"data"`` (data parallelism): data rank d takes its rows of every
  microbatch (:func:`data_rows`), the loss divides by the token count
  summed over the axis (:func:`data_sum`), and the gradients are summed
  over it once a step, after accumulation (:func:`reduce_grads`).

Parameters: ``parallel.sharding.shard_params`` cuts this rank's shards
from the whole tree every rank draws from the seed, ``unshard_params``
gathers them.  Every other family than the dense decoder is refused
under a model axis larger than 1 (:func:`check_family`), before any
weight is drawn.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

from ..models.common import dense
from . import group as grp

MODEL = "model"

#: where the families that tensor parallelism does not cover yet are queued
REFUSAL = ("tensor parallelism over a model axis larger than 1 runs the "
           "dense decoder family only; {what} is queued in ROADMAP A.14")


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A ``(D, M)`` mesh over ``("data", "model")``, one shard a process
    (``launch.mesh.make_mesh`` builds it inside a group of ``D * M``
    ranks): this rank's ``data`` group (its column: the ranks holding the
    same shard of the parameters) and ``model`` group (its row: the ranks
    that split one microbatch's work), each None on an axis of size 1,
    and its device.  The 1x1 mesh needs no group."""
    shape: Tuple[int, int]
    device: torch.device
    data: Optional[grp.RankGroup] = None
    model: Optional[grp.RankGroup] = None

    @property
    def D(self) -> int:
        return self.shape[0]

    @property
    def M(self) -> int:
        return self.shape[1]

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (data index, model index)."""
        return (self.data.rank if self.data else 0,
                self.model.rank if self.model else 0)

    @property
    def lead(self) -> bool:
        """True on global rank 0 (the rank that writes checkpoints)."""
        return self.coords == (0, 0)


def check_family(cfg, M: int) -> None:
    """Refuse a config that tensor parallelism over ``M > 1`` does not
    cover: every family but ``dense`` (MoE experts over ``"model"``, SSM,
    hybrid, the encoder-decoder, the VLM's patch prefix)."""
    if M <= 1:
        return
    what = None
    if cfg.family != "dense" or cfg.moe_experts:
        what = f"family={cfg.family!r} ({cfg.name})"
    elif cfg.prefix_len:
        what = f"a patch-embedding prefix ({cfg.name})"
    if what is not None:
        raise NotImplementedError(REFUSAL.format(what=what))


# ---------------------------------------------------------------------------
# the scope: the active mesh and each leaf's spec
# ---------------------------------------------------------------------------

# A module global, not a thread-local: autograd runs a CUDA backward (and
# a remat's recompute) on its own thread.
_mesh: Optional[RankMesh] = None
_specs: Dict[int, tuple] = {}


@contextmanager
def tp_scope(mesh: Optional[RankMesh]):
    """Run the model's forward and backward on this rank's shards of
    ``mesh`` (as ``sp_scope`` runs them on sequence shards).  A ``None``
    mesh is a no-op, so callers can wrap unconditionally."""
    global _mesh
    prev = _mesh
    _mesh = mesh
    try:
        yield
    finally:
        _mesh = prev


def model_group() -> Optional[grp.RankGroup]:
    """The active mesh's model group, None without a model axis > 1."""
    return _mesh.model if _mesh is not None else None


def data_group() -> Optional[grp.RankGroup]:
    return _mesh.data if _mesh is not None else None


@contextmanager
def bound(leaves: List[torch.Tensor], specs: List[tuple]):
    """Bind each of ``leaves`` (a step's parameter tensors) to its spec
    for the helpers below, while the step's forward and backward run."""
    keys = [id(t) for t in leaves]
    _specs.update(zip(keys, specs))
    try:
        yield
    finally:
        for k in keys:
            _specs.pop(k, None)


def sharded(w: torch.Tensor, dim: int) -> bool:
    """Whether dimension ``dim`` of the parameter ``w`` is split over the
    active model axis.  Without a model axis nothing is; with one, a
    leaf bound to no spec raises."""
    if model_group() is None:
        return False
    try:
        spec = _specs[id(w)]
    except KeyError:
        raise RuntimeError("a parameter without a spec inside a tensor-"
                           "parallel step: bind the step's leaves "
                           "(tensor.bound)") from None
    return dim < len(spec) and spec[dim] == MODEL


# ---------------------------------------------------------------------------
# the products
# ---------------------------------------------------------------------------

def copy_to(x: torch.Tensor) -> torch.Tensor:
    g = model_group()
    return x if g is None else grp.copy_to(x, g)


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    g = model_group()
    return x if g is None else grp.reduce_from(x, g)


def column(x: torch.Tensor, *ps) -> List[torch.Tensor]:
    """``dense(p, x)`` for each projection ``p`` of ``ps`` that reads
    ``x``: a column-parallel leaf (its output axis over ``"model"``)
    gives this rank's output columns, from one :func:`copy_to` of ``x``
    shared by every such product; a replicated leaf the whole output
    from ``x`` itself."""
    col = [sharded(p["w"], 1) for p in ps]
    xc = copy_to(x) if any(col) else x
    return [dense(p, xc if c else x) for p, c in zip(ps, col)]


def row(p, x: torch.Tensor, x_sharded: bool) -> torch.Tensor:
    """``x @ w (+ b)`` for a projection whose input may be split over the
    model axis: a row-parallel leaf takes this rank's slice of the input
    (``x`` itself where ``x_sharded``, else its slice, whose gradient is
    gathered back) and sums the partial products with
    :func:`reduce_from`, the bias added once after; a replicated leaf
    takes the whole input (gathered where ``x_sharded``)."""
    g = model_group()
    if not sharded(p["w"], 0):
        if x_sharded:
            x = grp.all_gather(x, g, -1, grad="slice")
        return dense(p, x)
    if not x_sharded:
        x = grp.scatter(x, g, -1)
    y = reduce_from(dense({"w": p["w"]}, x))
    return y + p["b"].to(y.dtype) if "b" in p else y


def vocab_range(w: torch.Tensor, dim: int) -> Optional[Tuple[int, int]]:
    """[lo, hi) of the vocabulary rows this rank holds of a leaf whose
    ``dim`` is the vocabulary, or None where the leaf is whole."""
    if not sharded(w, dim):
        return None
    n = w.shape[dim]
    lo = model_group().rank * n
    return lo, lo + n


def embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``: over a vocabulary split by rows,
    each rank looks up the tokens it holds (zeros for the others) and the
    rows are summed with :func:`reduce_from`."""
    vr = vocab_range(w, 0)
    if vr is None:
        return w[tokens]
    lo, hi = vr
    mine = (tokens >= lo) & (tokens < hi)
    h = w[torch.where(mine, tokens - lo, 0)]
    return reduce_from(h * mine[..., None].to(h.dtype))


def sharded_xent(lgt: torch.Tensor, tgt: torch.Tensor,
                 lo: int) -> torch.Tensor:
    """``logsumexp(logits) - logits[tgt]`` per position over a vocabulary
    split by the model axis, ``lgt`` this rank's columns from ``lo``: a
    pmax of the detached local maxima, a :func:`reduce_from` of the exp
    sums, and the gold logit by a masked local gather summed the same
    way."""
    g = model_group()
    m = grp.pmax(lgt.detach().amax(-1), g)
    se = reduce_from(torch.exp(lgt - m[..., None]).sum(-1))
    logz = m + torch.log(se)
    idx = tgt - lo
    mine = (idx >= 0) & (idx < lgt.shape[-1])
    gold = torch.gather(lgt, -1, torch.where(mine, idx, 0)[..., None])[..., 0]
    gold = reduce_from(torch.where(mine, gold, 0.0))
    return logz - gold


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------

def data_size() -> int:
    """D, the active data axis' size (1 without one)."""
    g = data_group()
    return 1 if g is None else g.world


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active data axis, with no gradient: the
    token count a loss divides by, the loss reported, a MoE router's
    assignment counts.  ``x`` itself without a data axis."""
    g = data_group()
    if g is None:
        return x
    return grp.all_reduce_(x.detach().contiguous().clone(), g)


def data_rows(batch: dict, mesh: Optional[RankMesh], micro: int) -> dict:
    """Data rank d's rows of a step's batch: of each of its ``micro``
    microbatches, rows ``[d B_m / D, (d + 1) B_m / D)``, so that a
    microbatch on the mesh holds the rows it holds in one process.
    Raises where D does not divide a microbatch."""
    if mesh is None or mesh.D == 1:
        return batch
    D, (d, _) = mesh.D, mesh.coords
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % micro or (B // micro) % D:
            raise ValueError(
                f"a batch of {B} rows in {micro} microbatch(es) does not "
                f"split over {D} data ranks: every microbatch must be a "
                f"multiple of {D}")
        n = B // micro // D
        v = v.reshape((micro, D, n) + tuple(v.shape[1:]))[:, d]
        out[k] = v.reshape((micro * n,) + tuple(v.shape[2:]))
    return out


#: the most entries a bucket of :func:`reduce_grads` holds (64 MiB of f32)
BUCKET_ELEMS = 1 << 24


@torch.no_grad()
def reduce_grads(grads: List[torch.Tensor], mesh: Optional[RankMesh]):
    """Sum the gradient leaves over the data axis in place, in f32: a
    contiguous f32 leaf of at least BUCKET_ELEMS entries by one
    all-reduce of its own, the others concatenated (widened to f32) in
    buckets of at most BUCKET_ELEMS entries (a larger bf16 leaf alone),
    one all-reduce a bucket.  Beside the gradients a rank holds one
    bucket at a time."""
    g = None if mesh is None else mesh.data
    if g is None:
        return
    bucket: List[torch.Tensor] = []

    def flush():
        if not bucket:
            return
        flat = grp.all_reduce_(torch.cat(
            [t.reshape(-1).to(torch.float32) for t in bucket]), g)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        bucket.clear()

    for t in grads:
        if (t.dtype == torch.float32 and t.is_contiguous()
                and t.numel() >= BUCKET_ELEMS):
            grp.all_reduce_(t, g)
            continue
        if sum(b.numel() for b in bucket) + t.numel() > BUCKET_ELEMS:
            flush()
        bucket.append(t)
    flush()


@dataclasses.dataclass(frozen=True)
class LeafShards:
    """Which leaves of a parameter-shaped tree (in ``tree_leaves``
    order) are split over the model group ``group``: what a global norm
    and a whole-leaf int8 scale need."""
    group: grp.RankGroup
    flags: Tuple[bool, ...]

    @staticmethod
    def of(mesh: Optional[RankMesh], specs: List[tuple]):
        """None without a model axis > 1."""
        if mesh is None or mesh.model is None:
            return None
        return LeafShards(mesh.model, tuple(MODEL in s for s in specs))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model group, in place (no gradient)."""
        return grp.all_reduce_(x, self.group)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s elementwise max over the model group, in place."""
        return grp.all_reduce_(x, self.group, "max")
