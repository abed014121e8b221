"""Feed-forward layers: gated MLP (SwiGLU / GeGLU) and mixture of experts.

Port of ``repro.models.ffn``: separate gate ``wg``, up ``wu`` and down
``wd`` projections; the MoE routes each token to its top-k of ``E``
experts with a fixed per-sequence capacity ``C``, the reference's
sort-based dispatch:

  1. softmax gates in f32, top-k (ties to the lower expert, as
     ``jax.lax.top_k``), renormalised;
  2. per sequence, the (S*k) assignments stably sorted by expert, each
     one's rank within its expert from the sorted run's starts, those
     ranked past ``C`` dropped (their weight is not renormalised);
  3. the kept tokens gathered into a (B, E, C, d) buffer, the experts run
     as batched products over E, each token's k slots gathered back and
     summed in f32 in a fixed order.

Every step is a sort, a gather or a scatter onto distinct positions,
so two runs on the same inputs give the same bits (a remat recompute
gives the forward's); the dispatch's backward sums each token's k slots
in a fixed order (:class:`_Dispatch`) rather than adding them with
atomics, so its gradient does too.  Shared-expert (qwen2-moe) and dense-residual (arctic)
branches run beside the routed experts.  The routed part runs inside a
``torch.profiler`` range named ``moe``.
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from .common import ModelConfig, activation, dense, dense_init


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32):
    return {"wg": dense_init(gen, d, d_ff, dtype=dtype),
            "wu": dense_init(gen, d, d_ff, dtype=dtype),
            "wd": dense_init(gen, d_ff, d, dtype=dtype)}


def mlp(p, x: torch.Tensor, act_name: str) -> torch.Tensor:
    act = activation(act_name)
    return dense(p["wd"], act(dense(p["wg"], x)) * dense(p["wu"], x))


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    """The reference's leaves and scales: ``router`` (d, E) always f32,
    ``w1`` / ``w3`` (E, d, ff) and ``w2`` (E, ff, d) in ``dtype``; with
    ``moe_shared_d_ff`` a gated MLP ``shared`` and its zero gate
    ``shared_gate`` (d, 1); with ``moe_dense_residual`` a gated MLP
    ``residual`` of ``d_ff``."""
    E, d, ff = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff

    def randn(shape, dt, scale):
        return torch.randn(shape, generator=gen, dtype=dt) * scale
    sc = 1.0 / math.sqrt(d)
    p = {"router": randn((d, E), torch.float32, sc),
         "w1": randn((E, d, ff), dtype, sc),
         "w3": randn((E, d, ff), dtype, sc),
         "w2": randn((E, ff, d), dtype, 1.0 / math.sqrt(ff))}
    if cfg.moe_shared_d_ff:
        p["shared"] = mlp_init(gen, d, cfg.moe_shared_d_ff, dtype)
        p["shared_gate"] = torch.zeros((d, 1), dtype=dtype)
    if cfg.moe_dense_residual:
        p["residual"] = mlp_init(gen, d, cfg.d_ff, dtype)
    return p


def moe_capacity(cfg: ModelConfig, S: int) -> int:
    """Slots an expert holds per sequence of length ``S`` (the length of
    this call: a decode tick has S = 1, a bucketed prefill the bucket's)."""
    return max(1, int(math.ceil(S * cfg.moe_top_k / cfg.moe_experts
                                * cfg.moe_capacity_factor)))


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest gates on the last axis, an
    exact tie going to the lower index, as ``jax.lax.top_k`` breaks it:
    a stable sort of the negated gates."""
    idx = torch.argsort(-gates, dim=-1, stable=True)[..., :k]
    return torch.gather(gates, -1, idx), idx


def route(p, cfg: ModelConfig, x: torch.Tensor):
    """The reference's ``_route``.  x (B, S, d) -> (top_w (B, S, k) f32,
    top_i (B, S, k) int64, rank (B, S, k) int64: each assignment's place
    in its expert's queue, aux, C): the softmax gates of the f32 router
    logits, their top k, then :func:`assign`."""
    gates = torch.softmax(x.float() @ p["router"], dim=-1)     # (B, S, E)
    return assign(cfg, gates, top_k(gates, cfg.moe_top_k)[1])


def assign(cfg: ModelConfig, gates: torch.Tensor, top_i: torch.Tensor):
    """The routing of ``gates`` (B, S, E) to the experts ``top_i`` (B, S,
    k): their gates renormalised by ``max(sum, 1e-9)``, each assignment's
    rank in its expert's queue, the Switch load-balancing loss
    ``moe_aux_loss * E * sum_e f_e P_e`` (P_e the mean gate over all B*S
    positions, f_e the share of assignments, a count with no gradient)
    and the capacity C of the call's length.  Returns (top_w, top_i,
    rank, aux, C)."""
    B, S, E = gates.shape
    k = top_i.shape[-1]
    C = moe_capacity(cfg, S)
    top_w = torch.gather(gates, -1, top_i)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    pe = gates.mean(dim=(0, 1))
    fe = torch.bincount(top_i.reshape(-1), minlength=E).float() / (B * S * k)
    aux = cfg.moe_aux_loss * E * torch.sum(fe * pe)
    # per sequence: sort the S*k assignments by expert (stable, so within
    # an expert tokens rank in sequence order and a bucket's pad tail
    # never displaces a real token), then rank = place - run start
    e_flat = top_i.reshape(B, S * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    es = torch.gather(e_flat, 1, order)
    starts = torch.searchsorted(
        es, torch.arange(E, device=gates.device).expand(B, E).contiguous())
    place = torch.arange(S * k, device=gates.device).expand(B, S * k)
    rank = torch.empty_like(order).scatter_(
        1, order, place - torch.gather(starts, 1, es))
    return top_w, top_i, rank.reshape(B, S, k), aux, C


def _experts(p, buf: torch.Tensor, act_name: str) -> torch.Tensor:
    """buf (E, N, d) -> (E, N, d): every expert's gated MLP on its rows,
    batched products over E."""
    act = activation(act_name)
    h = act(torch.bmm(buf, p["w1"].to(buf.dtype)))
    h = h * torch.bmm(buf, p["w3"].to(buf.dtype))
    return torch.bmm(h, p["w2"].to(buf.dtype))


class _Dispatch(torch.autograd.Function):
    """buf (B, E*C, d): row ``j`` is token ``src[:, j]`` of x (B, S, d),
    or zeros where ``src`` is S (a free slot).  The backward gathers the
    gradient of each token's k slots (``slot`` (B, S, k), those ``keep``
    marks) and sums them in f32 in a fixed order: a gather's own
    backward would add them with atomics, in a racing order, and round
    a bf16 gradient differently from one run to the next."""

    @staticmethod
    def forward(ctx, x, src, slot, keep):
        B, S, d = x.shape
        xz = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
        ctx.save_for_backward(slot, keep)
        return torch.gather(xz, 1, src[:, :, None].expand(B, -1, d))

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        B, S, k = slot.shape
        d = g.shape[-1]
        gk = torch.gather(g, 1, slot.reshape(B, S * k, 1).expand(B, -1, d))
        gx = (gk.reshape(B, S, k, d).float() * keep[..., None]).sum(dim=2)
        return gx.to(g.dtype), None, None, None


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, act_name: str = "swiglu"):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux): the reference's
    ``moe_apply`` (and its ``_moe_apply_scatter`` oracle)."""
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    with record_function("moe"):
        top_w, top_i, rank, aux, C = route(p, cfg, x)
        keep = rank < C
        slot = top_i * C + torch.clamp(rank, max=C - 1)          # (B, S, k)
        # each kept slot's source token; a free slot reads the zero row S
        tok = torch.arange(S, device=x.device)[None, :, None].expand(B, S, k)
        src = torch.full((B, E * C + 1), S, dtype=torch.long,
                         device=x.device)
        src.scatter_(1, torch.where(keep, slot, E * C).reshape(B, S * k),
                     tok.reshape(B, S * k))      # column E*C: the dropped
        buf = _Dispatch.apply(x, src[:, :E * C], slot, keep)
        buf = buf.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
        y = _experts(p, buf, act_name)
        y = y.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
        yk = torch.gather(y, 1, slot.reshape(B, S * k, 1).expand(B, S * k, d))
        wk = (top_w * keep).reshape(B, S, k, 1)
        out = (yk.reshape(B, S, k, d).float() * wk).sum(dim=2)
    out = out.to(x.dtype)
    if "shared" in p:
        g = torch.sigmoid(x @ p["shared_gate"].to(x.dtype))
        out = out + g * mlp(p["shared"], x, act_name)
    if "residual" in p:
        out = out + mlp(p["residual"], x, act_name)
    return out.to(x.dtype), aux
