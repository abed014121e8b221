"""Training loop: train step factory, gradient accumulation, gradient
compression hook, checkpoint/restart, watchdog.

Port of ``repro.train.loop`` for one card.  ``make_train_step`` returns
``train_step(state, batch) -> (state, metrics)``, which consumes its
input state as the reference's donated step does: gradients come from
``torch.autograd.grad`` of the model's loss (the band kernels carry
their own backward), the optimizer's in-place update
(``Optimizer.update_``) writes the parameters and moments in place, and
the step counters live on the device.  ``train`` runs the single-host loop; with a ``mesh`` of more
than one shard each step runs inside ``sp_scope(mesh)``, so every
attention call shards its sequence axis (sequence-parallel training, the
reference's ``sp_step``).  With telemetry on (``repro_torch.obs``) each
step is a ``train.step`` span (args ``step``) that ends when its loss is
read, and feeds ``train.steps``, ``train.step_s`` and ``train.loss``; a
watchdog alarm counts ``train.watchdog_alarms``.  The sharded multi-pod
path is not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import obs, resolve_device
from ..models import ModelConfig, get_model
from ..optim import (Optimizer, adafactor, adamw, cosine_schedule,
                     init_error_feedback, int8_compress)
from ..parallel.sp_attention import sp_scope
from ..tree import tree_leaves, tree_map, tree_unflatten_like


class TrainState(NamedTuple):
    step: torch.Tensor        # int32 scalar on the parameters' device
    params: Any
    opt_state: Any
    ef_state: Optional[Any]   # error-feedback residual (grad compression)


@dataclasses.dataclass
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 200
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    optimizer: str = "adamw"          # adamw | adafactor
    grad_accum: int = 1
    compress_grads: str = "none"      # none | int8 | topk
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 500
    log_every: int = 10
    seed: int = 0
    watchdog_factor: float = 3.0      # straggler alarm threshold
    attn_causal_mode: Optional[str] = None  # fine-q | coarse-q


def resolve_model_config(cfg: ModelConfig, tc: TrainConfig) -> ModelConfig:
    """Apply the TrainConfig's causal-mode override to ``cfg``."""
    if tc.attn_causal_mode is None:
        return cfg
    return dataclasses.replace(cfg, causal_mode=tc.attn_causal_mode)


def make_optimizer(tc: TrainConfig) -> Optimizer:
    sched = cosine_schedule(tc.peak_lr, tc.warmup, tc.total_steps)
    if tc.optimizer == "adafactor":
        return adafactor(sched)
    return adamw(sched, weight_decay=tc.weight_decay,
                 clip_norm=tc.clip_norm)


def init_state(cfg: ModelConfig, tc: TrainConfig, *,
               seed: Optional[int] = None, device=None) -> TrainState:
    """Fresh state: parameters drawn from ``seed`` (default ``tc.seed``)
    with explicit ``torch.Generator``s on the CPU, then moved to
    ``device`` (default ``cuda``)."""
    cfg = resolve_model_config(cfg, tc)
    params = get_model(cfg).init(cfg, seed=tc.seed if seed is None else seed,
                                 device=device)
    ef = (init_error_feedback(params)
          if tc.compress_grads != "none" else None)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return TrainState(step, params, make_optimizer(tc).init(params), ef)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    The step consumes ``state``, as the reference's donated jit
    (``donate_argnums=(0,)``) does: the returned state holds the same
    parameter and moment tensors, updated in place, so a caller that
    reads the old state after a step must clone it first.  Each leaf's
    update gives the bits of the functional ``update`` then
    ``apply_updates``.

    Gradient accumulation splits the leading batch dim into
    ``tc.grad_accum`` microbatches and takes the mean of their gradients
    and losses (the reference's scan); the other metrics are the last
    microbatch's.  ``compress_grads='topk'`` raises: the step applies
    only int8 compression so far."""
    if tc.compress_grads == "topk":
        raise NotImplementedError("compress_grads='topk' is not applied by "
                                  "the train step yet; use 'int8' or 'none'")
    cfg = resolve_model_config(cfg, tc)
    fns = get_model(cfg)
    opt = make_optimizer(tc)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = fns.loss(tree_unflatten_like(params, leaves), cfg,
                                 batch)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten_like(params,
                                                           list(grads))

    def train_step(state: TrainState, batch):
        if tc.grad_accum > 1:
            n = tc.grad_accum
            micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            lsum = 0.0
            for i in range(n):
                loss, metrics, g = value_and_grad(
                    state.params, {k: v[i] for k, v in micro.items()})
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b)
                del g
                lsum = lsum + loss
            for a in tree_leaves(grads):
                a.div_(n)
            loss = lsum / n
        else:
            loss, metrics, grads = value_and_grad(state.params, batch)

        ef = state.ef_state
        if tc.compress_grads == "int8":
            grads, ef = int8_compress(grads, ef)

        opt_state = opt.update_(grads, state.opt_state, state.params)
        del grads
        metrics = dict(metrics)
        metrics["loss"] = loss
        return TrainState(state.step + 1, state.params, opt_state,
                          ef), metrics

    return train_step


def tokens_per_s(history, tokens_per_step: int) -> Optional[float]:
    """Training rate of a ``train`` history: the tokens of every step
    after the first over the wall time from the first step's end to the
    last's (data, logging and stalls included; the first step, which
    builds kernels and warms the allocator, stands apart).  None with
    fewer than two steps."""
    if len(history) < 2:
        return None
    return (tokens_per_step * (len(history) - 1)
            / (history[-1]["end_s"] - history[0]["end_s"]))


class Watchdog:
    """Step-time straggler detector: EMA of step latency; flags (and
    counts) steps slower than ``factor`` x the EMA."""

    def __init__(self, factor: float = 3.0):
        self.factor = factor
        self.ema: Optional[float] = None
        self.alarms = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.alarms += int(slow)
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        return slow


def train(cfg: ModelConfig, tc: TrainConfig, data_source, num_steps: int,
          *, state: Optional[TrainState] = None, device=None, mesh=None,
          log=print):
    """Single-host training with checkpoint/restart on ``device`` (default
    ``cuda``; raises without a card).  ``mesh`` (an ``SPMesh``,
    ``launch.mesh.make_mesh((d,), ("data",))``) runs every step inside
    ``sp_scope(mesh)``: the forward and backward of each attention call
    shard its sequence over the mesh's ``d`` shards; ``None`` or a 1-way
    mesh trains unsharded.  Returns (state, metrics): the last
    step's metrics plus ``history``, one ``{"step", "loss", "aux",
    "step_ms", "end_s"}`` per step run: the loss and its MoE aux part as
    numbers, the host time of the step, ending when its loss is read,
    and that end on the ``time.perf_counter`` clock; on a
    card also ``peak_mem_gib``, the most device memory allocated during
    the steps (``torch.cuda.max_memory_allocated``, reset as they
    start)."""
    from . import checkpoint as ckpt

    dev = resolve_device(device)
    if state is None:
        state = init_state(cfg, tc, device=dev)
        start = ckpt.latest_step(tc.ckpt_dir)
        if start is not None:
            state = ckpt.restore(tc.ckpt_dir, start, state)
            log(f"[restart] resumed from step {start}")
    step0 = int(state.step)
    train_step = make_train_step(cfg, tc)
    saver = ckpt.AsyncCheckpointer(tc.ckpt_dir)
    wd = Watchdog(tc.watchdog_factor)
    metrics: Dict[str, Any] = {}
    history = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for step in range(step0, num_steps):
        batch = batch_to_device(data_source.batch(step), dev)
        t0 = time.perf_counter()
        with obs.span("train.step", tid=obs.TRACK_TRAIN,
                      args={"step": step}):
            with sp_scope(mesh):
                state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])      # waits for the device
        end = time.perf_counter()
        dt = end - t0
        if obs.enabled():
            obs.counter("train.steps").inc()
            obs.histogram("train.step_s").observe(dt)
            obs.gauge("train.loss").set(loss)
        aux = float(metrics.get("aux", 0.0))
        history.append({"step": step, "loss": loss, "aux": aux,
                        "step_ms": dt * 1e3, "end_s": end})
        if wd.observe(dt):
            obs.counter("train.watchdog_alarms").inc()
            log(f"[watchdog] step {step} took {dt:.3f}s "
                f"(ema {wd.ema:.3f}s) -- straggler suspected")
        if step % tc.log_every == 0:
            log(f"step {step}: loss={loss:.4f}"
                + (f" aux={aux:.6f}" if aux else "")
                + f" ({dt*1e3:.1f} ms)")
        if tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
            saver.save(step + 1, state)
    saver.wait()
    out = dict(metrics, history=history)
    if dev.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return state, out
