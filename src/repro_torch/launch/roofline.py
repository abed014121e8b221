"""Roofline analysis per (arch x shape) on the single-pod production mesh.

Port of ``repro.launch.roofline``.  The reference reads XLA's
``cost_analysis()`` of each compiled cell.  The port runs the cell's
function (``dryrun.build_cell``) on meta tensors -- nothing computed,
nothing allocated -- and counts what it would do:

* FLOPs: the matrix products' (``torch.utils.flop_counter.
  FlopCounterMode``) plus every kernel launch's, read from its launch
  record (``analysis.contracts.capture``) by ``obs.traffic`` (all rows:
  every row and key the band admits by position);
* bytes: every kernel launch's HBM bytes from the same records, plus,
  for every other aten op, the bytes of its tensor inputs and outputs
  (:class:`ByteCounter`; views and allocations move nothing and count
  nothing) -- the counterpart of XLA's "bytes accessed".

As in the reference, each cell is counted at depths u and 2u -- u the
arch's cadence unit (1 for homogeneous stacks, 6 for gemma3 / zamba2)
-- and extrapolated::

    total(L) = c(u) + (L/u - 1) * (c(2u) - c(u))

which is exact for homogeneous and periodic stacks.  Per-card terms
assume the cell's work splits evenly over the mesh's cards (no
compiler partitions the program, so nothing shows where it would not):

    compute_s = flops / cards / PEAK_FLOPS_BF16
    memory_s  = bytes / cards / HBM_BW

with the H100 datasheet figures of ``launch.mesh``.  ``collective_s`` is
``null`` with its reason: no compiler partitions the program into
collectives (the NCCL runner, ROADMAP A.14, will measure them).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.roofline [--arch A] \\
        [--shape S] [--summary]

Artifacts: ``artifacts/torch_roofline/<arch>__<shape>.json`` (+ the
summary table).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import contracts
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.seamless_m4t_medium import DECODER_LEN
from repro_torch.launch import specs as S
from repro_torch.launch.dryrun import build_cell
from repro_torch.launch.mesh import (CARD, HBM_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.obs import traffic
from repro_torch.tree import tree_flatten_with_paths

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../artifacts/torch_roofline")

NO_COLLECTIVE = ("no compiler partitions the port's program into "
                 "collectives; the multi-process NCCL runner (ROADMAP "
                 "A.14) will measure their wire bytes")

_aten = torch.ops.aten
#: allocations: they move no bytes
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default}


def _moves_nothing(func) -> bool:
    """A view (every output aliases an input, none written) or an
    allocation."""
    if func in _FREE:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class ByteCounter(TorchDispatchMode):
    """Sums, over every aten op that moves data, the bytes of its tensor
    inputs and outputs (``.bytes``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _moves_nothing(func):
            ins, _ = tree_flatten((args, kwargs or {}))
            outs, _ = tree_flatten(out)
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out


class Count:
    """What one run counts: ``with Count() as c: fn(*args)``, then
    ``c.totals()``.  Works on any device: on the card the kernels'
    records come from their launches."""

    def __enter__(self):
        self._cap = contracts.capture()
        self.records = self._cap.__enter__()
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        self._bytes = ByteCounter()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self._cap.__exit__(*exc)

    def totals(self) -> dict:
        kf = sum(traffic.record_flops(r) for r in self.records)
        kb = sum(sum(traffic.record_hbm_bytes(r).values())
                 for r in self.records)
        mf = self._flops.get_total_flops()
        return {"flops": float(mf + kf), "bytes": float(self._bytes.bytes
                                                         + kb),
                "matmul_flops": float(mf), "kernel_flops": float(kf),
                "kernel_bytes": float(kb),
                "kernel_launches": float(len(self.records))}


_KEYS = ("flops", "bytes", "matmul_flops", "kernel_flops", "kernel_bytes",
         "kernel_launches")


def cadence_unit(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.hybrid_attn_every
    if cfg.global_every > 0:
        return cfg.global_every
    return 1


def _depth_cfg(cfg, layers: int):
    kw = dict(num_layers=layers, force_loop=True)
    if cfg.family == "encdec":
        kw["encoder_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def count_cell(cfg, shape, mesh) -> dict:
    """The counts of one run of the cell's function on meta tensors."""
    fn, args, _ = build_cell(cfg, shape, mesh)
    with Count() as c:
        fn(*args)
    return c.totals()


def _measure(cfg, shape, mesh) -> dict:
    """The cell's whole-model counts, extrapolated from depths u and 2u
    (the module docstring), with the per-layer-unit difference."""
    u = cadence_unit(cfg)
    c1 = count_cell(_depth_cfg(cfg, u), shape, mesh)
    c2 = count_cell(_depth_cfg(cfg, 2 * u), shape, mesh)
    reps = cfg.num_layers / u - 1.0
    tot = {k: c1[k] + reps * (c2[k] - c1[k]) for k in _KEYS}
    return {"total": tot, "per_layer_unit": {k: c2[k] - c1[k]
                                             for k in _KEYS}}


def param_count(cfg):
    """(total, active): every parameter, and those a token uses (a MoE's
    experts counted at top_k / experts)."""
    total = active = 0
    for path, leaf in tree_flatten_with_paths(S.param_struct(cfg)):
        n = leaf.numel()
        total += n
        if cfg.moe_experts and any(w in "/" + path for w in
                                   ("/moe/w1", "/moe/w2", "/moe/w3")):
            active += n * cfg.moe_top_k / cfg.moe_experts
        else:
            active += n
    return total, active


def _encdec_split(cfg):
    """(encoder parameters, the rest)."""
    enc = dec = 0
    for path, leaf in tree_flatten_with_paths(S.param_struct(cfg)):
        if path.startswith("encoder"):
            enc += leaf.numel()
        else:
            dec += leaf.numel()
    return enc, dec


def model_flops(cfg, shape):
    """6*N*D train / 2*N*D prefill / 2*N per decode token (active
    parameters for MoE; encoder and decoder by the tokens each stack
    processes)."""
    kind, seq, batch = S.cell(cfg, shape)
    total, active = param_count(cfg)
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[kind]
    if cfg.family == "encdec":
        enc, dec = _encdec_split(cfg)
        dec_tokens = batch * (min(DECODER_LEN, seq) if kind != "decode"
                              else 1)
        enc_tokens = batch * seq if kind != "decode" else 0
        enc_mult = 2.0 if kind == "prefill" else (6.0 if kind == "train"
                                                  else 2.0)
        return enc_mult * enc * enc_tokens + mult * dec * dec_tokens
    if kind == "train":
        return 6.0 * active * batch * seq
    if kind == "prefill":
        return 2.0 * active * batch * seq
    return 2.0 * active * batch          # one token per sequence


def analyze_cell(arch: str, shape_name: str, cfg=None, mesh=None,
                 out_dir: Optional[str] = None, log=print):
    """One cell's record (the module docstring), written to ``out_dir``;
    ``mesh`` defaults to the single-pod production mesh."""
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    mesh = mesh or make_production_mesh(multi_pod=False)
    if cfg is None:
        cfg = get_config(arch)
    u = cadence_unit(cfg)
    rec = {"arch": arch, "shape": shape_name, "ok": False,
           "unit": u, "num_layers": cfg.num_layers, "cards": mesh.size,
           "card": CARD}
    t0 = time.time()
    try:
        m = _measure(cfg, shape_name, mesh)
        glob = m["total"]
        per = {k: glob[k] / mesh.size for k in ("flops", "bytes")}
        terms = {"compute_s": per["flops"] / PEAK_FLOPS_BF16,
                 "memory_s": per["bytes"] / HBM_BW,
                 "collective_s": None}
        dom = max(("compute_s", "memory_s"), key=terms.get)
        mf = model_flops(cfg, shape_name)
        top = max(terms["compute_s"], terms["memory_s"])
        rec.update({
            "global": glob,
            "per_device": per,
            "per_layer_unit": m["per_layer_unit"],
            "terms_s": terms,
            "collective_reason": NO_COLLECTIVE,
            "dominant": dom,
            "model_flops_global": mf,
            "counted_flops_global": glob["flops"],
            "useful_ratio": mf / glob["flops"] if glob["flops"] else 0.0,
            "roofline_fraction": terms["compute_s"] / top if top else 0.0,
            "seconds": time.time() - t0,
            "ok": True,
        })
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["seconds"] = time.time() - t0
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if log is not None:
        if rec["ok"]:
            t = rec["terms_s"]
            log(f"[roofline] {arch}__{shape_name}: OK "
                f"compute={t['compute_s'] * 1e3:.2f}ms "
                f"memory={t['memory_s'] * 1e3:.2f}ms "
                f"dom={rec['dominant']} useful={rec['useful_ratio']:.2f} "
                f"({rec['seconds']:.0f}s)")
        else:
            log(f"[roofline] {arch}__{shape_name}: FAIL {rec['error']}")
    return rec


def summarize(out_path=None, out_dir: Optional[str] = None) -> str:
    out_dir = out_dir or ARTIFACT_DIR
    rows = []
    for fname in sorted(os.listdir(out_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(out_dir, fname)) as f:
            r = json.load(f)
        if r.get("ok"):
            t = r["terms_s"]
            rows.append((r["arch"], r["shape"], t["compute_s"],
                         t["memory_s"], r["dominant"], r["useful_ratio"]))
    lines = [f"per card of {CARD}, the work split evenly; no collective "
             "term (" + NO_COLLECTIVE + ")",
             "| arch | shape | compute (ms) | memory (ms) | collective (ms)"
             " | dominant | useful ratio |",
             "|---|---|---|---|---|---|---|"]
    for a, s, c, m, d, u in rows:
        lines.append(f"| {a} | {s} | {c * 1e3:.2f} | {m * 1e3:.2f} | "
                     f"null | {d.replace('_s', '')} | {u:.2f} |")
    table = "\n".join(lines)
    if out_path:
        with open(out_path, "w") as f:
            f.write(table + "\n")
    return table


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--summary", action="store_true")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.summary:
        print(summarize())
        return
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    fails = 0
    for arch in archs:
        for shape in shapes:
            path = os.path.join(ARTIFACT_DIR, f"{arch}__{shape}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        continue
            fails += not analyze_cell(arch, shape)["ok"]
    print(summarize())
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
