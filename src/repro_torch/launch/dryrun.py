"""Dry run: every (architecture x input shape) on the production meshes,
on meta tensors, with the bytes each card would hold.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with XLA on fabricated devices and reads the compiler's memory and
cost analyses.  No compiler partitions the port's program: each cell's
function (a train step, a prefill or a decode step) runs once on meta
tensors -- shapes and dtypes, nothing allocated, every kernel wrapper
handing back empty outputs of its kernel's shapes -- and the bytes come
from the meta trees and their shardings (``parallel.sharding``):

* ``memory.arguments``: per card, the bytes of each argument group
  (train: ``step``, ``params``, ``opt_state``, ``batch``; prefill:
  ``params``, ``batch``; decode: ``params``, ``caches``, ``token``,
  ``t``) and their sum ``argument_size_in_bytes``;
* ``memory.output_size_in_bytes``: per card, the outputs under the
  cell's output shardings, and ``output_aliased_bytes``, those of them
  that are argument tensors updated in place (the train step's state,
  the decode caches);
* ``fits``: whether the arguments and the outputs that alias none of
  them fit ``card_memory_bytes``: the card's own
  (``torch.cuda.get_device_properties(0).total_memory``) where one is
  present, else ``launch.mesh.HBM_BYTES``; ``card_memory_source`` says
  which.  Temporaries are not counted, so ``fits`` is a lower bound;
* ``collectives`` and ``temp``: ``null``, each with a ``_reason``: no
  compiler partitions the program into per-card collectives or
  schedules its temporaries; a multi-process NCCL runner will measure
  them.  The reference's ``parse_collectives`` reads XLA's HLO text and
  has no input here.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Artifacts: ``artifacts/torch_dryrun/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.models import ModelConfig, get_model
from repro_torch.parallel.sharding import (Mesh, batch_shardings,
                                           cache_shardings, leaf_shardings,
                                           param_shardings, per_device_bytes,
                                           replicated, tp_size)
from repro_torch.tree import tree_leaves

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../artifacts/torch_dryrun")

#: the most processes the dry run spreads its cells over
JOBS = 8

NO_COLLECTIVES = ("no compiler partitions the port's program into per-card "
                  "collectives; the multi-process NCCL runner (ROADMAP "
                  "A.14) will measure them")
NO_TEMP = ("no compiler schedules the port's temporaries on meta tensors; "
           "the NCCL runner (ROADMAP A.14) will measure peak memory")


def mesh_name(mesh: Mesh) -> str:
    return ("pod" + "x".join(str(n) for n in mesh.axis_sizes))


def cell_args(cfg: ModelConfig, shape, tp: int):
    """Returns (fn, args, groups): the cell's function, its meta
    arguments for TP degree ``tp`` and the name of each argument.
    ``shape`` is a ``SHAPES`` name or ``(seq, batch, kind)``."""
    from repro_torch.train.loop import (TrainConfig, TrainState,
                                        make_optimizer, make_train_step)
    kind, seq, batch = S.cell(cfg, shape)
    fns = get_model(cfg)
    pstruct = S.param_struct(cfg, tp)
    if kind == "train":
        tc = TrainConfig()
        state = TrainState(torch.zeros((), dtype=torch.int32,
                                       device=S.META), pstruct,
                           make_optimizer(tc).init(pstruct), None)
        return (make_train_step(cfg, tc),
                (state, S.train_batch_specs(cfg, seq, batch)),
                ("state", "batch"))
    if kind == "prefill":
        def prefill(p, b):
            return fns.prefill(p, cfg, b, seq)
        return (prefill, (pstruct, S.prefill_batch_specs(cfg, seq, batch)),
                ("params", "batch"))

    def decode(p, c, token, tt):
        return fns.decode_step(p, cfg, c, token, tt)
    return (decode, (pstruct, *S.decode_arg_specs(cfg, seq, batch)),
            ("params", "caches", "token", "t"))


def cell_shardings(cfg: ModelConfig, shape, mesh: Mesh, args, outputs=None):
    """(in_shardings, out_shardings) of a cell's arguments on ``mesh``;
    the outputs' need ``outputs`` for a prefill, whose caches take the
    cache rule (else None there)."""
    from repro_torch.optim import AdamWState
    from repro_torch.train.loop import TrainState
    kind, seq, batch = S.cell(cfg, shape)
    psh = param_shardings(mesh, S.param_specs(cfg, tp_size(mesh)))
    rep = replicated(mesh)

    def caches_sh(caches):
        return cache_shardings(mesh, caches, batch=batch,
                               kv_heads=max(cfg.num_kv_heads, 1),
                               long_context=batch == 1)
    if kind == "train":
        # the moments mirror the parameters' sharding; steps replicate
        state_sh = TrainState(rep, psh, AdamWState(rep, psh, psh), None)
        return (state_sh, batch_shardings(mesh, args[1])), (state_sh, rep)
    if kind == "prefill":
        out_sh = None if outputs is None else (
            batch_shardings(mesh, outputs[0]), caches_sh(outputs[1]), rep)
        return (psh, batch_shardings(mesh, args[1])), out_sh
    csh = caches_sh(args[1])
    toksh = batch_shardings(mesh, args[2]) if batch > 1 else rep
    return (psh, csh, toksh, toksh), (rep, csh)


def build_cell(cfg: ModelConfig, shape, mesh: Mesh):
    """Returns (fn, args, in_shardings): the cell's function, its meta
    arguments and their shardings on ``mesh``."""
    fn, args, _ = cell_args(cfg, shape, tp_size(mesh))
    return fn, args, cell_shardings(cfg, shape, mesh, args)[0]


def card_memory():
    """(bytes, source) of the memory one card holds."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                "torch.cuda.get_device_properties(0).total_memory")
    return int(HBM_BYTES), "launch.mesh.HBM_BYTES"


def argument_bytes(args, groups, in_sh, mesh: Mesh):
    """Per-card bytes of each argument group (a train state split into
    ``step``, ``params`` and ``opt_state``)."""
    if groups[0] == "state":
        (state, batch), (state_sh, bsh) = args, in_sh
        parts = {"step": (state.step, state_sh.step),
                 "params": (state.params, state_sh.params),
                 "opt_state": (state.opt_state, state_sh.opt_state),
                 "batch": (batch, bsh)}
    else:
        parts = {g: (a, s) for g, a, s in zip(groups, args, in_sh)}
    return {g: per_device_bytes(a, s, mesh) for g, (a, s) in parts.items()}


def measure_cell(cfg: ModelConfig, shape, mesh: Mesh, run=None):
    """The per-card bytes of one cell on ``mesh`` (see the module
    docstring): (argument bytes by group, output bytes, aliased output
    bytes, run).  ``run``, ``(fn, args, groups, outputs)``, is a run of
    the cell's function on meta tensors; a mesh of the same TP degree
    reuses it (the meta outputs do not depend on the mesh)."""
    if run is None:
        fn, args, groups = cell_args(cfg, shape, tp_size(mesh))
        run = (fn, args, groups, fn(*args))
    _, args, groups, outputs = run
    in_sh, out_sh = cell_shardings(cfg, shape, mesh, args, outputs)
    arg_bytes = argument_bytes(args, groups, in_sh, mesh)
    ids = {id(t) for t in tree_leaves(args)}
    pairs = leaf_shardings(outputs, out_sh)
    aliased = [(t, s) for t, s in pairs if id(t) in ids]
    return (arg_bytes, per_device_bytes(outputs, out_sh, mesh),
            per_device_bytes([t for t, _ in aliased],
                             [s for _, s in aliased], mesh), run)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, run=None, card=None, log=print):
    """One cell's record, written to ``out_dir``; ``run`` as in
    :func:`measure_cell`; ``card`` the (bytes, source) of
    :func:`card_memory`, found here if not given.  Returns (record,
    run)."""
    out_dir = out_dir or ARTIFACT_DIR
    mesh = make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(mesh)
    label = f"{arch}__{shape_name}__{name}"
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": name, "ok": False}
    try:
        arg, out, alias, run = measure_cell(get_config(arch), shape_name,
                                            mesh, run)
        mem, src = card or card_memory()
        total = sum(arg.values())
        rec["memory"] = {"arguments": arg, "argument_size_in_bytes": total,
                         "output_size_in_bytes": out,
                         "output_aliased_bytes": alias}
        rec["card_memory_bytes"] = int(mem)
        rec["card_memory_source"] = src
        rec["fits"] = total + out - alias <= mem
        rec["collectives"] = None
        rec["collectives_reason"] = NO_COLLECTIVES
        rec["temp"] = None
        rec["temp_reason"] = NO_TEMP
        rec["num_devices"] = int(mesh.size)
        rec["seconds"] = time.time() - t0
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["seconds"] = time.time() - t0
    with open(os.path.join(out_dir, label + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    if log is not None:
        log(f"[dryrun] {label}: {'OK' if rec['ok'] else 'FAIL'} "
            f"({rec['seconds']:.1f}s)" + ("" if rec["ok"]
                                           else "\n" + rec["error"]))
    return rec, run


def _cells(archs, shapes, meshes, skip_existing: bool, out_dir: str):
    """(arch, shape, [multi_pod, ...]) to run, grouped so that one run of
    a cell's function serves both meshes."""
    out = []
    for arch in archs:
        for shape in shapes:
            todo = []
            for mp in meshes:
                path = os.path.join(out_dir, f"{arch}__{shape}__"
                                    f"{mesh_name(make_production_mesh(multi_pod=mp))}.json")
                if skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            continue
                todo.append(mp)
            if todo:
                out.append((arch, shape, todo))
    return out


def _run_group(job):
    arch, shape, meshes, out_dir, card, verbose = job
    recs, run = [], None
    for mp in meshes:
        rec, run = run_cell(arch, shape, mp, out_dir=out_dir, run=run,
                            card=card, log=print if verbose else None)
        recs.append(rec)
    return recs


def run_all(archs=None, shapes=None, meshes=(False, True), *,
            skip_existing: bool = False, out_dir: Optional[str] = None,
            verbose: bool = True):
    """Every cell of ``archs`` x ``shapes`` x ``meshes`` (a line a cell
    where ``verbose``); returns the records.  A cell's two meshes share
    one run of its function; the cells spread over up to 8 processes,
    one per CPU core (:data:`JOBS`)."""
    out_dir = out_dir or ARTIFACT_DIR
    archs = list(archs or ARCH_IDS)
    shapes = list(shapes or SHAPES)
    card = card_memory()
    groups = [(a, s, m, out_dir, card, verbose) for a, s, m in
              _cells(archs, shapes, meshes, skip_existing, out_dir)]
    jobs = min(JOBS, os.cpu_count() or 1, len(groups))
    if jobs <= 1:
        return [r for g in groups for r in _run_group(g)]
    import multiprocessing as mp
    # longest first: the train cells run the whole step
    groups.sort(key=lambda g: SHAPES[g[1]][2] != "train")
    # the workers run meta tensors only: they see no card (and open no
    # context on it); the card's memory comes from here
    hidden = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        pool = mp.get_context("spawn").Pool(jobs)
    finally:
        if hidden is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES")
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = hidden
    with pool:
        return [r for rs in pool.imap_unordered(_run_group, groups)
                for r in rs]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    meshes = []
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    recs = run_all([args.arch] if args.arch else None,
                   [args.shape] if args.shape else None,
                   sorted(set(meshes)), skip_existing=args.skip_existing)
    n_ok = sum(r["ok"] for r in recs)
    print(f"[dryrun] done: {n_ok} ok, {len(recs) - n_ok} failed")
    raise SystemExit(1 if n_ok < len(recs) else 0)


if __name__ == "__main__":
    main()
