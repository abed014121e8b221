"""One rank of a ``DATAxMODEL`` world that ``test_torch_tp.py`` starts:
every check of that file's rank side, bundled, so that a world starts
once.

    python tests/_torch_tp_worker.py DIR RANK WORLD

joins a gloo group of WORLD ranks on the CPU through ``DIR/rdzv``, reads
the job the test wrote (``DIR/inputs.pt``: the mesh shape, the config,
the whole parameters carried over from the JAX package, a batch), and
writes what it got to ``DIR/rank{RANK}.pt``, the CLIs' reports beside
it:

* the first step's loss and the gathered gradients, on this rank's
  shards and data rows, their global norm and int8 compression on the
  shards, the loss with ``wkv`` split in contiguous column blocks
  instead of by head, and whether the gradient sum in small buckets
  gives the same bits;
* on a data axis alone, the loss, metrics and summed gradients of the
  other families' jobs (the MoE decoder, the encoder-decoder);
* three steps through the training CLI that write a checkpoint at
  step 3 (or, for a config that is not a CLI's, through
  ``train.loop.train``), two more that write one at step 2, and
  restores of the one-process run's checkpoint and of another world's;
* the refusals a world sees (``--sp`` with a model axis, a batch the
  data axis does not divide, a family tensor parallelism does not run).

It imports no JAX: the test holds the results to the JAX reference and
to the one-process runs.
"""
import os
import sys
import time

import torch

from repro_torch.data import ZipfLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model
from repro_torch.optim import global_norm, init_error_feedback, int8_compress
from repro_torch.parallel import group as grp
from repro_torch.parallel import tensor
from repro_torch.parallel.sharding import shard_params, unshard_params
from repro_torch.train import TrainConfig
from repro_torch.train import loop
from repro_torch.tree import tree_leaves


def _cli(job, *argv):
    base = ["--smoke", "--device", "cpu", "--mesh", job["mesh"], "--batch",
            str(job["B"]), "--seq", str(job["S"])]
    return train_cli.main(base + list(argv))


def first_step(job, mesh, out):
    """Loss and gathered gradients of one step on the rank's shards."""
    cfg, params, batch = job["cfg"], job["params"], job["batch"]
    specs = loop.param_specs(cfg, mesh)
    mine = shard_params(params, specs, mesh)
    fns = get_model(cfg)
    rows = tensor.data_rows(batch, mesh, 1)
    loss, _, grads = loop.loss_and_grads(fns, cfg, mine, rows, mesh=mesh,
                                         specs=specs)
    # the same sum in buckets of 3000 entries, some leaves in place
    small = [t.clone() for t in tree_leaves(grads)]
    whole, tensor.BUCKET_ELEMS = tensor.BUCKET_ELEMS, 3000
    try:
        tensor.reduce_grads(small, mesh)
    finally:
        tensor.BUCKET_ELEMS = whole
    tensor.reduce_grads(tree_leaves(grads), mesh)
    out["buckets_equal"] = all(torch.equal(a, b) for a, b in zip(
        small, tree_leaves(grads)))
    out["loss"] = float(loss)
    out["grads"] = unshard_params(grads, specs, mesh)
    # the clip's norm and the int8 compressor on the shards
    shards = tensor.LeafShards.of(mesh, specs)
    out["norm"] = float(global_norm(grads, shards))
    sent, _ = int8_compress(grads, init_error_feedback(grads), shards)
    out["int8"] = unshard_params(sent, specs, mesh)
    out["shapes"] = [tuple(t.shape) for t in tree_leaves(mine)]
    if mesh.M > 1 and cfg.num_kv_heads % mesh.M == 0:
        # wkv's shard in contiguous column blocks instead of by head
        m = mesh.coords[1]
        for lp, whole in zip(mine["layers"], params["layers"]):
            w = whole["attn"]["wkv"]["w"]
            lp["attn"]["wkv"]["w"] = torch.chunk(w, mesh.M, -1)[m].clone()
        out["contig_loss"] = float(loop.loss_and_grads(
            fns, cfg, mine, rows, mesh=mesh, specs=specs)[0])


def data_families(job, mesh, out):
    """Each other family's loss, metrics and gradients summed over the
    data axis, on the rank's data rows."""
    out["families"] = {}
    for name, (cfg, params, batch) in job["families"].items():
        rows = tensor.data_rows(batch, mesh, 1)
        loss, metrics, grads = loop.loss_and_grads(get_model(cfg), cfg,
                                                   params, rows, mesh=mesh)
        tensor.reduce_grads(tree_leaves(grads), mesh)
        out["families"][name] = dict(
            loss=float(loss), grads=grads,
            metrics={k: float(v) for k, v in metrics.items()})


def steps(job, mesh, path, out):
    """Three steps (the CLI's, or ``train`` for another config), then two
    that write a checkpoint at step 2, then the restores."""
    rep = os.path.join(path, "cli.{}.{{rank}}.json")
    if job["cli"]:
        _cli(job, "--steps", "3", "--ckpt-every", "3", "--ckpt-dir",
             os.path.join(path, "c3"), "--rank-report", rep.format("steps"))
        _cli(job, "--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
             job["ckpt_out"])
        for name, src in (("restore_one", job["ckpt_one"]),
                          ("restore_other", job["ckpt_other"])):
            if src is None:
                continue
            done = os.path.join(src, "step_00000002", "COMMIT")
            deadline = time.time() + 200
            while not os.path.exists(done):
                if time.time() > deadline:
                    raise TimeoutError(done)
                time.sleep(0.2)
            _cli(job, "--steps", "3", "--ckpt-dir", src, "--rank-report",
                 rep.format(name))
        return
    cfg = job["cfg"]
    tc = TrainConfig(total_steps=3, warmup=10, ckpt_every=0,
                     ckpt_dir=os.path.join(path, "c3"))
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=job["S"],
                  batch_per_host=job["B"], seed=0)
    _, metrics = loop.train(cfg, tc, data, 3, mesh=mesh,
                            log=lambda *a: None)
    out["losses"] = [h["loss"] for h in metrics["history"]]


def refusals(job, out):
    """What a world refuses, each before any step runs."""
    caught = {}
    D, M = (int(n) for n in job["mesh"].split("x"))
    cases = {"batch": ("--steps", "1", "--batch", "6", "--grad-accum", "2",
                       "--ckpt-dir", "refused")}
    if M > 1:
        cases["sp"] = ("--steps", "1", "--sp")
        cases["family"] = ("--steps", "1", "--arch", "mamba2-1.3b")
    for name, argv in cases.items():
        if name == "batch" and D == 1:
            continue
        try:
            _cli(job, *argv)
        except (NotImplementedError, ValueError) as e:
            caught[name] = (type(e).__name__, str(e))
    try:
        make_mesh((job["world"] + 1, 1), ("data", "model"))
    except ValueError as e:
        caught["size"] = (type(e).__name__, str(e))
    out["refusals"] = caught


def main(path, rank, world):
    torch.set_num_threads(1)
    torch.manual_seed(0)
    grp.init(rank, world, f"file://{os.path.join(path, 'rdzv')}",
             device="cpu")
    job = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
    job["world"] = world
    mesh = make_mesh(tuple(int(n) for n in job["mesh"].split("x")),
                     ("data", "model"))
    out = {"coords": mesh.coords}
    first_step(job, mesh, out)
    data_families(job, mesh, out)
    steps(job, mesh, path, out)
    refusals(job, out)
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    grp.destroy()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
