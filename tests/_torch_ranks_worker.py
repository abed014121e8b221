"""One rank of a world that ``test_torch_ranks.py`` starts: every check
of that file's rank side, bundled, so that a world starts once.

    python tests/_torch_ranks_worker.py DIR RANK WORLD

joins a gloo group of WORLD ranks on the CPU through ``DIR/rdzv``, reads
the inputs the test wrote (``DIR/inputs.pt``), runs the rank form of the
SP operator, the decode tick, the serving engine and CLI, two SP train
steps and the pipeline, and writes what it got to ``DIR/rank{RANK}.pt``
(and the CLIs' own reports beside it).  Within the rank it also runs the
one-process mesh on the same inputs and records whether its own shard's
output is bit-identical.  It imports no JAX: the test holds the results
to the JAX reference.
"""
import os
import sys

import torch

from repro_torch import kernels
from repro_torch.core import h1d_decode as thd
from repro_torch.core.h1d_attention import h1d_attention
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model
from repro_torch.parallel import group as grp
from repro_torch.parallel import pipeline_apply
from repro_torch.parallel import sp_attention as sp
from repro_torch.serve import Request, ServeEngine

CPU = torch.device("cpu")


def _leaves(c):
    return [c.k, c.v, *c.ck, *c.cv]


def operator(inp, mesh, local, out):
    """The SP operator in every causal mode and every band mode, rank
    form against the one-process form, and its gradients."""
    for key, (q, k, v, w) in inp["op"].items():
        causal, causal_mode = key
        kw = dict(nr=inp["op_nr"], causal=causal, causal_mode=causal_mode,
                  kv_weight=w)
        got = sp.sp_h1d_attention(q, k, v, mesh=mesh, **kw)
        one = sp.sp_h1d_attention(q, k, v, mesh=local, **kw)
        with sp.sp_scope(mesh):
            scoped = h1d_attention(q, k, v, **kw)
        out[("op", key)] = got
        out[("op_same", key)] = torch.equal(got, one)
        out[("op_scoped", key)] = torch.equal(got, scoped)
    for key, (q, k, v, w) in inp["band"].items():
        mode, ratio = key
        kw = dict(nr=inp["op_nr"], mode=mode, ratio=ratio)
        got = sp.sp_band_attention(q, k, v, w, mesh=mesh, **kw)
        one = sp.sp_band_attention(q, k, v, w, mesh=local, **kw)
        out[("band", key)] = got
        out[("band_same", key)] = all(torch.equal(a, b)
                                      for a, b in zip(got, one))
    for key, (q, k, v, w, cot) in inp["grad"].items():
        causal, causal_mode = key
        kw = dict(nr=inp["grad_nr"], causal=causal, causal_mode=causal_mode)

        def grads(m):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v, w)]
            y = sp.sp_h1d_attention(*ts[:3], mesh=m, kv_weight=ts[3], **kw)
            return torch.autograd.grad((y * cot).sum(), ts)
        got = grads(mesh)
        one = grads(local)
        out[("grad", key)] = got
        out[("grad_gap", key)] = max(float((a - b).abs().max())
                                     for a, b in zip(got, one))


def decode(inp, mesh, out):
    """One SP decode tick: attend, then the ancestor update."""
    k, v, q, kn, vn, ts = inp["decode"]
    lmax, nr = inp["lmax"], inp["decode_nr"]
    sc = sp.shard_cache(thd.prefill_cache(k, v, lmax, nr), mesh, nr)
    assert len(sc.shards) == 1
    tabs = sp.sp_tables(ts, nr=nr, Lmax=lmax, d=mesh.d, device=CPU)
    kernels.reset_counts()
    with sp.sp_scope(mesh):
        out["attend"] = thd.decode_attend(sc, q, torch.from_numpy(ts),
                                          nr=nr, tables=tabs)
        thd.update_cache(sc, kn, vn, torch.from_numpy(ts), tables=tabs)
    out["decode_calls"] = {n: p.calls for n, (_, p) in
                           kernels.KERNELS.items()}
    out["updated"] = _leaves(sp.unshard_cache(sc, mesh))


def engine(inp, mesh, out):
    cfg, params, prompts = inp["engine"]
    eng = ServeEngine(cfg, params, slots=inp["slots"], max_len=64,
                      mesh=mesh)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    kernels.reset_counts()
    sp.DISPATCHES.clear()
    eng.run()
    out["tokens"] = [list(r.out_tokens) for r in reqs]
    out["engine_calls"] = {n: p.calls for n, (_, p) in
                           kernels.KERNELS.items()}
    out["engine_dispatches"] = dict(sp.DISPATCHES)


def pipeline(inp, g, out):
    Ws, bs, x, cot = (t.clone().requires_grad_(True) if i < 3 else t
                      for i, t in enumerate(inp["pipe"]))

    def stage(params, h):
        W, b = params
        return torch.tanh(h @ W + b)
    y = pipeline_apply(stage, (Ws, bs), x,
                       mesh=make_mesh((g.world,), ("stage",)))
    (y * cot).sum().backward()
    out["pipe"] = y.detach()
    out["pipe_grads"] = (Ws.grad, bs.grad, x.grad)


def refusals(g, out):
    caught = []
    for shape, axes, err in [((g.world, 2), ("data", "model"), ValueError),
                             ((g.world + 1,), ("data",), ValueError)]:
        try:
            make_mesh(shape, axes)
        except err as e:
            caught.append(str(e))
    out["refusals"] = caught


def main(path, rank, world):
    torch.set_num_threads(1)
    torch.manual_seed(0)
    os.environ["REPRO_RANK_CHECK"] = "1"
    g = grp.init(rank, world, f"file://{os.path.join(path, 'rdzv')}",
                 device="cpu")
    inp = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
    mesh = make_mesh((world,), ("data",))
    local = sp.SPMesh("data", (CPU,) * world)
    out = {"backend": g.backend, "placement": g.placement}
    operator(inp, mesh, local, out)
    decode(inp, mesh, out)
    engine(inp, mesh, out)
    cli = os.path.join(path, "cli")
    serve_cli.main(["--smoke", "--device", "cpu", "--sp-data", str(world),
                    "--requests", "3", "--slots", "2", "--new-tokens", "4",
                    "--max-len", "64", "--rank-report",
                    f"{cli}.serve.{{rank}}.json"])
    train_cli.main(["--smoke", "--device", "cpu", "--sp", "--mesh",
                    str(world), "--steps", "2", "--ckpt-dir",
                    os.path.join(path, "ckpt"), "--rank-report",
                    f"{cli}.train.{{rank}}.json"])
    pipeline(inp, g, out)
    refusals(g, out)
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    grp.destroy()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
