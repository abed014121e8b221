"""Which gloo collectives take CUDA tensors, and what a small one costs:
the facts behind ``parallel/group.py``'s shared-card transport.

    python tools/gloo_cuda_probe.py

Two ranks (``torch.multiprocessing.spawn``) join a gloo group through a
file and share card 0, then the CPU.  Rank 0 prints one line per op:
``ok`` with the result, or ``FAIL`` with the error.  The collectives
(all-reduce sum and max, all-gather, all_gather_into_tensor,
reduce_scatter_tensor, broadcast) and a P2P staged through host memory
run in one world; a P2P of CUDA tensors (``batch_isend_irecv``, then
``isend`` / ``irecv``) runs in a world of its own, since gloo may abort
the process on it.  Then the host ms a call of: a staged P2P of 400 KB,
an all-reduce of 400 KB and of 32 KB, and an all-gather of 16 MB direct
and staged (50 calls, 10 for the 16 MB ones).
"""
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def probe(rank, world, path, devname, p2p):
    dev = torch.device(devname)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    nxt, prv = (rank + 1) % world, (rank - 1) % world

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def check(name, fn):
        try:
            t0 = time.perf_counter()
            out = fn()
            sync()
            line = f"ok {(time.perf_counter() - t0) * 1e3:.3f} ms {out}"
        except RuntimeError as e:
            line = f"FAIL {str(e).splitlines()[0][:160]}"
        if rank == 0:
            print(f"[{devname}] {name}: {line}", flush=True)
        dist.barrier()

    def rep(fn, n=50):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        return f"{(time.perf_counter() - t0) / n * 1e3:.4f} ms a call"

    x = torch.full((4,), float(rank + 1), device=dev)

    def send_recv(a, b):
        ops = [dist.P2POp(dist.isend, a, nxt), dist.P2POp(dist.irecv, b, prv)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return b

    if p2p:
        check("batch_isend_irecv", lambda: send_recv(
            x, torch.empty_like(x)).tolist())

        def pair():
            y = torch.empty_like(x)
            a, b = dist.isend(x, nxt), dist.irecv(y, prv)
            a.wait()
            b.wait()
            return y.tolist()
        check("isend_irecv", pair)
        dist.destroy_process_group()
        return

    def reduce(op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y.tolist()

    def gather():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return torch.cat(out).tolist()

    def gather_into():
        out = torch.empty(world * 4, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.tolist()

    def reduce_scatter():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(
            2 * world, device=dev, dtype=torch.float32))
        return out.tolist()

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y.tolist()

    def staged(t):
        h = t.cpu()
        return send_recv(h, torch.empty_like(h)).to(dev)

    check("all_reduce_sum", lambda: reduce(dist.ReduceOp.SUM))
    check("all_reduce_max", lambda: reduce(dist.ReduceOp.MAX))
    check("all_gather", gather)
    check("all_gather_into_tensor", gather_into)
    check("reduce_scatter_tensor", reduce_scatter)
    check("broadcast", broadcast)
    check("staged_p2p", lambda: staged(x).tolist())
    big = torch.randn(16, 48, 129, device=dev)
    mid = torch.randn(8, 8, 1024, 64, device=dev)

    def gather_mid(t):
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t)
        return torch.cat(out)
    check("staged_p2p_400KB", lambda: rep(lambda: staged(big)))
    check("all_reduce_400KB", lambda: rep(
        lambda: dist.all_reduce(big.clone())))
    check("all_reduce_32KB", lambda: rep(
        lambda: dist.all_reduce(torch.ones(64 * 128, device=dev))))
    check("all_gather_16MB", lambda: rep(lambda: gather_mid(mid), 10))
    check("all_gather_16MB_staged", lambda: rep(
        lambda: gather_mid(mid.cpu()).to(dev), 10))
    dist.destroy_process_group()


def world(devname, p2p):
    path = os.path.join(tempfile.mkdtemp(), "rdzv")
    mp.spawn(probe, args=(2, path, devname, p2p), nprocs=2, join=True)


def main():
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.device_count(), flush=True)
    devs = ["cpu"]
    if torch.cuda.is_available():
        devs.insert(0, "cuda:0")
    for devname in devs:
        world(devname, False)
    if torch.cuda.is_available():
        try:
            world("cuda:0", True)
        except mp.ProcessRaisedException as e:
            print(f"[cuda:0] P2P world ended: {str(e).strip()[-300:]}",
                  flush=True)
        except mp.ProcessExitedException as e:
            print(f"[cuda:0] P2P world ended: {e}", flush=True)


if __name__ == "__main__":
    main()
