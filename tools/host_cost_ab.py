"""Host microseconds a kernel wrapper call takes in two source trees,
measured in turns on one card (A, B, B, A).

    python3 tools/host_cost_ab.py TREE_A TREE_B [--calls 500]

Each turn runs in a fresh process with ``TREE/src`` first on the path:
it builds that tree's kernels (into ``TREE/build/kernels``) and times,
with telemetry off, ``calls`` back-to-back calls ending in a synchronize
of ``decode_attend_fused`` at the LM's serving shape (64 rows, G 1, D
64, Lmax 2048, nr 16) and of ``band_attention_fwd`` in ``l0_causal`` at
its training shape (64 x G 1, L 1024, d 64): both calls take less
device time than host time, so the figure is the host's cost of a
launch.  Prints one JSON line per turn and the card's name and power
limit.
"""
import argparse
import json
import subprocess
import sys

MEASURE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch import exact_products
from repro_torch.core import h1d_decode as hd
from repro_torch.kernels import _build
from repro_torch.kernels import h1d_block as hb
from repro_torch.kernels import h1d_decode_kernel as dk
exact_products()
_build.build(_build.sources())
calls = int(sys.argv[2])
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
R, L, D, NR = 64, 2048, 64, 16
cache = hd.prefill_cache(torch.randn((R, L, D), generator=gen, device=dev),
                         torch.randn((R, L, D), generator=gen, device=dev),
                         L, NR)
q = torch.randn((R, 1, D), generator=gen, device=dev)
t = torch.randint(0, L, (R,), generator=gen, device=dev, dtype=torch.int32)
bq = torch.randn((64, 1, 1024, D), generator=gen, device=dev) / 8
bk = torch.randn((64, 1024, D), generator=gen, device=dev)
bw = torch.ones((64, 1024), device=dev)
out = {}
for name, fn in (("decode_attend_fused",
                  lambda: dk.decode_attend_fused(cache, q, t, nr=NR)),
                 ("band_attention_fwd",
                  lambda: hb.band_attention_fwd(bq, bk, bk, bw, nr=NR,
                                                mode="l0_causal"))):
    for _ in range(20):
        fn()
    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / calls * 1e6)
    out[name] = reps
print(json.dumps({"tree": sys.argv[1], "host_us": out}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args()
    for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
        res = subprocess.run([sys.executable, "-c", MEASURE, tree,
                              str(args.calls)], capture_output=True,
                             text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
