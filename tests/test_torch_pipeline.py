"""The port's GPipe ``pipeline_apply`` against sequential application
and against the JAX package's.

S = 4 stages, M = 8 microbatches of Bm = 2 rows, D = 16, each stage
``tanh(h @ W + b)``, inputs drawn from a numpy seed.  Tolerances: 1e-5
on the outputs (the reference test's own), 1e-6 on the gradients (the
same float32 operations in another order of microbatches); the
reference runs in a subprocess on 4 fabricated host devices."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.parallel import pipeline_apply  # noqa: E402

S, M, BM, D = 4, 8, 2, 16
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _inputs():
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
            (rng.standard_normal((S, D)) * 0.1).astype(np.float32),
            rng.standard_normal((M, BM, D)).astype(np.float32))


def _stage(params, h):
    W, b = params
    return torch.tanh(h @ W + b)


def _sequential(Ws, bs, x):
    h = x
    for s in range(S):
        h = _stage((Ws[s], bs[s]), h)
    return h


def _leaves(requires_grad=False):
    return [torch.tensor(a, requires_grad=requires_grad) for a in _inputs()]


def test_pipeline_matches_sequential():
    Ws, bs, x = _leaves()
    mesh = make_mesh((S,), ("stage",), device="cpu")
    out = pipeline_apply(_stage, (Ws, bs), x, mesh=mesh, axis="stage")
    assert out.shape == (M, BM, D)
    assert float((out - _sequential(Ws, bs, x)).abs().max()) < 1e-5


def test_pipeline_gradients_match_sequential():
    grads = []
    for piped in (True, False):
        Ws, bs, x = _leaves(requires_grad=True)
        if piped:
            out = pipeline_apply(_stage, (Ws, bs), x,
                                 mesh=make_mesh((S,), ("stage",),
                                                device="cpu"))
        else:
            out = _sequential(Ws, bs, x)
        (out * torch.linspace(-1, 1, D)).sum().backward()
        grads.append([t.grad for t in (Ws, bs, x)])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) < 1e-6


SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.launch.mesh import make_mesh
    from repro.parallel import pipeline_apply

    d = np.load(sys.argv[1])
    mesh = make_mesh((4,), ("stage",))

    def stage_fn(params, h):
        W, b = params
        return jax.numpy.tanh(h @ W + b)

    with jax.set_mesh(mesh):
        out = pipeline_apply(stage_fn, (d["Ws"], d["bs"]), d["x"],
                             mesh=mesh, axis="stage")
    np.save(sys.argv[2], np.asarray(out))
""")


def test_pipeline_matches_reference(tmp_path):
    pytest.importorskip("jax")
    Ws, bs, x = _inputs()
    np.savez(tmp_path / "in.npz", Ws=Ws, bs=bs, x=x)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT,
                                                                   "src")),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path / "in.npz"),
                        str(tmp_path / "out.npy")], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = np.load(tmp_path / "out.npy")
    mesh = make_mesh((S,), ("stage",), device="cpu")
    out = pipeline_apply(_stage, (torch.tensor(Ws), torch.tensor(bs)),
                         torch.tensor(x), mesh=mesh).numpy()
    assert float(np.abs(out - ref).max()) < 1e-5


def test_microbatches_must_split_over_stages():
    Ws, bs, x = _leaves()
    with pytest.raises(AssertionError):
        pipeline_apply(_stage, (Ws, bs), x[:6],
                       mesh=make_mesh((S,), ("stage",), device="cpu"))
