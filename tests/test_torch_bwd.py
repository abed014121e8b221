"""Port parity of the backward: the band levels' gradients (the plain
backward of ``kernels.h1d_block_bwd`` through the autograd Functions of
``kernels.ops``, the CPU path of the kernel wrappers) and the gradient of
``core.h1d_attention``, against ``jax.vjp`` / ``jax.grad`` of the JAX
reference on the same numpy inputs and cotangents.

The reference runs its Pallas backward in interpret mode at L <= 256 (its
custom VJP: the same recompute and the same 1/c split of the max's
cotangent among ties) and its blocked XLA program (``impl='jnp'``,
natively differentiated) at L = 1024.  Tolerance: atol 1e-4 / rtol 1e-3,
the reference's own kernel-backward bound (``tests/test_kernel_bwd.py``);
both sides are fp32 and differ in summation order."""
import functools
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import h1d_block as thb  # noqa: E402
from repro_torch.kernels import h1d_block_bwd as thbb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

jatt = importlib.import_module("repro.core.h1d_attention")
tatt = importlib.import_module("repro_torch.core.h1d_attention")

TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(B, G, L, Lk, d, seed, pad):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, G, L, d)).astype(np.float32) / np.sqrt(d)
    k = rng.standard_normal((B, Lk, d)).astype(np.float32)
    w = np.ones((B, Lk), np.float32)
    if pad:
        w[0, Lk - pad:] = 0.0        # a right-padded prompt in row 0
    v = rng.standard_normal((B, Lk, d)).astype(np.float32) * w[..., None]
    return rng, (q, k, v, w)


def _torch_vjp(args, cts, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = tops.band_attention(*ts, **kw)
    return torch.autograd.grad(outs, ts, [torch.from_numpy(c) for c in cts])


# (mode, ratio, L, nr, G, pad, impl)
CASES = [
    ("l0_causal", 1, 64, 4, 1, 0, "pallas_interpret"),
    ("l0_causal", 1, 128, 8, 2, 37, "pallas_interpret"),
    ("sub", 2, 128, 8, 2, 9, "pallas_interpret"),
    ("sub", 4, 64, 4, 1, 0, "pallas_interpret"),
    ("sub", 8, 256, 16, 1, 5, "pallas_interpret"),
    ("l0_causal", 1, 1024, 16, 2, 300, "jnp"),
    ("sub", 2, 1024, 16, 2, 0, "jnp"),
    ("sub", 4, 1024, 8, 1, 70, "jnp"),
    ("sub", 8, 1024, 16, 2, 30, "jnp"),
]


@pytest.mark.parametrize("mode,ratio,L,nr,G,pad,impl", CASES,
                         ids=[f"{c[0]}-r{c[1]}-L{c[2]}-nr{c[3]}-G{c[4]}"
                              f"-pad{c[5]}-{c[6]}" for c in CASES])
def test_band_grads_match_jax(mode, ratio, L, nr, G, pad, impl):
    """(dq, dk, dv, dw) of one level under random cotangents on all of
    (y, dn, m), against ``jax.vjp`` of ``ops.band_attention``."""
    rng, args = _inputs(2, G, L, L // ratio, 16, seed=L + ratio + G, pad=pad)
    fn = jax.jit(functools.partial(jops.band_attention, nr=nr, mode=mode,
                                   ratio=ratio, impl=impl))
    outs, vjp = jax.vjp(fn, *args)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    want = vjp(tuple(cts))
    kernels.reset_counts()
    got = _torch_vjp(args, cts, nr=nr, mode=mode, ratio=ratio)
    plain = (thbb.band_attention_sub_bwd_ref if mode == "sub"
             else thbb.band_attention_bwd_ref)
    assert plain.calls == 1                 # the plain backward ran
    for name, a, b in zip("qkvw", want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                   err_msg=f"d{name}")


def test_tied_max_splits_its_cotangent():
    """Two keys of a row with the same score share the max's cotangent
    1/2 each (the reference's 1/c split); a row with every key masked
    sends it nowhere."""
    q = torch.zeros((1, 1, 8, 4))
    k = torch.zeros((1, 8, 4))
    q[0, 0, 5] = torch.tensor([1.0, 0, 0, 0])
    k[0, 2] = k[0, 4] = torch.tensor([2.0, 0, 0, 0])   # row 5 ties at s=2
    v = torch.zeros((1, 8, 4))
    w = torch.ones((1, 8))
    w[0, :1] = 0.0                                   # row 0: fully masked
    y, dn, m = thb.band_attention_fwd(q, k, v, w, nr=4)
    gm = torch.zeros_like(m)
    gm[0, 0, 5] = 1.0
    gm[0, 0, 0] = 1.0
    dq, dk, _, _, gmn = thbb.band_attention_bwd(
        q, k, v, w, y, dn, m, torch.zeros_like(y), torch.zeros_like(dn), gm,
        nr=4)
    # gy = gdn = 0, so delta = 0 and gmh = gm: each tie gets gm / 2
    assert float(gmn[0, 0, 5]) == 0.5
    assert float(gmn[0, 0, 0]) == 0.0 and bool(m[0, 0, 0] == thb._MIN_M)
    # ds = a*da + gmn*ind: dk of each tied key gets 0.5 * q_5
    torch.testing.assert_close(dk[0, 2], 0.5 * q[0, 0, 5])
    torch.testing.assert_close(dk[0, 4], 0.5 * q[0, 0, 5])
    torch.testing.assert_close(dq[0, 0, 5], 0.5 * (k[0, 2] + k[0, 4]))


def test_functions_reroute_through_module_attributes(monkeypatch):
    """The autograd Functions look their forward and backward up on the
    kernel modules at call time (how a caller reroutes them)."""
    seen = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(thb, "band_attention_fwd",
                        spy("fwd", thb.band_attention_fwd))
    monkeypatch.setattr(thbb, "band_attention_bwd",
                        spy("bwd", thbb.band_attention_bwd))
    _, args = _inputs(1, 1, 32, 32, 8, seed=0, pad=0)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    sum(o.sum() for o in tops.band_attention(*ts, nr=8, mode="l0_causal")
        ).backward()
    assert seen == ["fwd", "bwd"]


# (L, nr, G, pad); L == nr runs the M == 0 dense branch
ATT_CASES = [(64, 8, 1, 13), (256, 16, 2, 40), (128, 8, 2, 0), (8, 8, 1, 3)]


@pytest.mark.parametrize("L,nr,G,pad", ATT_CASES)
def test_h1d_attention_grads_match_jax(L, nr, G, pad):
    """The whole fine-q causal operator (coarsening, every level,
    ``_stream_combine``, padding weights) differentiated with respect to
    q, k, v and the key weights, against ``jax.grad`` of
    ``h1d_attention(impl='jnp')``."""
    rng, (q, k, v, _) = _inputs(2, G, L, L, 16, seed=L * G + pad, pad=0)
    w = np.ones((2, L), np.float32)
    if pad:
        w[1, L - pad:] = 0.0
        w[0, :2] = 0.5                  # fractional weights too
    r = rng.standard_normal((2, G, L, 16)).astype(np.float32)

    def jloss(q, k, v, w):
        z = jatt.h1d_attention(q, k, v, nr=nr, causal=True,
                               causal_mode="fine-q", kv_weight=w, impl="jnp")
        return (z * r).sum()
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(q, k, v, w)

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, w)]
    z = tatt.h1d_attention(*ts[:3], nr=nr, causal=True, kv_weight=ts[3])
    got = torch.autograd.grad((z * torch.from_numpy(r)).sum(), ts)
    for name, a, b in zip(("q", "k", "v", "kv_weight"), want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                   err_msg=f"d{name}")
