"""Port parity: the hierarchical decode cache (``core.h1d_decode`` and
the CPU path of ``kernels.h1d_decode_kernel``) against the JAX reference.

Tolerances: the cache build and the ancestor update are pure copies,
pairwise adds and exact halvings, so ``prefill_cache`` and
``update_cache`` are bit-exact given the same inputs; ``decode_attend``
is a normalised softmax over fp32 dot products whose summation order
differs, held to 1e-5."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import h1d_decode as jhd  # noqa: E402
from repro.kernels import h1d_decode_kernel as jdk  # noqa: E402
from repro_torch.core import h1d_decode as thd  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as tdk  # noqa: E402

ATOL = 1e-5


def _interesting_ts(Lmax, nr, n_extra=4, seed=0):
    """Mask edge cases: first block, block boundaries, top-level span
    boundaries and half-span quadrant flips, the last position."""
    M = thd.hc.num_levels(Lmax, nr)
    span = nr << max(M - 1, 1)
    ts = [0, 1, nr - 1, nr, 2 * nr - 1, span - 1, span,
          span + span // 2 - 1, span + span // 2, Lmax - 1]
    rng = np.random.default_rng(seed)
    ts += list(rng.integers(0, Lmax, size=n_extra))
    return np.array(sorted({int(t) % Lmax for t in ts}), np.int32)


def _caches(B, Lmax, D, Dv, nr, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, Lmax, D)).astype(np.float32)
    v = rng.standard_normal((B, Lmax, Dv)).astype(np.float32)
    jc = jax.jit(functools.partial(jhd.prefill_cache, Lmax=Lmax, nr=nr))(k, v)
    tc = thd.prefill_cache(torch.from_numpy(k), torch.from_numpy(v), Lmax, nr)
    return jc, tc


def _leaves(tc):
    return [tc.k, tc.v, *tc.ck, *tc.cv]


def _assert_cache_equal(jc, tc):
    for a, b in zip(jax.tree.leaves(jc), _leaves(tc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("Lp,Lmax,nr", [(40, 128, 8), (256, 256, 16),
                                        (100, 512, 16)])
def test_prefill_cache_bit_exact(Lp, Lmax, nr):
    rng = np.random.default_rng(Lp)
    k = rng.standard_normal((3, Lp, 16)).astype(np.float32)
    v = rng.standard_normal((3, Lp, 8)).astype(np.float32)
    jc = jax.jit(functools.partial(jhd.prefill_cache, Lmax=Lmax, nr=nr))(k, v)
    tc = thd.prefill_cache(torch.from_numpy(k), torch.from_numpy(v), Lmax, nr)
    assert len(tc.ck) == len(jc.ck)
    _assert_cache_equal(jc, tc)


@pytest.mark.parametrize("Lmax,nr,G", [(256, 16, 1), (256, 8, 4),
                                       (512, 16, 2)])
def test_decode_attend_parity(Lmax, nr, G):
    ts = _interesting_ts(Lmax, nr)
    B, D = len(ts), 16
    jc, tc = _caches(B, Lmax, D, D, nr, seed=Lmax + nr)
    q = np.random.default_rng(1).standard_normal((B, G, D)).astype(np.float32)
    want = jax.jit(functools.partial(jhd.decode_attend, nr=nr))(jc, q, ts)
    got = thd.decode_attend(tc, torch.from_numpy(q), torch.from_numpy(ts),
                            nr=nr)
    assert got.dtype == torch.float32 and got.shape == (B, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("Lmax,nr", [(128, 8), (512, 16)])
def test_update_cache_bit_exact_sequential(Lmax, nr):
    """In-place port update == the JAX update, bit for bit, across
    chained writes (later writes read rows of earlier ones)."""
    B, D, Dv = 4, 16, 8
    jc, tc = _caches(B, Lmax, D, Dv, nr, seed=2)
    rng = np.random.default_rng(3)
    upd = jax.jit(jhd.update_cache)
    for _ in range(4):
        kn = rng.standard_normal((B, D)).astype(np.float32)
        vn = rng.standard_normal((B, Dv)).astype(np.float32)
        t = rng.integers(0, Lmax, size=B).astype(np.int32)
        jc = upd(jc, kn, vn, t)
        out = thd.update_cache(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                               torch.from_numpy(t))
        assert out is tc            # in place
        _assert_cache_equal(jc, tc)


def test_decode_kernels_interpret_small():
    """One small case per ported Pallas decode kernel, run in interpret
    mode, against the port's plain versions."""
    Lmax, nr, G, D = 128, 8, 2, 16
    ts = _interesting_ts(Lmax, nr, n_extra=0)
    B = len(ts)
    jc, tc = _caches(B, Lmax, D, D, nr, seed=9)
    q = np.random.default_rng(4).standard_normal((B, G, D)).astype(np.float32)
    want = jax.jit(functools.partial(jdk.decode_attend_fused, nr=nr,
                                     interpret=True))(jc, q, ts)
    got = tdk.decode_attend_ref(tc, torch.from_numpy(q), torch.from_numpy(ts),
                                nr=nr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    kn = np.random.default_rng(5).standard_normal((B, D)).astype(np.float32)
    jc = jax.jit(functools.partial(jdk.update_cache_fused, interpret=True))(
        jc, kn, -kn, ts)
    tdk.update_cache_ref(tc, torch.from_numpy(kn), torch.from_numpy(-kn),
                         torch.from_numpy(ts))
    _assert_cache_equal(jc, tc)


def test_uniform_variants_broadcast_t():
    """Scalar-t entry points == the batched ones with t repeated per row."""
    Lmax, nr, B, D, t = 256, 16, 3, 16, 77
    _, tc = _caches(B, Lmax, D, D, nr, seed=6)
    _, tc2 = _caches(B, Lmax, D, D, nr, seed=6)
    rng = np.random.default_rng(7)
    kn = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, 2, D)).astype(np.float32))
    tt = torch.full((B,), t, dtype=torch.int32)
    thd.update_cache_uniform(tc, kn, kn, torch.tensor(t))
    thd.update_cache(tc2, kn, kn, tt)
    for a, b in zip(_leaves(tc), _leaves(tc2)):
        assert torch.equal(a, b)
    assert torch.equal(thd.decode_attend_uniform(tc, q, t, nr=nr),
                       thd.decode_attend(tc2, q, tt, nr=nr))


def test_prefill_then_decode_equals_full_attention():
    """Decode on a prefilled cache reproduces the fine-q causal
    attention of the whole sequence at every new position."""
    import importlib
    tatt = importlib.import_module("repro_torch.core.h1d_attention")
    nr, Lmax, B, D, P, n = 8, 128, 2, 16, 37, 12
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((B, 1, P + n, D)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, P + n, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, P + n, D)).astype(np.float32))
    L = thd.hc.padded_length(P + n, nr)
    pad = (0, 0, 0, L - P - n)
    w = torch.zeros((B, L))
    w[:, :P + n] = 1.0
    full = tatt.h1d_attention(
        torch.nn.functional.pad(q, pad), torch.nn.functional.pad(k, pad),
        torch.nn.functional.pad(v, pad), nr=nr, causal=True, kv_weight=w)
    cache = thd.prefill_cache(k[:, :P], v[:, :P], Lmax, nr)
    for i in range(P, P + n):
        t = torch.full((B,), i, dtype=torch.int32)
        thd.update_cache(cache, k[:, i], v[:, i], t)
        z = thd.decode_attend(cache, q[:, :, i], t, nr=nr)
        np.testing.assert_allclose(z.numpy(), full[:, :, i].numpy(),
                                   atol=ATOL, rtol=ATOL)
