"""Port parity: band levels (``kernels.h1d_block`` plain versions, the
CPU path of the kernel wrappers) and ``core.h1d_attention`` against the
JAX reference on the same numpy inputs.

Tolerance: atol 2e-5 / rtol 1e-4, the reference's own kernel-vs-oracle
bound.  Both sides are fp32 and differ only in summation order; the
unnormalised (y, dn) of a coarse level grow with 2**l (values and key
weights are pairwise sums), hence the relative term."""
import functools
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import h1d_block as jhb  # noqa: E402
from repro_torch.kernels import h1d_block as thb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

jatt = importlib.import_module("repro.core.h1d_attention")
tatt = importlib.import_module("repro_torch.core.h1d_attention")

TOL = dict(atol=2e-5, rtol=1e-4)


def _jit(fn, **static):
    """The JAX reference as one compiled program (op-by-op dispatch
    compiles every op separately and dominates the test's time)."""
    return jax.jit(functools.partial(fn, **static))


def _inputs(B, G, L, d, seed, pad=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, G, L, d)).astype(np.float32) / np.sqrt(d)
    k = rng.standard_normal((B, L, d)).astype(np.float32)
    v = rng.standard_normal((B, L, d)).astype(np.float32)
    w = np.ones((B, L), np.float32)
    if pad:
        w[0, L - pad:] = 0.0       # a right-padded prompt in row 0
    return q, k, v, w


def _close(ref, got):
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("G", [1, 2])
def test_band_levels_match_blocked_jnp(L, G):
    """Level 0 (l0_causal) and every sub level of a fine-q hierarchy,
    through ``ops.band_attention`` on CPU tensors, against
    ``ops._blocked_jnp`` / ``_blocked_sub_jnp``."""
    nr = 8 if L == 64 else 16
    q, k, v, w = _inputs(3, G, L, 16, seed=L + G, pad=L // 4)
    v = v * w[..., None]
    ref = _jit(jops._blocked_jnp, nr=nr, mode="l0_causal")(q, k, v, w)
    _close(ref, tops.band_attention(*_t(q, k, v, w), nr=nr, mode="l0_causal"))
    M = L // nr
    ratio = 2
    kc, vc, wc = k, v, w
    while ratio < M:
        kc = kc.reshape(3, -1, 2, 16).mean(2)
        vc = vc.reshape(3, -1, 2, 16).sum(2)
        wc = wc.reshape(3, -1, 2).sum(2)
        ref = _jit(jops._blocked_sub_jnp, nr=nr, ratio=ratio)(q, kc, vc, wc)
        _close(ref, tops.band_attention(*_t(q, kc, vc, wc), nr=nr,
                                        mode="sub", ratio=ratio))
        ratio *= 2


def test_band_kernels_interpret_small():
    """One small case per ported Pallas kernel, run in interpret mode:
    the TPU kernel bodies themselves against the port's plain versions."""
    nr, L = 8, 64
    q, k, v, w = _inputs(2, 2, L, 16, seed=7, pad=10)
    v = v * w[..., None]
    ref = _jit(jhb.band_attention_fwd, nr=nr, mode="l0_causal", tq=32,
               interpret=True)(q, k, v, w)
    _close(ref, thb.band_attention_fwd(*_t(q, k, v, w), nr=nr))
    kc = k.reshape(2, -1, 4, 16).mean(2)
    vc = v.reshape(2, -1, 4, 16).sum(2)
    wc = w.reshape(2, -1, 4).sum(2)
    ref = _jit(jhb.band_attention_sub_fwd, nr=nr, ratio=4, tq=32,
               interpret=True)(q, kc, vc, wc)
    _close(ref, thb.band_attention_sub_fwd(*_t(q, kc, vc, wc), nr=nr,
                                           ratio=4))


def test_fully_masked_rows_give_zero():
    """A row whose every key has weight 0: m = -1e30, y = 0, dn = 0."""
    q, k, v, _ = _inputs(1, 1, 32, 8, seed=3)
    w = np.zeros((1, 32), np.float32)
    y, dn, m = thb.band_attention_fwd(*_t(q, k, v, w), nr=8)
    assert torch.all(m == thb._MIN_M) and not y.any() and not dn.any()


@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("G", [1, 2])
def test_h1d_attention_matches_jnp(L, G):
    nr = 8 if L == 64 else 16
    q, k, v, w = _inputs(2, G, L, 16, seed=100 + L + G, pad=L // 3)
    want = _jit(jatt.h1d_attention, nr=nr, causal=True, causal_mode="fine-q",
                impl="jnp")(q, k, v, kv_weight=w)
    got = tatt.h1d_attention(*_t(q, k, v), nr=nr, causal=True,
                             kv_weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_h1d_attention_single_block_dense_branch():
    """L == nr (M == 0): the exact dense branch, incl. a padded key."""
    q, k, v, w = _inputs(2, 1, 8, 16, seed=11, pad=3)
    want = _jit(jatt.h1d_attention, nr=8, causal=True)(q, k, v, kv_weight=w)
    got = tatt.h1d_attention(*_t(q, k, v), nr=8, causal=True,
                             kv_weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mha_fold_order_and_parity():
    """(B, L, H, D) layout with GQA: rows fold as b*Hkv + h."""
    rng = np.random.default_rng(5)
    B, L, Hq, Hkv, D = 2, 64, 4, 2, 16
    q = rng.standard_normal((B, L, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    jq, jk, jv, jf = jatt.fold_kv_heads(q, k, v)
    tq, tk, tv, tf = tatt.fold_kv_heads(*_t(q, k, v))
    assert jf == tf
    for a, b in ((jq, tq), (jk, tk), (jv, tv)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = _jit(jatt.h1d_attention_mha, nr=8, causal=True)(q, k, v)
    got = tatt.h1d_attention_mha(*_t(q, k, v), nr=8, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["l0_bidir", "coarse_causal",
                                  "coarse_bidir"])
def test_unported_modes_raise(mode):
    """The modes past ``l0_causal`` and ``sub`` run (they once raised
    ``NotImplementedError``): one level through ``ops.band_attention``
    against ``ops._blocked_jnp``, and the operator that uses the mode
    against the JAX operator.  An unknown mode raises ``ValueError``."""
    q, k, v, w = _inputs(2, 1, 64, 8, seed=1, pad=20)
    v = v * w[..., None]
    ref = _jit(jops._blocked_jnp, nr=8, mode=mode)(q, k, v, w)
    _close(ref, tops.band_attention(*_t(q, k, v, w), nr=8, mode=mode))
    causal = mode.endswith("causal")
    want = _jit(jatt.h1d_attention, nr=8, causal=causal,
                causal_mode="coarse-q")(q, k, v, kv_weight=w)
    got = tatt.h1d_attention(*_t(q, k, v), nr=8, causal=causal,
                             causal_mode="coarse-q",
                             kv_weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        tops.band_attention(*_t(q, k, v, w), nr=8, mode="l1_bidir")
