"""Port parity of the dense oracles against the JAX package on the same
numpy inputs: ``core.ref_attention.dense_attention`` (the paper's full
attention), ``core.ref_attention.h1d_dense_oracle`` (the O(L^2)
reconstruction of the hierarchical operator) and
``kernels.ref.band_attention_ref`` (one band level, every mode); then the
port's own ``h1d_attention`` and band kernels' plain versions held to the
port's oracles.

Tolerance: 2e-5 absolute / 1e-4 relative, the reference's own for its
operator against its oracle (``tests/test_h1d_attention.py``): fp32 on
both sides, another summation order."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import ref_attention as jref  # noqa: E402
from repro.kernels import ref as jkref  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import ref_attention as tref  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _weights(rng, B, L):
    """Key weights in (0.5, 1.5) with a zero tail on row 0 and scattered
    zeros on the others."""
    w = rng.uniform(0.5, 1.5, (B, L)).astype(np.float32)
    w[0, L - L // 4:] = 0.0
    w[1:, rng.integers(0, L, L // 8)] = 0.0
    return w


# (case, causal, k heads (4-D), Lq, Lk, kv_weight)
DENSE_CASES = [
    ("causal", True, False, 48, 48, False),
    ("bidirectional", False, False, 48, 48, False),
    ("kv_weight", True, False, 48, 48, True),
    ("4d_kv", True, True, 48, 48, True),
    ("rectangular", False, False, 24, 56, True),
]


@pytest.mark.parametrize("case,causal,kv4,Lq,Lk,weighted", DENSE_CASES,
                         ids=[c[0] for c in DENSE_CASES])
def test_dense_attention_matches_jax(case, causal, kv4, Lq, Lk, weighted):
    rng = np.random.default_rng(len(case) + Lq)
    B, G, D, Dv = 2, 3, 16, 8
    kshape = (B, G, Lk) if kv4 else (B, Lk)
    q = rng.standard_normal((B, G, Lq, D)).astype(np.float32)
    k = rng.standard_normal(kshape + (D,)).astype(np.float32)
    v = rng.standard_normal(kshape + (Dv,)).astype(np.float32)
    w = _weights(rng, B, Lk) if weighted else None
    want = jref.dense_attention(q, k, v, causal=causal, kv_weight=w)
    got = tref.dense_attention(*_t(q, k, v), causal=causal,
                               kv_weight=None if w is None else _t(w)[0])
    assert got.dtype == torch.float32 and got.shape == (B, G, Lq, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_attention_keeps_v_dtype_and_refuses_rectangular_causal():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 1, 8, 4)).astype(
        np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
    z = tref.dense_attention(q.bfloat16(), kv.bfloat16(), kv.bfloat16(),
                             causal=True)
    assert z.dtype == torch.bfloat16
    with pytest.raises(AssertionError):
        tref.dense_attention(q, kv[:, :4], kv[:, :4], causal=True)


# (case, L, nr, causal, causal_mode): M = 3 levels, and M = 0 (L == nr)
ORACLE_CASES = [
    ("fine_q", 64, 8, True, "fine-q"),
    ("coarse_q", 64, 8, True, "coarse-q"),
    ("bidirectional", 64, 8, False, "fine-q"),
    ("single_block", 8, 8, True, "fine-q"),
]


def _oracle_inputs(seed, L, B=2, G=2, D=16, Dv=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, G, L, D)).astype(np.float32)
    k = rng.standard_normal((B, L, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Dv)).astype(np.float32)
    return q, k, v, _weights(rng, B, L)


@pytest.mark.parametrize("case,L,nr,causal,mode", ORACLE_CASES,
                         ids=[c[0] for c in ORACLE_CASES])
def test_h1d_dense_oracle_matches_jax(case, L, nr, causal, mode):
    q, k, v, w = _oracle_inputs(L + len(case), L)
    want = jref.h1d_dense_oracle(q, k, v, nr=nr, causal=causal,
                                 causal_mode=mode, kv_weight=w)
    got = tref.h1d_dense_oracle(*_t(q, k, v, w)[:3], nr=nr, causal=causal,
                                causal_mode=mode, kv_weight=_t(w)[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case,L,nr,causal,mode", ORACLE_CASES[:3],
                         ids=[c[0] for c in ORACLE_CASES[:3]])
def test_h1d_attention_matches_the_ports_oracle(case, L, nr, causal, mode):
    """The port's operator (every level through the band kernels' plain
    versions on the CPU) against the port's dense reconstruction."""
    q, k, v, w = (torch.from_numpy(a) for a in _oracle_inputs(7, L))
    got = tcore.h1d_attention(q, k, v, nr=nr, causal=causal,
                              causal_mode=mode, kv_weight=w)
    want = tref.h1d_dense_oracle(q, k, v, nr=nr, causal=causal,
                                 causal_mode=mode, kv_weight=w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_oracle_exports():
    assert tcore.dense_attention is tref.dense_attention
    assert tcore.h1d_dense_oracle is tref.h1d_dense_oracle
    assert tkernels.band_attention_ref is tkernels.ref.band_attention_ref


# (mode, ratio): the four band modes and the fine-q coarse level
BAND_CASES = [("l0_causal", 1), ("l0_bidir", 1), ("coarse_causal", 1),
              ("coarse_bidir", 1), ("sub", 2), ("sub", 4)]


def _band_inputs(mode, ratio, seed=3, B=2, G=2, L=64, d=16, dv=8):
    """Pre-scaled q over L rows; keys over L / ratio (sub) or L, weights
    with zeros and v pre-weighted, as the operator hands them over."""
    rng = np.random.default_rng(seed + ratio)
    Lk = L // ratio if mode == "sub" else L
    q = (rng.standard_normal((B, G, L, d)) / 4).astype(np.float32)
    k = rng.standard_normal((B, Lk, d)).astype(np.float32)
    w = _weights(rng, B, Lk)
    v = (rng.standard_normal((B, Lk, dv)) * w[..., None]).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("mode,ratio", BAND_CASES,
                         ids=[f"{m}{r}" for m, r in BAND_CASES])
def test_band_attention_ref_matches_jax(mode, ratio):
    q, k, v, w = _band_inputs(mode, ratio)
    want = jkref.band_attention_ref(q, k, v, w, nr=8, mode=mode,
                                    ratio=ratio)
    got = tkernels.band_attention_ref(*_t(q, k, v, w), nr=8, mode=mode,
                                      ratio=ratio)
    for name, a, b in zip(("y", "dn", "m"), got, want):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("mode,ratio", BAND_CASES,
                         ids=[f"{m}{r}" for m, r in BAND_CASES])
def test_band_plain_versions_match_the_ports_oracle(mode, ratio):
    """The wrappers on CPU tensors (their plain versions, which walk the
    band's blocks) against the oracle's one masked product."""
    q, k, v, w = _t(*_band_inputs(mode, ratio, seed=5))
    if mode == "sub":
        got = tkernels.band_attention_sub_fwd(q, k, v, w, nr=8, ratio=ratio)
    else:
        got = tkernels.band_attention_fwd(q, k, v, w, nr=8, mode=mode)
    want = tkernels.band_attention_ref(q, k, v, w, nr=8, mode=mode,
                                       ratio=ratio)
    for name, a, b in zip(("y", "dn", "m"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **TOL)
