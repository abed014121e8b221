"""Port parity of the Mamba2 SSD core and mixer (``repro_torch.models.ssm``)
against the JAX package's ``repro.models.ssm``: the chunked SSD at
several chunks and group counts, the gcd fallback of the chunk rule, the
carried initial state, the per-step oracle, a decode chain, the mixer's
prefill state and decode, and the SSD's gradients.

Tolerances (fp32 on both sides, the same algorithm summed in other
orders): outputs and states 1e-5 of the JAX tensor's largest entry
(``close``); gradients 1e-4 of it."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import ModelConfig as JaxConfig  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

TOL, GRAD_TOL = 1e-5, 1e-4


def close(got, want, tol=TOL):
    """|got - want| <= tol * max |want| (and both finite)."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def make(B, S, H, P, G, N, seed=0):
    """The reference test's inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    Bm = 0.3 * rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = 0.3 * rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_jax(chunk, G):
    """y and the final state at every chunk, one group (mamba2_dims) and
    two (heads h read group h // 2, as jnp.repeat lays them out)."""
    j, t = both(make(2, 64, 4, 8, G, 16))
    jy, jh = jssm.ssd_chunked(*j, chunk=chunk)
    ty, th = tssm.ssd_chunked(*t, chunk=chunk)
    close(ty, jy)
    close(th, jh)
    assert ty.dtype == torch.float32 and th.dtype == torch.float32


def test_ssd_h0_carry_matches_jax():
    """A state carried into the second half: y and h as JAX's, and the
    two halves compose to the whole."""
    x, dt, A, Bm, Cm = make(1, 64, 2, 4, 1, 8, seed=3)
    j, t = both((x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:]))
    h0 = np.random.default_rng(4).standard_normal((1, 2, 8, 4)).astype(
        np.float32)
    jy, jh = jssm.ssd_chunked(*j, chunk=16, h0=jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*t, chunk=16, h0=torch.from_numpy(h0))
    close(ty, jy)
    close(th, jh)
    _, tw = both((x, dt, A, Bm, Cm))
    yf, hf = tssm.ssd_chunked(*tw, chunk=16)
    y1, h1 = tssm.ssd_chunked(*(a[:, :32] if a.dim() > 1 else a
                                for a in tw), chunk=16)
    y2, h2 = tssm.ssd_chunked(*(a[:, 32:] if a.dim() > 1 else a
                                for a in tw), chunk=16, h0=h1)
    close(torch.cat([y1, y2], 1), yf.numpy(), 2e-5)
    close(h2, hf.numpy(), 2e-5)


def test_ssd_reference_matches_jax_and_chunked():
    j, t = both(make(2, 24, 4, 8, 2, 16, seed=5))
    jy, jh = jssm.ssd_reference(*j)
    ty, th = tssm.ssd_reference(*t)
    close(ty, jy)
    close(th, jh)
    cy, ch = tssm.ssd_chunked(*t, chunk=8)
    close(cy, ty.numpy(), 2e-5)
    close(ch, th.numpy(), 2e-5)


def test_ssd_step_chain_matches_jax():
    """32 decode steps from zero state: each step's y and the state."""
    x, dt, A, Bm, Cm = make(1, 32, 2, 4, 1, 8, seed=1)
    jh = jnp.zeros((1, 2, 8, 4))
    th = torch.zeros((1, 2, 8, 4))
    for s in range(32):
        jy, jh = jssm.ssd_step(jh, jnp.asarray(x[:, s]), jnp.asarray(dt[:, s]),
                               jnp.asarray(A), jnp.asarray(Bm[:, s]),
                               jnp.asarray(Cm[:, s]))
        ty, th = tssm.ssd_step(th, torch.from_numpy(x[:, s]),
                               torch.from_numpy(dt[:, s]),
                               torch.from_numpy(A), torch.from_numpy(Bm[:, s]),
                               torch.from_numpy(Cm[:, s]))
        close(ty, jy)
    close(th, jh)


def test_ssd_gradients_match_jax():
    """d/d(x, dt, A, B, C) of a seeded linear function of y and h: the
    masked segsum gives no NaN in the backward."""
    arrays = make(2, 32, 4, 8, 1, 16, seed=6)
    rng = np.random.default_rng(7)
    gy = rng.standard_normal((2, 32, 4, 8)).astype(np.float32)
    gh = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)

    def jf(*a):
        y, h = jssm.ssd_chunked(*a, chunk=8)
        return (y * gy).sum() + (h * gh).sum()
    jg = jax.grad(jf, argnums=tuple(range(5)))(*(jnp.asarray(a)
                                                  for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, h = tssm.ssd_chunked(*ts, chunk=8)
    loss = (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
    tg = torch.autograd.grad(loss, ts)
    for a, b in zip(tg, jg):
        close(a, b, GRAD_TOL)


def _mixer(d=32, N=8, P=8, chunk=16, seed=2):
    """A mixer's JAX parameters, the port's copy and both configs."""
    kw = dict(d_model=d, ssm_state=N, ssm_head_dim=P, ssm_expand=2,
              ssm_chunk=chunk)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    p, _ = jssm.mamba2_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)),
                  jax.tree.map(np.asarray, p))
    return jcfg, tcfg, p, tp


@pytest.mark.parametrize("S,chunk", [(24, 8), (17, 1), (48, 16)])
def test_mixer_chunk_rule_matches_jax(S, chunk):
    """``mamba2_apply`` at ``ssm_chunk`` 16: S 48 runs chunk 16, S 24 the
    gcd 8 and S 17 chunk 1 (every position its own chunk); out, h and
    the convolution state as JAX's."""
    jcfg, tcfg, p, tp = _mixer()
    assert tssm._chunk_len(tcfg, S) == chunk
    x = np.random.default_rng(S).standard_normal((2, S, 32)).astype(
        np.float32)
    jo, (jh, jconv) = jssm.mamba2_apply(p, jcfg, jnp.asarray(x),
                                        return_state=True)
    to, st = tssm.mamba2_apply(tp, tcfg, torch.from_numpy(x),
                               return_state=True)
    assert isinstance(st, tssm.SSMState)
    close(to, jo)
    close(st.h, jh)
    close(st.conv, jconv)


def test_mixer_decode_matches_jax():
    """A 13-token prefill's state, then 6 decode steps of the mixer: out
    and both state tensors as JAX's every step."""
    jcfg, tcfg, p, tp = _mixer()
    x = np.random.default_rng(9).standard_normal((2, 19, 32)).astype(
        np.float32)
    _, (jh, jconv) = jssm.mamba2_apply(p, jcfg, jnp.asarray(x[:, :13]),
                                       return_state=True)
    _, st = tssm.mamba2_apply(tp, tcfg, torch.from_numpy(x[:, :13]),
                              return_state=True)
    js = (jh, jconv)
    for s in range(13, 19):
        jo, js = jssm.mamba2_decode(p, jcfg, jnp.asarray(x[:, s:s + 1]), js)
        to, st = tssm.mamba2_decode(tp, tcfg, torch.from_numpy(x[:, s:s + 1]),
                                    st)
        close(to, jo)
        close(st.h, js[0])
        close(st.conv, js[1])


def test_mixer_decode_reproduces_prefill():
    """The port alone: 24 decode steps from zero state give the full
    pass's outputs and final state (the reference's own check)."""
    _, tcfg, _, tp = _mixer(chunk=8)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 24, 32)).astype(np.float32))
    full, st = tssm.mamba2_apply(tp, tcfg, x, return_state=True)
    _, H, _, N, conv_dim = tssm.mamba2_dims(tcfg)
    state = tssm.SSMState(torch.zeros((2, H, N, 8)),
                          torch.zeros((2, 3, conv_dim)))
    outs = []
    for s in range(24):
        y, state = tssm.mamba2_decode(tp, tcfg, x[:, s:s + 1], state)
        outs.append(y[:, 0])
    close(torch.stack(outs, 1), full.numpy(), 2e-5)
    close(state.h, st.h.numpy(), 2e-5)
    close(state.conv, st.conv.numpy(), 1e-6)


def test_mixer_parameters_keep_float32_in_bf16():
    """``mamba2_init`` in bf16: A_log, D and dt_bias stay float32 (and
    hold the reference's values), the rest is bf16."""
    _, tcfg, _, _ = _mixer()
    p, _ = tssm.mamba2_init(torch.Generator().manual_seed(0), tcfg,
                            torch.bfloat16)
    dtypes = tree_map(lambda a: a.dtype, p)
    assert {dtypes[k] for k in ("A_log", "D", "dt_bias")} == {torch.float32}
    assert {dtypes[k] for k in ("conv_w", "conv_b")} == {torch.bfloat16}
    assert dtypes["in_proj"]["w"] == dtypes["norm"]["g"] == torch.bfloat16
    H = tssm.mamba2_dims(tcfg)[1]
    np.testing.assert_allclose(
        p["A_log"].numpy(),
        np.log(np.linspace(1.0, float(H), H).astype(np.float32)), rtol=1e-6)
