"""Port parity of the paper LM (``repro_torch.models``) against the JAX
model on the ``h1d-lm-53m`` smoke config, through ``params_from_jax``;
plus the port's isolation rules.

Tolerance: logits 1e-4 absolute.  Both sides are fp32; they differ in
summation order inside the projections and attention and in the last bit
of rope's cos/sin, over two layers and a tied head."""
import ast
import dataclasses
import functools
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.models.transformer import lm_forward as jax_lm_forward  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import h1d_decode as thd  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import ModelConfig, get_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
ARCH = "h1d-lm-53m"


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_model_config_mirrors_jax():
    assert _fields(ModelConfig) == _fields(JaxConfig)


@pytest.mark.parametrize("name", ["h1d-lm-53m", "h1d-lm-144m",
                                  "h1d-lra-encoder", "yi-6b", "qwen2.5-14b",
                                  "llama3.2-1b"])
def test_configs_match_jax(name):
    from repro.configs import get_config as jax_config
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jax_config(name))
    want = dataclasses.asdict(jax_smoke(name))
    got = dataclasses.asdict(get_smoke_config(name))
    want.pop("name"), got.pop("name")
    assert got == want


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_smoke(ARCH)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


def test_params_from_jax_layout(smoke):
    cfg, params, tcfg, tp = smoke
    assert len(tp["layers"]) == cfg.num_layers
    np.testing.assert_array_equal(
        tp["layers"][1]["attn"]["wkv"]["w"].numpy(),
        np.asarray(params["layers"]["attn"]["wkv"]["w"][1]))
    np.testing.assert_array_equal(tp["embed"]["w"].numpy(),
                                  np.asarray(params["embed"]["w"]))
    assert "lm_head" not in tp          # tied embeddings


@pytest.mark.parametrize("S", [5, 40])
def test_forward_logits_match_jax(smoke, S):
    """S=5 < nr runs the M == 0 dense branch through attn_apply's
    padding; S=40 pads to 64 and runs every level."""
    cfg, params, tcfg, tp = smoke
    tok = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))
    want, _ = jax.jit(functools.partial(jax_lm_forward, cfg=cfg))(
        params, tokens=tok)
    got, _ = get_model(tcfg).forward(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_and_decode_match_jax(smoke):
    """Bucket-padded prefill with per-row true lengths, then decode
    steps: logits, next positions and the caches against JAX."""
    cfg, params, tcfg, tp = smoke
    Lmax, S = 64, 16
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    tl = np.array([16, 11], np.int32)
    jf, tf = jax_model(cfg), get_model(tcfg)
    jl, jc, jpos = jax.jit(functools.partial(jf.prefill, cfg=cfg, Lmax=Lmax))(
        params, batch={"tokens": tok}, true_len=tl)
    tl_, tc, tpos = tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                               Lmax, true_len=torch.from_numpy(tl))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for i in range(cfg.num_layers):     # JAX caches are layer-stacked
        want = jax.tree.leaves(jax.tree.map(lambda a: a[i], jc))
        for a, b in zip(want, [tc[i].k, tc[i].v, *tc[i].ck, *tc[i].cv]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    step = jax.jit(functools.partial(jf.decode_step, cfg=cfg))
    pos = tl.copy()
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = step(params, caches=jc, token=nxt, t=pos)
        tl_, tc = tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=ATOL)
        pos = pos + 1


def test_single_row_decode_uses_uniform_path(smoke):
    """B == 1 decodes through the broadcast-t variants: same logits as
    the JAX model."""
    cfg, params, tcfg, tp = smoke
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 9))
    jf, tf = jax_model(cfg), get_model(tcfg)
    jl, jc, pos = jax.jit(functools.partial(jf.prefill, cfg=cfg, Lmax=32))(
        params, batch={"tokens": tok})
    tl_, tc, tpos = tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                               32)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    jl, _ = jax.jit(functools.partial(jf.decode_step, cfg=cfg))(
        params, caches=jc, token=nxt, t=pos)
    tl_, _ = tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt), tpos)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=ATOL)


# ---------------------------------------------------------------------------
# isolation rules
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


_LAUNCHES = {"band_attention_fwd", "band_attention_sub_fwd",
             "band_attention_bwd", "band_attention_sub_bwd",
             "decode_attend_fused", "update_cache_fused", "band_attention",
             "h1d_band_fwd", "h1d_band_sub_fwd", "h1d_band_bwd",
             "h1d_band_sub_bwd", "h1d_decode_attend", "h1d_update_cache",
             "decode_attend_partial", "update_cache_partial",
             "h1d_decode_attend_partial", "h1d_update_cache_partial",
             "check"}


def _called_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            yield f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")


#: what the port never imports: JAX, its bfloat16 numpy type, the JAX
#: package (the machine with the card has none of them)
_FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_catches_no_launch(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                top = a.name.split(".")[0]
                assert top not in _FORBIDDEN, (path, a.name)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top = (node.module or "").split(".")[0]
            assert top not in _FORBIDDEN, (path, node.module)
        elif isinstance(node, ast.Try) and node.handlers:
            calls = {n for stmt in node.body for n in _called_names(stmt)}
            assert not calls & _LAUNCHES, (
                f"{path}: a kernel launch inside try/except "
                f"({sorted(calls & _LAUNCHES)})")


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_wrappers_raise_on_cuda_request_without_card():
    """No card: the entry points refuse a CUDA request and the kernel
    wrappers raise for non-CPU tensors instead of running the plain
    version.  Meta tensors take the wrappers' meta route (empty outputs,
    nothing launched, checked in ``test_torch_launch_plan.py``); with
    that route shut, as it is for a CUDA tensor, the same calls ask for
    the kernel library, which needs a card, and raise."""
    from repro_torch.kernels import _build
    kernels.reset_counts()
    with mock.patch("torch.cuda.is_available", return_value=False), \
            mock.patch.object(_build, "on_meta", return_value=False):
        with pytest.raises(RuntimeError):
            repro_torch.resolve_device()
        with pytest.raises(RuntimeError):
            repro_torch.resolve_device("cuda")
        cfg = get_smoke_config(ARCH)
        with pytest.raises(RuntimeError):
            get_model(cfg).init(cfg, seed=0)
        B, L, d = 2, 32, 8
        q, k, v, w = _meta(B, 1, L, d), _meta(B, L, d), _meta(B, L, d), \
            _meta(B, L)
        # the sub level's coarse operands, valid ones: the wrappers check
        # their operands before they ask for the library
        kc, vc, wc = _meta(B, L // 2, d), _meta(B, L // 2, d), \
            _meta(B, L // 2)
        with pytest.raises(RuntimeError):
            kernels.band_attention_fwd(q, k, v, w, nr=8)
        with pytest.raises(RuntimeError):
            kernels.band_attention_sub_fwd(q, kc, vc, wc, nr=8, ratio=2)
        m = _meta(B, 1, L)
        with pytest.raises(RuntimeError):
            kernels.band_attention_bwd(q, k, v, w, q, m, m, q, m, m, nr=8)
        with pytest.raises(RuntimeError):
            kernels.band_attention_sub_bwd(q, kc, vc, wc, q, m, m, q, m, m,
                                           nr=8, ratio=2)
        cache = thd.H1DCache(_meta(B, L, d), _meta(B, L, d),
                             (_meta(B, L // 2, d),), (_meta(B, L // 2, d),))
        t = torch.empty((B,), dtype=torch.int32, device="meta")
        with pytest.raises(RuntimeError):
            kernels.decode_attend_fused(cache, _meta(B, 1, d), t, nr=8)
        with pytest.raises(RuntimeError):
            kernels.update_cache_fused(cache, _meta(B, d), _meta(B, d), t)
        pool = thd.PagedH1DCache(_meta(6, 8, d), _meta(6, 8, d),
                                 (_meta(6, 8, d),), (_meta(6, 8, d),))
        qpool = thd.QuantPagedH1DCache(*pool, _meta(6, 8), _meta(6, 8),
                                       (_meta(6, 8),), (_meta(6, 8),))
        bidx = torch.empty((B, 3), dtype=torch.int32, device="meta")
        utab = torch.empty((B, 2), dtype=torch.int32, device="meta")
        for p, attend, update in (
                (pool, kernels.decode_attend_paged,
                 kernels.update_cache_paged),
                (qpool, kernels.decode_attend_paged_quant,
                 kernels.update_cache_paged_quant)):
            with pytest.raises(RuntimeError):
                attend(p, _meta(B, 1, d), t, bidx, nr=8)
            with pytest.raises(RuntimeError):
                update(p, _meta(B, d), _meta(B, d), t, utab)
    for kernel, plain in kernels.KERNELS.values():
        assert kernel.launches == 0 and plain.calls == 0
