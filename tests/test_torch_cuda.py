"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a card every test here skips, so they
count nowhere on a CPU run.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

These cover shapes the serving smoke (``chip_smoke.py``) does not: GQA
groups G > 1, nr = 8, head widths that are not a multiple of 32, weight-0
keys and fully masked rows, every mask edge of the decode positions.
Tolerances as in ``chip_smoke.py``: attention within 1e-5 scaled by
max(1, |plain|) (fp32 on both sides, another summation order), cache
updates bit-exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import h1d_decode as hd  # noqa: E402
from repro_torch.core import hierarchy as hc  # noqa: E402
from repro_torch.kernels import h1d_block as hb  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as dk  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        err = ((x.double() - y.double()).abs()
               / y.double().abs().clamp(min=1.0)).max()
        assert float(err) <= TOL, float(err)


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev)


@pytest.mark.parametrize("B,G,L,d,dv,nr", [
    (3, 1, 64, 64, 64, 16), (2, 2, 128, 16, 16, 8), (2, 4, 32, 40, 24, 8),
    (1, 2, 256, 128, 128, 32), (2, 1, 64, 8, 72, 4)])
def test_band_fwd_matches_plain(dev, B, G, L, d, dv, nr):
    gen = torch.Generator(device=dev).manual_seed(L + G)
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    k = _randn(gen, dev, B, L, d)
    w = torch.ones((B, L), device=dev)
    w[0, L // 2:] = 0.0                        # padded tail
    w[-1, : 2 * nr] = 0.0                      # masked head: empty rows
    v = _randn(gen, dev, B, L, dv) * w[..., None]
    got = hb.band_attention_fwd(q, k, v, w, nr=nr)
    _close(got, hb.band_attention_fwd_ref(q, k, v, w, nr=nr))
    # rows whose every key has weight 0 give m = -1e30, y = 0, dn = 0
    y, dn, m = got
    assert torch.all(m[-1, :, :nr] == hb._MIN_M)
    assert not y[-1, :, :nr].any() and not dn[-1, :, :nr].any()


@pytest.mark.parametrize("G,L,d,nr", [(1, 256, 64, 16), (2, 128, 16, 8),
                                      (3, 64, 40, 4)])
def test_band_sub_fwd_matches_plain_every_level(dev, G, L, d, nr):
    gen = torch.Generator(device=dev).manual_seed(G * L)
    B = 2
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    kc = _randn(gen, dev, B, L, d)
    wc = torch.ones((B, L), device=dev)
    wc[1, L - 20:] = 0.0
    vc = _randn(gen, dev, B, L, d) * wc[..., None]
    for lvl in range(1, hc.num_levels(L, nr)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc)
        wc = hc.coarsen_sum(wc, axis=-1)
        args = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        _close(hb.band_attention_sub_fwd(*args, nr=nr, ratio=1 << lvl),
               hb.band_attention_sub_fwd_ref(*args, nr=nr, ratio=1 << lvl))


def _ts(Lmax, nr):
    M = hc.num_levels(Lmax, nr)
    span = nr << max(M - 1, 1)
    ts = {0, 1, nr - 1, nr, 2 * nr - 1, span - 1, span,
          span + span // 2 - 1, span + span // 2, Lmax - 1}
    ts |= set(np.random.default_rng(Lmax).integers(0, Lmax, 6).tolist())
    return sorted(t % Lmax for t in ts)


@pytest.mark.parametrize("Lmax,nr,G,D,Dv", [
    (2048, 16, 1, 64, 64), (256, 8, 4, 16, 16), (512, 16, 2, 40, 24),
    (64, 8, 1, 16, 16), (16, 16, 2, 16, 16)])
def test_decode_attend_matches_plain(dev, Lmax, nr, G, D, Dv):
    gen = torch.Generator(device=dev).manual_seed(Lmax + G)
    ts = _ts(Lmax, nr)
    R = len(ts)
    cache = hd.prefill_cache(_randn(gen, dev, R, Lmax, D),
                             _randn(gen, dev, R, Lmax, Dv), Lmax, nr)
    q = _randn(gen, dev, R, G, D)
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    _close([dk.decode_attend_fused(cache, q, t, nr=nr)],
           [dk.decode_attend_ref(cache, q, t, nr=nr)])


@pytest.mark.parametrize("Lmax,nr,D,Dv", [(2048, 16, 64, 64),
                                          (128, 8, 16, 40), (16, 16, 8, 8)])
def test_update_cache_bit_exact(dev, Lmax, nr, D, Dv):
    gen = torch.Generator(device=dev).manual_seed(Lmax)
    R = 8
    base = hd.prefill_cache(_randn(gen, dev, R, Lmax, D),
                            _randn(gen, dev, R, Lmax, Dv), Lmax, nr)

    def clone(c):
        return hd.H1DCache(c.k.clone(), c.v.clone(),
                           tuple(a.clone() for a in c.ck),
                           tuple(a.clone() for a in c.cv))
    a, b = clone(base), clone(base)
    for step in range(5):
        t = torch.randint(0, Lmax, (R,), generator=gen, device=dev,
                          dtype=torch.int32)
        kn, vn = _randn(gen, dev, R, D), _randn(gen, dev, R, Dv)
        dk.update_cache_fused(a, kn, vn, t)
        dk.update_cache_ref(b, kn, vn, t)
        for x, y in zip((a.k, a.v, *a.ck, *a.cv), (b.k, b.v, *b.ck, *b.cv)):
            assert torch.equal(x, y)


def test_wrappers_validate_operands(dev):
    q = torch.zeros((1, 1, 32, 8), device=dev)
    k = torch.zeros((1, 32, 8), device=dev)
    w = torch.ones((1, 32), device=dev)
    with pytest.raises(ValueError):            # non-contiguous
        hb.band_attention_fwd(q, k.transpose(1, 2).contiguous()
                              .transpose(1, 2), k, w, nr=8)
    with pytest.raises(ValueError):            # wrong dtype
        hb.band_attention_fwd(q.double(), k, k, w, nr=8)
    with pytest.raises(NotImplementedError):   # mode of a later slice
        hb.band_attention_fwd(q, k, k, w, nr=8, mode="l0_bidir")


def test_smoke_engine_on_card_matches_cpu(dev):
    """The smoke model serves the same greedy tokens on the card (every
    kernel launched, no plain version run) as on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_smoke_config("h1d-lm-53m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 30, 9, 17, 40)]
    outs = {}
    for device in ("cpu", "cuda"):
        params = get_model(cfg).init(cfg, seed=2, device=device)
        eng = ServeEngine(cfg, params, slots=2, max_len=64)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_counts()
        eng.run()
        outs[device] = [r.out_tokens for r in reqs]
        if device == "cuda":
            for kernel, plain in kernels.KERNELS.values():
                assert kernel.launches > 0 and plain.calls == 0
    assert outs["cuda"] == outs["cpu"]
