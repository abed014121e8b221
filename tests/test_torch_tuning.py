"""The port's launch policy (``repro_torch.kernels.tuning``), as
``tests/test_tuning.py`` holds the reference's: the impl enum and its
refusals (engine and CLIs, the reference's text), ``resolve_tq``'s
errors and legalization, corrupt / stale / foreign tables falling back
to the defaults with a warning, table over default and override over
table, a cache hit that skips the (stubbed) measurement, the digest, the
bounded decision log and the unwritable cache.  Plus the committed
defaults against the launchers' rules of today over a sweep of shapes
(``band_fwd_tq``, ``band_dkvw_tiles``, ``sub_bwd_splits``,
``plan_attend_stages``), the candidates, and ``shape_bucket`` /
``table_key`` / ``canonical_impl`` against the reference's on the same
inputs.  Nothing here needs the card: autotuning measures on it, so its
tests stub the runner and the timer."""
import dataclasses
import json
import os
import warnings

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import tuning as jtuning  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import h1d_block as hb  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as dk  # noqa: E402
from repro_torch.kernels import ops, tuning  # noqa: E402
from repro_torch.kernels.tuning import (IMPLS, KernelPolicy,  # noqa: E402
                                        canonical_impl, resolve_tq,
                                        set_policy, table_key)

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fresh_policy(tmp_path):
    """A policy with an isolated on-disk cache, installed as the process
    policy for the duration of the test."""
    p = KernelPolicy(cache_dir=str(tmp_path))
    prev = set_policy(p)
    yield p
    set_policy(prev)


@pytest.fixture
def card_policy(tmp_path):
    """A policy of the ``cuda`` backend (a named card) whose measurement
    is stubbed: the runner makes nothing and the timer counts calls."""
    p = KernelPolicy(backend="cuda", device=CARD, cache_dir=str(tmp_path))
    p.measured = []
    p._band_runner = lambda family, cand, **shape: tuning.tile_of(cand)

    def measure(fn, iters=10, warmup=2):
        p.measured.append(fn)
        return float(len(p.measured))
    p._measure = measure
    return p


def _write_table(policy, family, text=None, payload=None):
    path = policy._table_path(family)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text if text is not None else json.dumps(payload))
    return path


def _table(policy, entries, **over):
    return dict({"version": tuning.TABLE_VERSION, "backend": policy.backend,
                 "device": policy.device, "kernel": "band_fwd",
                 "entries": entries}, **over)


# the default of band_tq(L=64, nr=16, mode="l0_bidir"): B = G = 1 fill 4
# CTAs, so band_fwd_tq halves to 16
DEFAULT_TQ = hb.band_fwd_tq("l0_bidir", 1, 1, 64, 64, 64, 16)


# ---------------------------------------------------------------------------
# the impl enum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [*IMPLS, "pallas_interp", "triton", "",
                                  "AUTO"])
def test_canonical_impl_matches_the_reference(impl):
    """The same strings pass, and the same fail with the same text."""
    def outcome(fn):
        try:
            return ("ok", fn(impl))
        except ValueError as e:
            return ("error", str(e))
    assert outcome(canonical_impl) == outcome(jtuning.canonical_impl)
    assert IMPLS == jtuning.IMPLS


def test_unknown_decode_impl_refused_like_the_reference():
    """One bad string: the same ValueError from both packages' engines,
    before any weight is read; the port's CLIs refuse it too."""
    from repro.configs import get_smoke_config as jconfig
    from repro.serve.engine import ServeEngine as JEngine
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.serve import ServeEngine

    bad = "pallas_interp"
    texts = []
    for engine, cfg in ((ServeEngine, get_smoke_config("h1d-lm-53m")),
                        (JEngine, jconfig("h1d-lm-53m"))):
        with pytest.raises(ValueError, match="allowed impls") as e:
            engine(dataclasses.replace(cfg, decode_impl=bad), None)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    for main, flag in ((serve_cli.main, "--decode-impl"),
                       (train_cli.main, "--attn-impl")):
        with pytest.raises(ValueError, match="allowed impls") as e:
            main(["--smoke", "--device", "cpu", flag, bad])
        assert str(e.value) == texts[0]


def test_resolve_impl_validates_and_selects_nothing(fresh_policy):
    for impl in IMPLS:
        assert fresh_policy.resolve_impl(impl) == impl
    assert fresh_policy.decisions[-1]["config"] == {"impl": "auto",
                                                    "backend": "cpu"}
    with pytest.raises(ValueError, match="allowed impls"):
        fresh_policy.resolve_impl("triton")


# ---------------------------------------------------------------------------
# resolve_tq, shape_bucket, table_key
# ---------------------------------------------------------------------------

def test_resolve_tq_L_not_multiple_of_nr():
    with pytest.raises(ValueError,
                       match=r"mode=coarse_causal, ratio=1.*L=100.*nr=16"):
        resolve_tq(100, 16, 128, "coarse_causal")


def test_resolve_tq_hint_below_every_tile():
    with pytest.raises(ValueError, match=r"mode=l0_bidir, ratio=1.*tq hint 8"):
        resolve_tq(64, 16, 8, "l0_bidir")


def test_resolve_tq_legalizes_hint():
    # the largest tile at or below the hint; the sub level's is fixed
    assert resolve_tq(64, 16, 512, "l0_bidir") == hb.BAND_TQ
    assert resolve_tq(64, 16, 31, "l0_causal") == 16
    assert resolve_tq(128, 16, 8, "sub", ratio=2) == hb.SUB_TQ
    # a tile whose shared memory does not fit is no candidate: at nr 16,
    # d 336 the 32-row tile exceeds the H100's 227 KB, 16 rows fit
    assert 4 * hb.band_fwd_floats("l0_bidir", 32, 336, 336, 16) > \
        hb.SMEM_MAX
    assert resolve_tq(128, 16, 32, "l0_bidir", d=336) == 16


@pytest.mark.parametrize("L", [1, 2, 3, 64, 65, 100, 1024, 4097])
@pytest.mark.parametrize("mode,ratio,dtype", [
    ("l0_causal", 1, "float32"), ("sub", 8, "float32"),
    ("coarse_bidir", 1, "bfloat16")])
def test_bucket_and_key_match_the_reference(L, mode, ratio, dtype):
    assert tuning.shape_bucket(L) == jtuning.shape_bucket(L)
    assert table_key(L, 16, mode, ratio, dtype) == \
        jtuning.table_key(L, 16, mode, ratio, dtype)


# ---------------------------------------------------------------------------
# tables: corrupt / stale / foreign, table over default, override over both
# ---------------------------------------------------------------------------

def test_corrupt_table_warns_and_uses_default(fresh_policy):
    _write_table(fresh_policy, "band_fwd", text="{not json!")
    with pytest.warns(RuntimeWarning, match="corrupt tuning table"):
        tq = fresh_policy.band_tq(L=64, nr=16, mode="l0_bidir")
    assert tq == DEFAULT_TQ
    assert fresh_policy.decisions[-1]["source"] == "default"


def test_version_mismatch_warns_and_uses_default(fresh_policy):
    key = table_key(64, 16, "l0_bidir")
    _write_table(fresh_policy, "band_fwd", payload=_table(
        fresh_policy, {key: {"tq": 32}}, version=999))
    with pytest.warns(RuntimeWarning, match="version"):
        tq = fresh_policy.band_tq(L=64, nr=16, mode="l0_bidir")
    assert tq == DEFAULT_TQ


@pytest.mark.parametrize("over", [{"backend": "not-a-backend"},
                                  {"device": "NVIDIA A100-SXM4-80GB"}])
def test_foreign_table_warns_and_uses_default(tmp_path, over):
    """Another backend's table, or another card's, is ignored."""
    p = KernelPolicy(backend="cuda", device=CARD, cache_dir=str(tmp_path))
    key = table_key(64, 16, "l0_bidir")
    _write_table(p, "band_fwd", payload=_table(p, {key: {"tq": 32}}, **over))
    with pytest.warns(RuntimeWarning, match="backend"):
        assert p.band_tq(L=64, nr=16, mode="l0_bidir") == DEFAULT_TQ


def test_valid_table_entry_wins_over_default(fresh_policy):
    key = table_key(64, 16, "l0_bidir")
    _write_table(fresh_policy, "band_fwd", payload=_table(
        fresh_policy, {key: {"tq": 32}}))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a valid table must not warn
        assert fresh_policy.band_tq(L=64, nr=16, mode="l0_bidir") == 32
    assert fresh_policy.decisions[-1]["source"] == "table"


def test_override_bypasses_table(fresh_policy):
    key = table_key(64, 16, "l0_bidir")
    _write_table(fresh_policy, "band_fwd", payload=_table(
        fresh_policy, {key: {"tq": 32}}))
    assert fresh_policy.band_tq(L=64, nr=16, mode="l0_bidir",
                                override=16) == 16
    assert fresh_policy.decisions[-1]["source"] == "override"
    # an override that fits no launch is refused, naming the candidates
    with pytest.raises(ValueError, match="candidates"):
        fresh_policy.resolve("band_bwd", override=8, L=64, nr=16,
                             mode="l0_bidir", d=16, dv=16)


# ---------------------------------------------------------------------------
# autotune: cache hits, the round trip, the CPU refusal, the digest
# ---------------------------------------------------------------------------

def test_autotune_cache_hit_skips_measurement(card_policy):
    p = card_policy
    e1 = p.autotune_band(L=64, nr=16, mode="l0_causal", d=16)
    n_first = len(p.measured)
    assert n_first == len(p.candidates("band_fwd", L=64, nr=16,
                                       mode="l0_causal", d=16))
    assert e1["source"] == "measured" and e1["tq"] == 16  # first wins
    assert [m[0] for m in e1["measured"]] == [{"tq": 16}, {"tq": 32}]
    # same policy, same shape bucket: in-memory table hit, zero measures
    assert p.autotune_band(L=64, nr=16, mode="l0_causal", d=16)["tq"] == 16
    assert len(p.measured) == n_first
    # fresh policy over the same cache dir: on-disk hit, zero measures
    p2 = KernelPolicy(backend="cuda", device=CARD, cache_dir=p.cache_dir)
    p2._measure = None
    assert p2.autotune_band(L=64, nr=16, mode="l0_causal", d=16)["tq"] == 16
    assert p2.decisions[-1]["source"] == "table"


def test_autotune_round_trip_applies_the_table(card_policy):
    """Every backward candidate measured, the table persisted with the
    card's name, a fresh policy resolving from it (source ``table``)."""
    p = card_policy
    d0 = p.tuning_digest()
    entry = p.autotune_band(L=256, nr=16, mode="l0_causal", d=16,
                            family="band_bwd")
    with open(p._table_path("band_bwd")) as f:
        table = json.load(f)
    assert table["device"] == CARD and table["backend"] == "cuda"
    key = table_key(256, 16, "l0_causal")
    assert table["entries"][key]["source"] == "measured"
    p2 = KernelPolicy(backend="cuda", device=CARD, cache_dir=p.cache_dir)
    assert p2.tuning_digest() != d0
    cfg, src = p2.resolve("band_bwd", L=256, nr=16, mode="l0_causal", d=16,
                          dv=16)
    assert src == "table"
    assert tuning.tile_of(cfg) == tuning.tile_of(entry)


def test_autotune_refuses_the_cpu(fresh_policy):
    with pytest.raises(RuntimeError, match="on the card"):
        fresh_policy.autotune_band(L=64, nr=16, mode="l0_causal", d=16)


def test_tuning_digest_tracks_tables_and_kernels(card_policy):
    from repro_torch.kernels import _build
    d0 = card_policy.tuning_digest()
    assert len(d0) == 12 and int(d0, 16) >= 0
    assert KernelPolicy(backend="cuda", device=CARD,
                        cache_dir=card_policy.cache_dir).tuning_digest() == d0
    card_policy.autotune_band(L=64, nr=16, mode="sub", ratio=2, d=16,
                              family="sub_bwd")
    assert KernelPolicy(backend="cuda", device=CARD,
                        cache_dir=card_policy.cache_dir).tuning_digest() != d0
    _build.kernels_digest.cache_clear()
    try:
        real = _build.kernels_digest()
        _build.kernels_digest.cache_clear()
        orig = _build.NVCC_FLAGS
        _build.NVCC_FLAGS = orig + ("-lineinfo",)
        try:
            assert _build.kernels_digest() != real
        finally:
            _build.NVCC_FLAGS = orig
            _build.kernels_digest.cache_clear()
    finally:
        assert _build.kernels_digest() == real


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

def test_candidates_enumeration(fresh_policy):
    p = fresh_policy
    assert [c["tq"] for c in p.candidates("band_fwd", L=256, nr=16,
                                          mode="l0_bidir", d=64)] == [16, 32]
    bwd = p.candidates("band_bwd", L=1024, nr=16, mode="l0_causal", d=64,
                       B=64)
    assert {(c["tq"], c["nkb"], c["tk"]) for c in bwd} == {
        (t, n, k) for t in (16, 32) for n in (1, 2) for k in (16, 32)}
    assert [c["splits"] for c in p.candidates(
        "sub_bwd", L=1024, nr=16, mode="sub", ratio=8, d=64)] == [1, 2]
    assert [c["splits"] for c in p.candidates(
        "sub_bwd", L=1024, nr=16, mode="sub", ratio=2, d=64)] == [1]
    (fixed,) = p.candidates("sub_fwd", L=256, nr=16, mode="sub", ratio=2)
    assert fixed["tq"] == hb.SUB_TQ and fixed["fixed"]
    (stream,) = p.candidates("band_fwd", L=4096, nr=1024, mode="l0_causal",
                             d=256)
    assert stream["layout"] == "stream" and stream["fixed"]
    att = p.candidates("decode_attend", G=1, d=64, dv=64, nr=16, levels=7)
    assert att[0]["layout"] == "resident" and att[0]["cr"] == 16
    assert all(c["stages"] >= 2 for c in att)
    assert p.candidates("decode_update", rows=7) == [{"grid": (7,),
                                                      "fixed": True}]
    with pytest.raises(ValueError, match="allowed families"):
        p.candidates("nope", L=64, nr=16)
    assert set(tuning.FAMILIES) == set(
        __import__("repro_torch.kernels", fromlist=["FAMILY"])
        .FAMILY.values())


# ---------------------------------------------------------------------------
# the defaults are the launchers' rules
# ---------------------------------------------------------------------------

BAND_SWEEP = [(mode, B, G, L, d, nr)
              for mode in ("l0_causal", "l0_bidir", "coarse_bidir")
              for B, G in ((1, 1), (8, 2), (64, 1), (4, 7))
              for L, nr in ((64, 16), (1024, 16), (256, 8), (512, 64))
              for d in (16, 64, 128)
              if (mode.startswith("l0") or L // nr & (L // nr - 1) == 0)
              and hb.band_body_takes(mode, nr, d, d)]


@pytest.mark.parametrize("mode,B,G,L,d,nr", BAND_SWEEP)
def test_band_defaults_are_todays_rules(mode, B, G, L, d, nr):
    p = KernelPolicy(cache_dir="/nonexistent-tune-cache")
    shape = dict(L=L, nr=nr, mode=mode, B=B, G=G, d=d, dv=d)
    fwd, src = p.resolve("band_fwd", **shape)
    assert src == "default"
    assert fwd["tq"] == hb.band_fwd_tq(mode, B, G, L, d, d, nr)
    bwd, _ = p.resolve("band_bwd", **shape)
    nkb, tk = hb.band_dkvw_tiles(mode, B, L, d, d, nr)
    assert (bwd["tq"], bwd["nkb"], bwd["tk"]) == (
        hb.band_fwd_tq(mode, B, G, L, d, d, nr, backward=True), nkb, tk)
    # every default is one of the family's candidates
    for fam, cfg in (("band_fwd", fwd), ("band_bwd", bwd)):
        assert tuning.tile_of(cfg) in [tuning.tile_of(c)
                                       for c in p.candidates(fam, **shape)]


@pytest.mark.parametrize("G,ratio,nr", [(1, 2, 16), (1, 8, 16), (2, 32, 16),
                                        (7, 64, 16), (8, 4, 8), (1, 16, 4)])
def test_sub_defaults_are_todays_rules(G, ratio, nr):
    p = KernelPolicy(cache_dir="/nonexistent-tune-cache")
    L = 64 * nr
    shape = dict(L=L, nr=nr, mode="sub", ratio=ratio, G=G, d=64, dv=64)
    cfg, _ = p.resolve("sub_bwd", **shape)
    assert cfg["splits"] == hb.sub_bwd_splits(G, nr * ratio)
    assert tuning.tile_of(cfg) in [tuning.tile_of(c)
                                   for c in p.candidates("sub_bwd", **shape)]
    assert p.resolve("sub_fwd", **shape)[0]["tq"] == hb.SUB_TQ
    cc, _ = p.resolve("band_bwd", L=L, nr=nr, mode="coarse_causal", G=G,
                      d=64, dv=64)
    assert cc["splits"] == hb.sub_bwd_splits(G, nr)


@pytest.mark.parametrize("G,D,Dv,nr,nlev,quant,half", [
    (1, 64, 64, 16, 7, False, False), (8, 128, 128, 16, 8, False, True),
    (2, 256, 256, 16, 8, False, True), (1, 64, 64, 16, 7, True, False),
    (2, 256, 256, 64, 12, False, False), (4, 60, 36, 16, 5, False, False),
    (1, 64, 64, 4, 6, True, False), (5, 128, 128, 16, 8, False, True)])
def test_attend_defaults_are_todays_plan(G, D, Dv, nr, nlev, quant, half):
    p = KernelPolicy(cache_dir="/nonexistent-tune-cache")
    plan = dk.plan_attend_stages(G, D, Dv, nr, nlev, quant, half)
    shape = dict(G=G, d=D, dv=Dv, nr=nr, levels=nlev, quant=quant,
                 dtype="bfloat16" if half else "float32")
    for fam in tuning.ATTEND_FAMILIES:
        cfg, src = p.resolve(fam, **shape)
        assert src == "default"
        assert (cfg["cr"], cfg["stages"], cfg["resident"]) == (
            plan.chunk_rows, plan.stages, plan.resident)
        assert cfg["cr"] in [c["cr"] for c in p.candidates(fam, **shape)]
    # a forced chunk: the plan the launcher would build for it
    for cand in p.candidates("decode_attend", **shape):
        forced = dk.plan_attend_stages(G, D, Dv, nr, nlev, quant, half,
                                       cr=cand["cr"])
        assert (forced.stages, forced.smem) == (cand["stages"],
                                                cand["vmem_bytes"])
        assert forced.smem <= dk.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the decision log and the cache directory
# ---------------------------------------------------------------------------

def test_decision_log_bounded(fresh_policy):
    p = fresh_policy
    assert p.decisions.maxlen == 512
    for i in range(700):
        p._log("band_fwd", f"k{i}", "default", {"tq": 16})
    assert len(p.decisions) == 512
    assert p.decisions[0]["key"] == "k188"   # oldest 188 evicted
    assert p.decisions[-1]["key"] == "k699"


def test_unwritable_cache_degrades_to_memory(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where the cache dir should be")
    p = KernelPolicy(backend="cuda", device=CARD,
                     cache_dir=str(blocker / "cache"))
    p._band_runner = lambda family, cand, **shape: None
    p._measure = lambda fn, iters=10, warmup=2: 1.0
    with pytest.warns(RuntimeWarning, match="in memory"):
        entry = p.autotune_band(L=64, nr=16, mode="l0_causal", d=16)
    assert entry["source"] == "measured"
    assert not os.path.exists(p._table_path("band_fwd"))
    assert p.band_tq(L=64, nr=16, mode="l0_causal", d=16) == entry["tq"]
    assert p._entries("band_fwd")[table_key(64, 16, "l0_causal")]["tq"] \
        == entry["tq"]


def test_tune_cache_malformed_env_warns_and_defaults(monkeypatch, tmp_path):
    for bad in ("   ", "a\0b"):
        monkeypatch.setattr(os, "environ", {"REPRO_TUNE_CACHE": bad})
        with pytest.warns(RuntimeWarning, match="REPRO_TUNE_CACHE"):
            p = KernelPolicy()
        assert p.cache_dir == os.path.expanduser("~/.cache/repro_tune")
    monkeypatch.setattr(os, "environ", {"REPRO_TUNE_CACHE": str(tmp_path)})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert KernelPolicy().cache_dir == str(tmp_path)


def test_save_table_bad_dir_degrades_gracefully():
    p = KernelPolicy(cache_dir="cache\0dir")
    p._tables["band_fwd"] = {"x": {"tq": 16}}
    with pytest.warns(RuntimeWarning, match="cannot persist"):
        assert p._save_table("band_fwd") is None


# ---------------------------------------------------------------------------
# the CPU path asks the policy nothing
# ---------------------------------------------------------------------------

def test_cpu_path_asks_nothing_and_ignores_tq(fresh_policy):
    """On CPU tensors ``band_attention(tq=)`` runs the plain versions,
    bit for bit those without it, forward and backward, and the policy
    logs nothing."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 64, 8), generator=gen, requires_grad=True)
    k = torch.randn((1, 64, 8), generator=gen)
    v = torch.randn((1, 64, 8), generator=gen)
    w = torch.ones((1, 64))
    outs = []
    for tq in (None, 16):
        y, dn, m = ops.band_attention(q, k, v, w, nr=16, mode="l0_causal",
                                      tq=tq)
        (g,) = torch.autograd.grad(y.sum() + dn.sum(), q)
        outs.append((y, dn, m, g))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert len(fresh_policy.decisions) == 0


def test_rerouted_plain_versions_take_no_tile(monkeypatch):
    """``ops.band_attention`` looks its callables up at call time, so a
    plain version put in a wrapper's place (as ``chip_smoke.py`` runs the
    plain path on the card) still serves it: with no ``tq`` it is handed
    no tile."""
    from repro_torch.kernels import h1d_block_bwd as hbb
    for mod, names in ((hb, ("band_attention_fwd", "band_attention_sub_fwd")),
                       (hbb, ("band_attention_bwd",
                              "band_attention_sub_bwd"))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name + "_ref"))
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 1, 64, 8), generator=gen, requires_grad=True)
    k, v = torch.randn((1, 64, 8), generator=gen), torch.randn(
        (1, 64, 8), generator=gen)
    w = torch.ones((1, 64))
    for mode, ratio, Lk in (("l0_causal", 1, 64), ("sub", 2, 32)):
        y, dn, m = ops.band_attention(q, k[:, :Lk], v[:, :Lk], w[:, :Lk],
                                      nr=16, mode=mode, ratio=ratio)
        (g,) = torch.autograd.grad(y.sum() + dn.sum(), q)
        assert torch.isfinite(g).all()


def test_defaults_without_the_committed_file(tmp_path):
    """An unreadable defaults file warns, and every family's default is
    still its launcher's rule."""
    with pytest.warns(RuntimeWarning, match="defaults unreadable"):
        p = KernelPolicy(cache_dir=str(tmp_path),
                         defaults_path=str(tmp_path / "missing.json"))
    q = KernelPolicy(cache_dir=str(tmp_path))
    for fam, shape in (
            ("band_fwd", dict(L=1024, nr=16, mode="l0_causal", B=64)),
            ("band_bwd", dict(L=1024, nr=16, mode="coarse_bidir", B=8)),
            ("band_bwd", dict(L=1024, nr=16, mode="coarse_causal", G=4)),
            ("band_fwd", dict(L=4096, nr=1024, mode="l0_causal", d=256,
                              dv=256)),
            ("sub_bwd", dict(L=1024, nr=16, mode="sub", ratio=16, G=2)),
            ("decode_attend", dict(G=1, d=64, dv=64, nr=16, levels=7))):
        assert p.resolve(fam, **shape) == q.resolve(fam, **shape)
