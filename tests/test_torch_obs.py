"""Port parity of the telemetry layer (``repro_torch.obs``) against the
JAX package's ``repro.obs`` on the CPU, and the port's launch records and
analytic traffic model.

* The registry, the Prometheus text and the trace events of the same
  seeded sequence of operations are equal in both packages (exactly;
  histogram quantiles to 1e-12), and the port's documents pass the
  reference's validators, which give the port's validators' verdicts on
  broken documents.
* The port's ``JsonlEmitter`` emits on its first call on a host whose
  monotonic clock reads less than the period (the reference's skips it:
  ROADMAP C).
* ``record_hbm_bytes`` of every band record equals ``band_bytes`` /
  ``sub_bytes`` on all-ones key weights, its FLOPs the pairs
  ``band_mask`` admits times the per-pair counts; on PERF.md's LM and
  LRA shapes and its decode rows the bytes are the table's all-rows
  figures.  Every record function runs on ``meta`` tensors, so it reads
  no tensor data.
"""
import ctypes
import json
import math
import time

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import obs as robs  # noqa: E402
from repro.obs import export as rexport  # noqa: E402
from repro_torch import kernels, obs  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.core import h1d_decode as hd  # noqa: E402
from repro_torch.core import hierarchy as hc  # noqa: E402
from repro_torch.kernels import h1d_block as hb  # noqa: E402
from repro_torch.kernels import h1d_block_bwd as hbb  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.obs import export, metrics, traffic  # noqa: E402

META = torch.device("meta")
HBM = 3.35e12          # the H100's bytes/s, as chip_smoke.py bounds


@pytest.fixture(autouse=True)
def _clean_obs():
    """Both packages' telemetry off and empty around every test."""
    for o in (obs, robs):
        o.disable()
        o.reset()
    yield
    for o in (obs, robs):
        o.disable()
        o.reset()


# -- disabled path -----------------------------------------------------------

def test_disabled_accessors_return_shared_stubs():
    assert not obs.enabled() and not contracts.ACTIVE
    assert obs.counter("serve.ticks") is obs.NULL_COUNTER
    assert obs.counter("other", family="x") is obs.NULL_COUNTER
    assert obs.gauge("pool.occupancy") is obs.NULL_GAUGE
    assert obs.histogram("serve.ttft_s") is obs.NULL_HISTOGRAM
    assert obs.span("serve.tick") is obs.NULL_SPAN
    obs.counter("serve.ticks").inc()
    obs.gauge("pool.occupancy").set(0.5)
    obs.histogram("serve.ttft_s").observe(1.0)
    with obs.span("serve.tick"):
        pass
    obs.instant("kernel.launch")
    assert metrics.registry().snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}
    assert len(obs.tracing.buffer()) == 0


def test_disabled_overhead_is_tiny():
    """The reference test's bound: 1e5 instrumented iterations of the
    disabled path, each with a kernel wrapper's record branch, in under
    two seconds."""
    n = 100_000
    rec = 0
    t0 = time.perf_counter()
    for _ in range(n):
        obs.counter("serve.ticks").inc()
        obs.gauge("serve.queue_depth").set(3)
        obs.histogram("serve.itl_s").observe(1e-3)
        if contracts.ACTIVE:
            rec += 1
    dt = time.perf_counter() - t0
    assert rec == 0
    assert dt < 2.0, f"{n} disabled-path iterations took {dt:.2f}s"


def test_enable_hooks_and_disable_unhooks_the_launch_record():
    obs.enable()
    assert contracts.ACTIVE and traffic.on_launch in contracts._LAUNCH_HOOKS
    obs.enable()                                     # idempotent
    assert contracts._LAUNCH_HOOKS.count(traffic.on_launch) == 1
    obs.disable()
    assert not contracts.ACTIVE
    with contracts.capture() as buf:
        assert contracts.ACTIVE
    assert not contracts.ACTIVE and buf == []


def test_cpu_wrappers_record_nothing():
    """The plain versions launch nothing: with telemetry on and a capture
    open, a CPU call hands over no record and counts no kernel."""
    obs.enable()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 1, 32, 4), generator=gen)
    k, v = torch.randn((1, 32, 4), generator=gen), torch.randn((1, 32, 4))
    w = torch.ones((1, 32))
    with contracts.capture() as buf:
        out = hb.band_attention_fwd(q, k, v, w, nr=8)
        hbb.band_attention_bwd(q, k, v, w, *out,
                               *[torch.ones_like(t) for t in out], nr=8)
    assert buf == []
    assert metrics.registry().snapshot()["counters"] == {}


# -- registry parity ---------------------------------------------------------

KINDS = {"serve.ticks": "counter", "kernel.launches": "counter",
         "pool.occupancy": "gauge", "serve.queue_depth": "gauge",
         "serve.ttft_s": "histogram", "serve.itl_s": "histogram",
         "train.step_s": "histogram"}
LABELS = [{}, {"family": "band_fwd"}, {"family": "decode_attend"},
          {"op": "h1d_attention", "shards": 2}]


def _ops(seed, n=3000):
    """A seeded sequence of registry operations: (kind, name, labels,
    value, boundaries).  ``serve.itl_s`` takes more observations than a
    reservoir holds (the bucket fallback)."""
    rng = np.random.default_rng(seed)
    names = sorted(KINDS)
    out = []
    for _ in range(n):
        name = names[rng.integers(len(names))]
        labels = LABELS[rng.integers(len(LABELS))]
        kind = KINDS[name]
        if kind == "counter":
            val = int(rng.integers(0, 5))
        elif kind == "gauge":
            val = float(rng.normal())
        else:
            val = float(rng.exponential(0.01))
        bounds = (1e-3, 1e-2, 0.1) if name == "train.step_s" else None
        out.append((kind, name, labels, val, bounds))
    for _ in range(1100):
        out.append(("histogram", "serve.itl_s", {}, float(rng.uniform(
            1e-4, 1e-1)), None))
    return out


def _apply(o, ops):
    for kind, name, labels, val, bounds in ops:
        if kind == "counter":
            o.counter(name, **labels).inc(val)
        elif kind == "gauge":
            o.gauge(name, **labels).set(val)
        elif bounds is None:
            o.histogram(name, **labels).observe(val)
        else:
            o.histogram(name, boundaries=bounds, **labels).observe(val)


def _split_quantiles(snap):
    q = {}
    for key, h in snap["histograms"].items():
        q[key] = (h.pop("p50"), h.pop("p99"))
    return q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_matches_reference(seed):
    ops = _ops(seed)
    for o in (obs, robs):
        o.enable()
        _apply(o, ops)
    got = metrics.registry().snapshot()
    want = robs.metrics.registry().snapshot()
    assert not robs.metrics.registry()._metrics[("serve.itl_s", "")].exact
    gq, wq = _split_quantiles(got), _split_quantiles(want)
    assert got == want
    assert gq.keys() == wq.keys()
    for key in gq:
        for a, b in zip(gq[key], wq[key]):
            assert a == pytest.approx(b, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("keep,n", [(200, 200), (8, 100)])
def test_histogram_quantiles_match_reference(keep, n):
    """Exact quantiles while the reservoir holds every observation, the
    bucket interpolation after it overflows."""
    rng = np.random.default_rng(keep)
    xs = rng.exponential(0.01, size=n)
    got = obs.Histogram(keep_samples=keep)
    want = robs.Histogram(keep_samples=keep)
    for x in xs:
        got.observe(float(x))
        want.observe(float(x))
    assert got.exact == want.exact == (keep >= n)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == pytest.approx(want.quantile(q), rel=1e-12)
    assert got.cumulative() == want.cumulative()
    if got.exact:
        assert got.quantile(0.5) == pytest.approx(np.median(xs), rel=1e-12)


def test_kind_conflict_and_bad_boundaries_raise_as_reference():
    for o in (obs, robs):
        o.enable()
    errs = []
    for o in (obs, robs):
        o.counter("kernel.launches", family="band_fwd").inc()
        with pytest.raises(TypeError) as e:
            o.gauge("kernel.launches", family="band_fwd")
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    with pytest.raises(ValueError):
        obs.Histogram(boundaries=(1.0, 0.5))
    assert metrics.DEFAULT_BUCKETS == robs.metrics.DEFAULT_BUCKETS
    assert metrics.DEFAULT_KEEP_SAMPLES == robs.metrics.DEFAULT_KEEP_SAMPLES


# -- documents ---------------------------------------------------------------

def _populate(o):
    o.enable()
    o.counter("serve.ticks").inc(4)
    o.counter("kernel.launches", family="decode_attend").inc()
    o.counter("sp.dispatches", op="decode_attend", shards=2).inc(3)
    o.gauge("pool.occupancy").set(0.5)
    for v in (1e-3, 2e-3, 5e-3, math.inf):
        o.histogram("serve.ttft_s").observe(v)
    o.histogram("train.step_s", boundaries=(0.1, 1.0)).observe(0.5)
    with o.span("serve.tick", tid=o.TRACK_SERVE, args={"n": 2}):
        with o.span("serve.decode", tid=o.TRACK_SERVE):
            pass
    with o.span("train.step", tid=o.TRACK_TRAIN, args={"step": 0}):
        pass
    o.instant("kernel.launch", tid=o.TRACK_KERNELS,
              args={"family": "decode_attend", "grid": [4],
                    "hbm_read_bytes": 1024, "hbm_write_bytes": 64,
                    "flops": 2048})


def test_prometheus_text_matches_reference_line_for_line():
    for o in (obs, robs):
        _populate(o)
    text = export.prometheus_text()
    assert text.splitlines() == rexport.prometheus_text().splitlines()
    need = ("repro_serve_ticks_total", "repro_pool_occupancy",
            "repro_serve_ttft_s_bucket", "repro_kernel_launches_total")
    assert export.validate_prometheus_text(text, need) == []
    assert rexport.validate_prometheus_text(text, need) == []


def _events(doc):
    return [{k: e.get(k) for k in ("name", "ph", "tid", "args")}
            for e in doc["traceEvents"]]


def test_chrome_trace_matches_reference_without_timestamps(tmp_path):
    for o in (obs, robs):
        _populate(o)
    export.write_trace(str(tmp_path / "port.json"))
    rexport.write_trace(str(tmp_path / "ref.json"))
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    assert _events(got) == _events(want)
    md = got["metadata"]
    assert md["backend"] == "cpu" and md["device"] == "cpu"
    assert md["xla_flags"] == ""
    assert md["tuning_digest"] == tuning.get_policy().tuning_digest()
    for validate in (export.validate_chrome_trace,
                     rexport.validate_chrome_trace):
        assert validate(got, require_kernel_traffic=True) == []


def test_snapshot_passes_both_validators(tmp_path):
    _populate(obs)
    policy = tuning.KernelPolicy(cache_dir=str(tmp_path / "tune"))
    prev = tuning.set_policy(policy)
    try:
        snap = export.snapshot()
    finally:
        tuning.set_policy(prev)
    assert snap["schema"] == "repro.obs.snapshot/1"
    assert snap["tuning"] == {"backend": "cpu",
                              "tuning_digest": policy.tuning_digest(),
                              "decisions": {}, "decision_log_len": 0}
    h = snap["metrics"]["histograms"]["serve.ttft_s"]
    assert h["count"] == 4 and h["min"] == pytest.approx(1e-3)
    path = tmp_path / "snap.json"
    export.write_snapshot(str(path))
    for doc in (snap, json.loads(path.read_text())):
        assert export.validate_snapshot(doc) == []
        assert rexport.validate_snapshot(doc) == []


def _broken_documents():
    """(validator name, document, kwargs) of broken port documents."""
    _populate(obs)
    snap = json.loads(json.dumps(export.snapshot()))
    trace = json.loads(json.dumps(obs.tracing.buffer().chrome_trace(
        export.trace_metadata())))
    prom = export.prometheus_text()
    out = []

    def snap_with(fn):
        d = json.loads(json.dumps(snap))
        fn(d)
        out.append(("validate_snapshot", d, {}))

    def trace_with(fn, strict=False):
        d = json.loads(json.dumps(trace))
        fn(d)
        out.append(("validate_chrome_trace", d,
                    {"require_kernel_traffic": strict}))

    snap_with(lambda d: d.update(schema="repro.obs.snapshot/2"))
    snap_with(lambda d: d["metrics"]["histograms"]["serve.ttft_s"].pop(
        "buckets"))
    snap_with(lambda d: d["tuning"].update(tuning_digest="nope"))
    snap_with(lambda d: d.pop("tuning"))
    snap_with(lambda d: d["metrics"].update(gauges=[]))
    trace_with(lambda d: d["metadata"].pop("xla_flags"))
    trace_with(lambda d: d["metadata"].update(tuning_digest="XYZ"))
    trace_with(lambda d: d["traceEvents"][-2].update(dur=-1.0))
    trace_with(lambda d: d["traceEvents"][-2].pop("tid"))
    trace_with(lambda d: d["traceEvents"][0].update(ph="Q"))
    trace_with(lambda d: d["traceEvents"][-1]["args"].pop("flops"), True)
    trace_with(lambda d: d["traceEvents"].pop(), True)
    trace_with(lambda d: d.update(traceEvents=[]))
    out.append(("validate_prometheus_text", prom + "bad line here\n", {}))
    out.append(("validate_prometheus_text", prom,
                {"require_metrics": ("repro_missing_total",)}))
    out.append(("validate_prometheus_text", prom.replace(" 4\n", " x4\n"),
                {}))
    return out


def test_validators_agree_with_reference_on_broken_documents():
    cases = _broken_documents()
    assert len(cases) == 16
    for name, doc, kw in cases:
        got = getattr(export, name)(doc, **kw)
        want = getattr(rexport, name)(doc, **kw)
        assert got, (name, kw)
        assert got == want, (name, got, want)


def test_jsonl_emitter_emits_on_its_first_call(tmp_path, monkeypatch):
    """On a host whose monotonic clock reads 5 s, under an hour's
    period: the port's first call emits and its second is skipped; the
    reference's first is skipped (``_last = 0.0``, ROADMAP C)."""
    _populate(obs)
    _populate(robs)
    monkeypatch.setattr(time, "monotonic", lambda: 5.0)
    path = tmp_path / "metrics.jsonl"
    em = export.JsonlEmitter(str(path), period_s=3600.0)
    assert em.maybe_emit()
    assert not em.maybe_emit()
    em.emit()
    assert em.emitted == 2
    lines = path.read_text().splitlines()
    assert len(lines) == 2
    for ln in lines:
        doc = json.loads(ln)
        assert "unix_time" in doc
        assert export.validate_snapshot(doc) == []
        assert rexport.validate_snapshot(doc) == []
    ref = rexport.JsonlEmitter(str(tmp_path / "ref.jsonl"), period_s=3600.0)
    assert not ref.maybe_emit()


# -- launch records and the traffic model ------------------------------------

def _band_record(fam, B, G, Lq, Lk, d, dv, nr, mode, ratio, device=META):
    q = torch.empty((B, G, Lq, d), device=device)
    k = torch.empty((B, Lk, d), device=device)
    v = torch.empty((B, Lk, dv), device=device)
    w = torch.empty((B, Lk), device=device)
    if fam in ("band_fwd", "band_bwd"):
        return getattr(contracts, fam)(q, k, v, w, nr=nr, mode=mode)
    return getattr(contracts, fam)(q, k, v, w, nr=nr, ratio=ratio)


def _mask_pairs(mode, Lq, Lk, nr, ratio):
    i = torch.arange(Lq)[:, None]
    j = torch.arange(Lk)[None, :]
    return int(hb.band_mask(i, j, nr, mode, Lk, ratio).sum())


@settings(max_examples=80, deadline=None)
@given(nr_log=st.integers(1, 4), k=st.integers(0, 4),
       mode=st.sampled_from(hb.MODES + ("sub",)), lvl=st.integers(1, 4),
       B=st.integers(1, 3), G=st.integers(1, 3), d=st.integers(1, 9),
       dv=st.integers(1, 9), backward=st.booleans())
def test_band_traffic_is_band_bytes_on_all_ones(nr_log, k, mode, lvl, B, G,
                                                d, dv, backward):
    nr = 1 << nr_log
    Lq = nr << k
    ratio = 1 << min(lvl, k) if mode == "sub" else 1
    if mode == "sub" and ratio < 2:
        return
    Lk = Lq // ratio
    fam = ("sub" if mode == "sub" else "band") + (
        "_bwd" if backward else "_fwd")
    rec = _band_record(fam, B, G, Lq, Lk, d, dv, nr, mode, ratio)
    w = torch.ones((B, Lk))
    if mode in ("sub", "coarse_causal"):
        want = hb.sub_bytes(w, nr=nr, ratio=ratio, G=G, d=d, dv=dv,
                            backward=backward)
    else:
        want = hb.band_bytes(w, nr=nr, mode=mode, G=G, d=d, dv=dv,
                             backward=backward)
    got = traffic.record_hbm_bytes(rec)
    assert got["read_bytes"] + got["write_bytes"] == want
    per = (6 * d + 4 * dv + 5) if backward else (2 * d + 2 * dv + 3)
    assert traffic.record_flops(rec) == (
        B * G * _mask_pairs(mode, Lq, Lk, nr, ratio) * per)


@pytest.mark.parametrize("mode,L,fwd,bwd", [
    ("l0_causal", 1024, 67_895_296, 136_052_736),
    ("l0_bidir", 2048, 135_790_592, 272_105_472)])
def test_band_bytes_of_the_kernel_table(mode, L, fwd, bwd):
    """PERF.md's LM row (#1 / #3 ``l0_causal``, 64 x G 1, L 1024, d 64,
    nr 16: 0.02027 / 0.04061 ms at 3.35 TB/s) and LRA row (``l0_bidir``
    at L 2048), all rows."""
    for fam, want in (("band_fwd", fwd), ("band_bwd", bwd)):
        rec = _band_record(fam, 64, 1, L, L, 64, 64, 16, mode, 1)
        b = traffic.record_hbm_bytes(rec)
        assert b["read_bytes"] + b["write_bytes"] == want
    if mode == "l0_causal":
        assert round(fwd / HBM * 1e3, 5) == 0.02027
        assert round(bwd / HBM * 1e3, 5) == 0.04061


def _dense_cache(R, Lmax, nr, D, Dv, dtype=torch.float32):
    M = hc.num_levels(Lmax, nr)
    lv = [(torch.empty((R, Lmax >> l, D), dtype=dtype, device=META),
           torch.empty((R, Lmax >> l, Dv), dtype=dtype, device=META))
          for l in range(M)]
    return hd.H1DCache(lv[0][0], lv[0][1], tuple(x[0] for x in lv[1:]),
                       tuple(x[1] for x in lv[1:]))


def _pool(M, rows, nr, D, quant):
    kd = torch.int8 if quant else torch.float32

    def e(*s, dt=kd):
        return torch.empty(s, dtype=dt, device=META)
    k = [e(rows, nr, D) for _ in range(M)]
    v = [e(rows, nr, D) for _ in range(M)]
    if not quant:
        return hd.PagedH1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]))
    sc = [e(rows, nr, dt=torch.float32) for _ in range(M)]
    return hd.QuantPagedH1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]),
                                 sc[0], sc[0], tuple(sc[1:]), tuple(sc[1:]))


def _ms(rec):
    b = traffic.record_hbm_bytes(rec)
    return float(f"{(b['read_bytes'] + b['write_bytes']) / HBM * 1e3:.4g}")


def test_decode_records_give_the_tables_all_rows_bounds():
    """PERF.md's f32 decode rows (R 64, G 1, D 64, nr 16, Lmax 2048; pools
    of 1026 pages x 8 heads): #5 0.001262 ms, #7 0.001263, #8 (every
    level int8) 0.000343, every band's rows."""
    R, Lmax, nr, D = 64, 2048, 16, 64
    M = hc.num_levels(Lmax, nr)
    q = torch.empty((R, 1, D), device=META)
    t = torch.empty((R,), dtype=torch.int32, device=META)
    bidx = torch.empty((R, 1 + M), dtype=torch.int32, device=META)
    rec5 = contracts.decode_attend(_dense_cache(R, Lmax, nr, D, D), q, t,
                                   nr=nr)
    rec7 = contracts.decode_attend_paged(_pool(M, 1026 * 8, nr, D, False),
                                         q, t, bidx, nr=nr)
    rec8 = contracts.decode_attend_paged_quant(
        _pool(M, 1026 * 8, nr, D, True), q, t, bidx, nr=nr)
    assert (_ms(rec5), _ms(rec7), _ms(rec8)) == (0.001262, 0.001263,
                                                 0.000343)
    assert traffic.record_flops(rec5) == R * (M + 1) * nr * (4 * D + 4)


@pytest.mark.parametrize("R,nlev,D,Dv,es,cols", [
    (64, 7, 64, 64, 4, 0), (64, 7, 64, 64, 4, 7), (16, 8, 128, 128, 2, 0),
    (5, 3, 7, 9, 4, 3)])
def test_update_records_follow_the_update_bound_rule(R, nlev, D, Dv, es,
                                                     cols):
    """#6 / #9: new rows, t and the page table read, a row of every level
    written and every level's sibling but the last read."""
    dt = torch.float32 if es == 4 else torch.bfloat16
    kn = torch.empty((R, D), device=META)
    vn = torch.empty((R, Dv), device=META)
    t = torch.empty((R,), dtype=torch.int32, device=META)
    if cols:
        def e(*s):
            return torch.empty(s, dtype=dt, device=META)
        pool = hd.PagedH1DCache(e(9, 8, D), e(9, 8, Dv),
                                tuple(e(9, 8, D) for _ in range(nlev - 1)),
                                tuple(e(9, 8, Dv) for _ in range(nlev - 1)))
        utab = torch.empty((R, cols), dtype=torch.int32, device=META)
        rec = contracts.decode_update_paged(pool, kn, vn, t, utab)
    else:
        cache = _dense_cache(R, 16 << nlev, 16, D, Dv, dt)
        rec = contracts.decode_update(cache, kn, vn, t)
    b = traffic.record_hbm_bytes(rec)
    assert b["read_bytes"] == (4 * R * (D + Dv) + 4 * R * (1 + cols)
                               + es * R * (nlev - 1) * (D + Dv))
    assert b["write_bytes"] == es * R * nlev * (D + Dv)
    assert traffic.record_flops(rec) == R * (nlev - 1) * (D + Dv)


def test_every_record_function_runs_on_meta_tensors():
    """All twelve families from ``meta`` tensors (no data to read), with
    the wrappers' reading of the launchers' grids; each record's traffic
    is computed."""
    e = torch.empty
    R, nr, D, M = 6, 8, 16, 4
    q = e((R, 2, D), device=META)
    t = e((R,), dtype=torch.int32, device=META)
    tab = e((R, 1 + M), dtype=torch.int32, device=META)
    kn, vn = e((R, D), device=META), e((R, D), device=META)
    cache = _dense_cache(R, nr << M, nr, D, D)
    pool, qpool = _pool(M, 40, nr, D, False), _pool(M, 40, nr, D, True)
    own = e((R,), dtype=torch.int32, device=META)
    utab = e((R, M), dtype=torch.int32, device=META)
    recs = [
        _band_record("band_fwd", 2, 2, 64, 64, D, D, nr, "l0_causal", 1),
        _band_record("sub_fwd", 2, 2, 64, 16, D, D, nr, "sub", 4),
        _band_record("band_bwd", 2, 2, 64, 64, D, D, nr, "coarse_bidir", 1),
        _band_record("sub_bwd", 2, 2, 64, 32, D, D, nr, "sub", 2),
        contracts.decode_attend(cache, q, t, nr=nr),
        contracts.decode_update(cache, kn, vn, t),
        contracts.decode_attend_paged(pool, q, t, tab, nr=nr),
        contracts.decode_attend_paged_quant(qpool, q, t, tab, nr=nr),
        contracts.decode_update_paged(pool, kn, vn, t, utab),
        contracts.decode_update_paged_quant(qpool, kn, vn, t, utab),
        contracts.decode_attend_partial(cache, q, t, tab, tab, nr=nr),
        contracts.decode_update_partial(cache, kn, vn, t, own),
    ]
    assert [r.family for r in recs] == list(kernels.FAMILY.values())
    assert list(kernels.FAMILY) == list(kernels.KERNELS)
    for r in recs:
        assert r.meta["impl"] == "cuda"
        b = traffic.record_hbm_bytes(r)
        assert b["read_bytes"] > 0 and b["write_bytes"] > 0
        assert traffic.record_flops(r) > 0
    assert recs[5].operand("k0").shape == (R, nr << M, D)
    assert recs[5].meta["levels"] == M
    assert recs[9].operand("ksc0").dtype == torch.float32
    assert recs[9].operand("k0").dtype == torch.int8
    assert recs[11].operand("carry_k").shape == (R, D)
    # a record function hands over one record per launch signature
    assert _band_record("band_fwd", 2, 2, 64, 64, D, D, nr, "l0_causal",
                        1) is recs[0]
    assert contracts.decode_attend(cache, q, t, nr=nr) is recs[4]
    assert contracts.decode_attend(cache, q, t, nr=nr, grid=((R,),)) \
        is not recs[4]
    assert contracts.decode_update(cache, kn[:3], vn[:3], t[:3]) \
        is not recs[5]
    # a wrapper's grid is what its launcher reports: last_grid reads the
    # four ints of h1d_band_*_last_grid (a second kernel's x = 0: none)
    for got, want in (((32, 64, 0, 0), ((32, 64),)),
                      ((512, 1, 512, 1), ((512, 1), (512, 1)))):
        @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
        def report(ptr, got=got):
            (ctypes.c_int * 4).from_address(ptr)[:] = got
            return 0
        assert hb.last_grid(report) == want


def test_launch_hook_feeds_registry_and_trace():
    """With telemetry on, a handed-over record lands as ``kernel.*``
    counters and a ``kernel.launch`` instant whose traffic args equal the
    model's, and the trace passes both packages' strict validators."""
    obs.enable()
    rec = _band_record("band_fwd", 64, 1, 1024, 1024, 64, 64, 16,
                       "l0_causal", 1)
    rec = contracts.LaunchRecord(rec.family, ((32, 64),), rec.inputs,
                                 rec.outputs, rec.meta)
    with contracts.capture() as buf:
        contracts.record(rec)
        contracts.record(rec)
    assert buf == [rec, rec] and contracts.recent("band_fwd")[-1] is rec
    c = metrics.registry().snapshot()["counters"]
    b = traffic.record_hbm_bytes(rec)
    assert c["kernel.launches{family=band_fwd}"] == 2
    assert c["kernel.hbm_read_bytes{family=band_fwd}"] == 2 * b["read_bytes"]
    assert c["kernel.hbm_write_bytes{family=band_fwd}"] == (
        2 * b["write_bytes"])
    assert c["kernel.flops{family=band_fwd}"] == 2 * traffic.record_flops(
        rec)
    doc = obs.tracing.buffer().chrome_trace(export.trace_metadata())
    (ev, _) = [e for e in doc["traceEvents"] if e["name"] == "kernel.launch"]
    assert ev["args"]["grid"] == [[32, 64]]
    assert ev["args"]["mode"] == "l0_causal" and ev["args"]["nr"] == 16
    assert ev["args"]["hbm_read_bytes"] == b["read_bytes"]
    for validate in (export.validate_chrome_trace,
                     rexport.validate_chrome_trace):
        assert validate(doc, require_kernel_traffic=True) == []
    # the hook's counters leave with a reset and count afresh after it
    obs.reset()
    contracts.record(rec)
    c = metrics.registry().snapshot()["counters"]
    assert c["kernel.launches{family=band_fwd}"] == 1
    assert c["kernel.hbm_read_bytes{family=band_fwd}"] == b["read_bytes"]
