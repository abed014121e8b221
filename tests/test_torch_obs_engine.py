"""Telemetry of the port's serving engine, SP dispatcher and CLIs on the
CPU, held against the JAX package's engine.

The reference's and the port's ``ServeEngine`` serve the reference
test's ``_tiny_engine`` workload (``tests/test_obs.py``: the
``llama3.2-1b`` smoke config, 2 slots, max_len 64, token budget 64, two
requests with one prompt and a third) with telemetry on, dense and
paged: the ``serve.*`` and ``pool.*`` counters are equal, so are the
counts of the latency histograms and the gauge names, and the
``serve.tick`` spans number as many as ``serve.ticks``.  The counts
depend on the prompts and lengths only, not on the weights, so each
engine runs on its own seeded weights.  ``kernel.*`` stays out of the
comparison: the reference counts a launch per traced shape, the port
every launch, and on the CPU neither launches a kernel.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import obs as robs  # noqa: E402
from repro.obs import export as rexport  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import export  # noqa: E402

NEW = 4


@pytest.fixture(autouse=True)
def _clean_obs():
    for o in (obs, robs):
        o.disable()
        o.reset()
    yield
    for o in (obs, robs):
        o.disable()
        o.reset()


def _prompts(vocab):
    return [np.arange(4, 16) % vocab, np.arange(4, 16) % vocab,
            (np.arange(3, 27) * 5) % vocab]


def _run(engine, make_req, vocab):
    reqs = [make_req(uid=i, prompt=p.astype(np.int32), max_new_tokens=NEW)
            for i, p in enumerate(_prompts(vocab))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(len(r.out_tokens) == NEW for r in reqs)
    return reqs


def _reference(paged):
    from repro.configs import get_smoke_config
    from repro.models import get_model
    from repro.serve import Request, ServeEngine
    cfg = get_smoke_config("llama3.2-1b")
    params, _ = get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    robs.enable()
    eng = ServeEngine(cfg, params, slots=2, max_len=64, paged=paged,
                      token_budget=64)
    _run(eng, Request, cfg.vocab_size)
    return (rexport.snapshot()["metrics"],
            robs.tracing.buffer().chrome_trace())


def _port(paged, enabled=True):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_smoke_config("llama3.2-1b")
    params = get_model(cfg).init(cfg, seed=0, device="cpu")
    if enabled:
        obs.enable()
    eng = ServeEngine(cfg, params, slots=2, max_len=64, paged=paged,
                      token_budget=64)
    _run(eng, Request, cfg.vocab_size)
    return (export.snapshot()["metrics"],
            obs.tracing.buffer().chrome_trace(export.trace_metadata()))


def _serving(counters):
    return {k: v for k, v in counters.items()
            if k.startswith(("serve.", "pool."))}


def _ticks(trace):
    return sum(e["name"] == "serve.tick" for e in trace["traceEvents"])


@pytest.mark.parametrize("paged", [False, True])
def test_engine_telemetry_matches_reference(paged):
    got, gtrace = _port(paged)
    want, wtrace = _reference(paged)
    assert _serving(got["counters"]) == _serving(want["counters"])
    assert got["counters"]["serve.requests"] == 3
    assert got["counters"]["serve.finished"] == 3
    for name in ("serve.ttft_s", "serve.itl_s", "serve.request_latency_s"):
        assert got["histograms"][name]["count"] == (
            want["histograms"][name]["count"])
    assert got["histograms"]["serve.ttft_s"]["count"] == 3
    assert got["histograms"]["serve.itl_s"]["count"] == 3 * (NEW - 1)
    assert sorted(got["gauges"]) == sorted(want["gauges"])
    assert ("pool.occupancy" in got["gauges"]) == paged
    if paged:
        assert got["counters"]["pool.prefix_hits"] >= 1
    assert _ticks(gtrace) == got["counters"]["serve.ticks"]
    assert _ticks(wtrace) == want["counters"]["serve.ticks"]
    names = {e["name"] for e in gtrace["traceEvents"]}
    assert {"serve.tick", "serve.admit", "serve.decode"} <= names
    assert ("serve.prepare" in names) == paged
    for validate in (export.validate_chrome_trace,
                     rexport.validate_chrome_trace):
        assert validate(gtrace) == []


def test_engine_with_telemetry_off_records_nothing():
    snap, trace = _port(paged=True, enabled=False)
    assert snap == {"counters": {}, "gauges": {}, "histograms": {}}
    assert len(obs.tracing.buffer()) == 0
    assert all(e["ph"] == "M" for e in trace["traceEvents"])


def test_sp_dispatches_are_counted():
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_smoke_config("h1d-lm-53m")
    params = get_model(cfg).init(cfg, seed=0, device="cpu")
    obs.enable()
    eng = ServeEngine(cfg, params, slots=2, max_len=64,
                      mesh=make_mesh((2,), ("data",), device="cpu"))
    _run(eng, Request, cfg.vocab_size)
    c = export.snapshot()["metrics"]["counters"]
    for op in ("h1d_attention", "decode_attend", "update_cache"):
        assert c[f"sp.dispatches{{op={op},shards=2}}"] > 0


def test_serve_cli_writes_every_document(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    paths = {k: str(tmp_path / k) for k in ("trace.json", "m.prom",
                                            "m.jsonl")}
    reqs = serve_cli.main([
        "--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
        "--new-tokens", "3", "--max-len", "64", "--paged",
        "--trace-out", paths["trace.json"], "--prom-out", paths["m.prom"],
        "--metrics-jsonl", paths["m.jsonl"], "--metrics-period", "3600"])
    assert obs.enabled()
    out = capsys.readouterr().out
    c = export.snapshot()["metrics"]["counters"]
    assert (f"[serve] telemetry: ticks={c['serve.ticks']} finished=3"
            in out)
    assert f"trace -> {paths['trace.json']}" in out
    assert c["serve.finished"] == len(reqs) == 3
    trace = json.loads(open(paths["trace.json"]).read())
    text = open(paths["m.prom"]).read()
    need = ("repro_serve_ttft_s_bucket", "repro_serve_itl_s_bucket",
            "repro_serve_ticks_total", "repro_pool_fresh_pages_total")
    lines = open(paths["m.jsonl"]).read().splitlines()
    assert len(lines) == 2           # the first tick's, then the last
    for ex in (export, rexport):
        assert ex.validate_chrome_trace(trace) == []
        assert ex.validate_prometheus_text(text, need) == []
        for ln in lines:
            assert ex.validate_snapshot(json.loads(ln)) == []


def test_train_cli_spans_and_loss(tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    trace_path = str(tmp_path / "train.json")
    train_cli.main(["--device", "cpu", "--smoke", "--steps", "2",
                    "--batch", "2", "--seq", "64", "--telemetry",
                    "--trace-out", trace_path,
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    snap = export.snapshot()["metrics"]
    trace = json.loads(open(trace_path).read())
    steps = [e for e in trace["traceEvents"] if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == [0, 1]
    assert all(e["tid"] == obs.TRACK_TRAIN for e in steps)
    assert snap["counters"]["train.steps"] == 2
    assert snap["histograms"]["train.step_s"]["count"] == 2
    last = out.split("last loss ")[1].split(",")[0]
    assert f"{snap['gauges']['train.loss']:.4f}" == last
    for ex in (export, rexport):
        assert ex.validate_chrome_trace(trace) == []
