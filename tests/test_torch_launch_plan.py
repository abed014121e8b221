"""The port's planning modules (``launch/specs``, ``dryrun``, ``roofline``)
against the JAX package's, on meta tensors.

* ``specs``: the batch, parameter and cache trees of every smoke arch's
  train / prefill / decode cell at seq 64, batch 2, shape and dtype of
  every leaf as the reference's ShapeDtypeStructs (its scanned stacks
  without their layer axis);
* ``param_count`` and ``model_flops`` of every smoke config and shape,
  and of the full ``yi-6b``, ``qwen2-moe-a2.7b`` and
  ``seamless-m4t-medium``, exactly the reference's; ``cadence_unit`` for
  every config;
* the dry run's per-card argument bytes on a (2, 2) mesh exactly a sum
  over the reference's shape structs under the reference's shardings;
* the roofline's u / 2u extrapolation equal to a direct full-depth count
  for the gemma3 and zamba2 smokes, at three cadence units at least
  (1e-9 relative);
* the kernel wrappers' meta route: empty outputs of the kernels' shapes,
  no launch counted, the launch record inside a capture; a CPU tensor
  never reaches it; the CLIs' records."""
import json
import math
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import test_torch_sharding as plan  # noqa: E402
from repro import parallel as jpar  # noqa: E402
from repro.configs import PAPER_IDS as JAX_PAPER_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.parallel import abstract_mesh  # noqa: E402

SEQ, BATCH = 64, 2
KINDS = ["train", "prefill", "decode"]


@pytest.fixture(scope="module")
def ref():
    """The reference's specs and roofline modules."""
    return plan.ref_launch("specs"), plan.ref_launch("roofline")


def _check_struct(path, r, p, stacked):
    assert plan.shape_of(r, stacked) == tuple(p.shape), path
    assert str(jnp.dtype(r.dtype)) == str(p.dtype).removeprefix("torch."), \
        (path, r.dtype, p.dtype)
    assert p.device.type == "meta"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCH_IDS)
def test_specs_match_reference(ref, name, kind):
    JS, _ = ref
    jcfg, tcfg = jax_smoke(name), get_smoke_config(name)
    with plan.mesh_axes(None):
        plan.walk(JS.param_struct(jcfg), TS.param_struct(tcfg),
                  _check_struct)
        if kind == "decode":
            jargs = JS.decode_arg_specs(jcfg, SEQ, BATCH)
            targs = TS.decode_arg_specs(tcfg, SEQ, BATCH)
        else:
            jargs = getattr(JS, f"{kind}_batch_specs")(jcfg, SEQ, BATCH)
            targs = getattr(TS, f"{kind}_batch_specs")(tcfg, SEQ, BATCH)
    plan.walk(jargs, targs, _check_struct)
    assert TS.cell(tcfg, "decode_32k") == ("decode", 32768, 128)


FULL = ["yi-6b", "qwen2-moe-a2.7b", "seamless-m4t-medium"]


@pytest.mark.parametrize("name,smoke", [(n, True) for n in ARCH_IDS]
                         + [(n, False) for n in FULL])
def test_param_count_and_model_flops_match_reference(ref, name, smoke):
    _, JR = ref
    jcfg = jax_smoke(name) if smoke else jax_config(name)
    tcfg = get_smoke_config(name) if smoke else get_config(name)
    with plan.mesh_axes(None):
        assert R.param_count(tcfg) == JR.param_count(jcfg)
        for shape in SHAPES:
            assert R.model_flops(tcfg, shape) == JR.model_flops(jcfg, shape)


def test_cadence_unit_matches_reference(ref):
    _, JR = ref
    for name in ARCH_IDS + JAX_PAPER_IDS:
        assert R.cadence_unit(get_config(name)) == \
            JR.cadence_unit(jax_config(name)), name


def _ref_arg_bytes(JS, jcfg, kind, mesh, batch):
    """Per-device bytes of the reference's cell arguments: its shape
    structs under its own shardings on ``mesh``."""
    from repro.train import TrainConfig, make_optimizer
    tp = mesh.shape["model"]
    pstruct, pspecs = plan.ref_init(jcfg, tp)
    psh = jpar.param_shardings(mesh, pspecs)
    rep = jpar.replicated(mesh)
    if kind == "train":
        opt = jax.eval_shape(lambda p: make_optimizer(TrainConfig()).init(p),
                             pstruct)
        b = JS.train_batch_specs(jcfg, SEQ, batch)
        trees = [(jax.ShapeDtypeStruct((), jnp.int32), rep), (pstruct, psh),
                 (opt.step, rep), (opt.mu, psh), (opt.nu, psh),
                 (b, jpar.batch_shardings(mesh, b))]
    elif kind == "prefill":
        b = JS.prefill_batch_specs(jcfg, SEQ, batch)
        trees = [(pstruct, psh), (b, jpar.batch_shardings(mesh, b))]
    else:
        with plan.mesh_axes(None):
            caches, tok, t = JS.decode_arg_specs(jcfg, SEQ, batch)
        csh = jpar.cache_shardings(
            mesh, caches, batch=batch, kv_heads=max(jcfg.num_kv_heads, 1),
            long_context=batch == 1,
            num_layers=0 if isinstance(caches, list) else jcfg.num_layers)
        tsh = jpar.batch_shardings(mesh, tok) if batch > 1 else rep
        trees = [(pstruct, psh), (caches, csh), (tok, tsh), (t, tsh)]
    total = 0
    for tree, sh in trees:
        leaves = jax.tree.leaves(tree)
        shs = (jax.tree.leaves(sh) if not isinstance(
            sh, jax.sharding.NamedSharding) else [sh] * len(leaves))
        for leaf, s in zip(leaves, shs, strict=True):
            n = 1
            for i, dim in enumerate(leaf.shape):
                ax = s.spec[i] if i < len(s.spec) else None
                axes = () if ax is None else (ax,) if isinstance(ax, str) \
                    else ax
                n *= -(-dim // math.prod(mesh.shape[a] for a in axes))
            total += n * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("kind,batch", [("train", BATCH), ("prefill", BATCH),
                                        ("decode", BATCH), ("decode", 1)])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_dryrun_bytes_match_reference(ref, name, kind, batch):
    JS, _ = ref
    shape, axes = (2, 2), ("data", "model")
    want = _ref_arg_bytes(JS, jax_smoke(name), kind,
                          jpar.abstract_mesh(shape, axes), batch)
    arg, out, alias, _ = D.measure_cell(get_smoke_config(name),
                                        (SEQ, batch, kind),
                                        abstract_mesh(shape, axes))
    assert sum(arg.values()) == want
    assert 0 <= alias <= out


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("name", ["gemma3-4b", "zamba2-1.2b"])
def test_roofline_extrapolation_is_exact(name, kind):
    # three cadence units at least: at 2u the extrapolation is c(2u)
    cfg = get_smoke_config(name)
    u = R.cadence_unit(cfg)
    cfg = R._depth_cfg(cfg, max(cfg.num_layers, 3 * u))
    assert cfg.num_layers % u == 0
    mesh = abstract_mesh((1, 1), ("data", "model"))
    shape = (SEQ, BATCH, kind)
    got = R._measure(cfg, shape, mesh)["total"]
    full = R.count_cell(R._depth_cfg(cfg, cfg.num_layers), shape, mesh)
    for k in ("flops", "bytes", "kernel_flops", "kernel_launches"):
        assert full[k] > 0, k
        assert abs(got[k] - full[k]) <= 1e-9 * full[k], (k, got[k], full[k])


def _band_args(device):
    g = torch.Generator().manual_seed(0)
    B, G, L, d, nr = 1, 2, 64, 16, 16
    q = torch.randn((B, G, L, d), generator=g)
    k, v = torch.randn((B, L, d), generator=g), torch.randn((B, L, d),
                                                            generator=g)
    w = torch.ones((B, L))
    return [t.to(device) for t in (q, k, v, w)], nr


def test_meta_route(monkeypatch):
    from repro_torch.analysis import contracts
    from repro_torch.kernels import _build, h1d_block, h1d_block_bwd
    (q, k, v, w), nr = _band_args("meta")
    n0 = h1d_block.band_attention_fwd.launches
    with contracts.capture() as recs:
        y, dn, m = h1d_block.band_attention_fwd(q, k, v, w, nr=nr)
        grads = h1d_block_bwd.band_attention_bwd(q, k, v, w, y, dn, m, y, dn,
                                                 m, nr=nr)
    assert h1d_block.band_attention_fwd.launches == n0
    assert [r.family for r in recs] == ["band_fwd", "band_bwd"]
    assert recs[0].grid, "the grid the launcher would build"
    assert y.device.type == "meta" and y.shape == (1, 2, 64, 16)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape, w.shape,
                                        (1, 2, 64)]

    # a CPU tensor takes the plain version and never reaches the route
    def never(*a, **kw):
        raise AssertionError("a CPU tensor reached the meta route")
    monkeypatch.setattr(_build, "on_meta", never)
    (q, k, v, w), nr = _band_args("cpu")
    with contracts.capture() as recs:
        y, dn, m = h1d_block.band_attention_fwd(q, k, v, w, nr=nr)
    assert recs == [] and y.device.type == "cpu"
    with pytest.raises(ValueError):     # a kernel operand: CUDA or meta
        _build.expect(q, "q", q.shape)


@pytest.mark.parametrize("meta_first", [True, False])
def test_meta_route_is_all_or_nothing(meta_first):
    """An operand set that mixes meta with CUDA tensors raises, whichever
    comes first; a CUDA stand-in (its ``device`` alone) takes the place
    of a card's tensor.  A meta ``q`` with CPU ``k``, ``v``, ``w`` fails
    the operand check."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import _build, h1d_block
    meta = torch.empty((2, 2), device="meta")
    cuda = SimpleNamespace(device=torch.device("cuda"))
    ops = (meta, cuda) if meta_first else (cuda, meta)
    with contracts.capture() as recs, \
            pytest.raises(ValueError, match="mix meta"):
        _build.on_meta(ops, contracts.band_fwd)
    assert recs == []
    assert _build.on_meta((cuda, None, cuda), contracts.band_fwd) is False
    (q, k, v, w), nr = _band_args("cpu")
    q = q.to("meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        h1d_block.band_attention_fwd(q, k, v, w, nr=nr)


def test_dryrun_cli_records(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "ARTIFACT_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "llama3.2-1b", "--shape", "long_500k"])
    assert e.value.code == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["llama3.2-1b__long_500k__pod2x32x8.json",
                     "llama3.2-1b__long_500k__pod32x8.json"]
    rec = json.loads((tmp_path / names[1]).read_text())
    assert rec["ok"] and rec["num_devices"] == 256
    assert rec["collectives"] is None and rec["temp"] is None
    assert rec["collectives_reason"] and rec["temp_reason"]
    assert set(rec["memory"]["arguments"]) == {"params", "caches", "token",
                                               "t"}
    assert rec["fits"] is True
    assert rec["card_memory_source"] == "launch.mesh.HBM_BYTES"


def _documented_command_lines():
    """Every ``python -m repro_torch.launch.{dryrun,roofline} ...`` line
    of the README, as (module, argv)."""
    readme = Path(__file__).resolve().parents[1] / "README.md"
    lines = []
    for line in readme.read_text().splitlines():
        m = re.search(r"python -m repro_torch\.launch\.(dryrun|roofline)"
                      r"((?: +--?[\w-]+(?: +[\w.-]+)?)*)", line)
        if m:
            lines.append((m.group(1), m.group(2).split()))
    return lines


def test_documented_command_lines_parse():
    """The README's CLI lines (``dryrun --all`` among them) parse with
    the modules' own parsers: a stale option would stop the command with
    argparse's exit 2 before any cell ran."""
    lines = _documented_command_lines()
    assert ("dryrun", ["--all"]) in lines
    for module, argv in lines:
        {"dryrun": D, "roofline": R}[module].parser().parse_args(argv)


def test_roofline_record(tmp_path):
    cfg = get_smoke_config("llama3.2-1b")
    rec = R.analyze_cell("llama3.2-1b", "train_4k", cfg=cfg,
                         out_dir=str(tmp_path), log=None)
    assert rec["ok"], rec.get("traceback")
    t = rec["terms_s"]
    assert t["collective_s"] is None and rec["collective_reason"]
    assert rec["dominant"] in ("compute_s", "memory_s")
    assert 0 < rec["roofline_fraction"] <= 1
    assert rec["useful_ratio"] > 0
    assert "| llama3.2-1b | train_4k |" in R.summarize(out_dir=str(tmp_path))
