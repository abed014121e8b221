"""The port's parameter specs and sharding rules against the JAX package.

* every ``ARCH_IDS`` smoke config, ``h1d-lm-53m``'s and the LRA
  encoder's: the init's spec tree (``specs=True``) equals the reference
  init's, leaf by leaf, at TP ``None``, 2 and 16 (the reference's
  scanned layer stack without its leading layer axis);
* ``param_shardings``, ``batch_shardings`` and ``cache_shardings`` equal
  the reference's ``.spec`` on abstract meshes (2, 2) ``("data",
  "model")``, (2, 2, 2) with ``"pod"`` and (32, 8), over the smoke
  cells at seq 64, batch 2 (batch 1 for the long-context rule; the
  reference's layer offset only on its stacked caches);
* the cases of ``tests/test_system.py::test_cache_shardings_heuristics``.

Specs are exact: no tolerance.  The helpers below (the reference's init
specs at a TP degree, its launch modules, a walk pairing the
reference's stacked trees with the port's per-layer lists) serve
``test_torch_launch_py`` too."""
import contextlib
import importlib
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import parallel as jpar  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.models import set_mesh_axes  # noqa: E402
from repro_torch import parallel as tpar  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import classifier_init, get_model  # noqa: E402

LRA = "h1d-lra-encoder"
NUM_CLASSES = 10


@contextlib.contextmanager
def mesh_axes(tp):
    """The reference's TP degree set for the block, reset to its default
    (``None``) after, so later tests in the worker see the default."""
    set_mesh_axes(tp)
    try:
        yield
    finally:
        set_mesh_axes(None)


def ref_init(cfg, tp, *, classifier=False):
    """(param ShapeDtypeStructs, specs) of the reference's init at TP
    ``tp``, nothing drawn."""
    from repro.models.classifier import classifier_init as jax_classifier
    out = {}

    def f(key):
        p, s = (jax_classifier(key, cfg, NUM_CLASSES) if classifier
                else jax_model(cfg).init(key, cfg))
        out["specs"] = s
        return p
    with mesh_axes(tp):
        struct = jax.eval_shape(f, jax.random.PRNGKey(0))
    return struct, out["specs"]


def ref_launch(name: str):
    """``repro.launch.<name>``, imported with ``XLA_FLAGS`` restored: the
    reference's dryrun and roofline fabricate 512 host devices at import,
    which must not reach a JAX backend other tests of the worker start."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _ref_leaf(x) -> bool:
    return isinstance(x, (P, jax.sharding.NamedSharding,
                          jax.ShapeDtypeStruct, jax.Array, np.ndarray))


def walk(ref, port, fn, path="", stacked=False):
    """``fn(path, ref_leaf, port_leaf, stacked)`` over the paired leaves;
    a reference dict or NamedTuple beside a port list is a stacked layer
    tree (``stacked`` True below it)."""
    if _ref_leaf(ref):
        return fn(path, ref, port, stacked)
    if isinstance(port, list) and not isinstance(ref, list):
        for i, p in enumerate(port):
            walk(ref, p, fn, f"{path}/{i}", True)
        return
    if isinstance(ref, dict):
        assert set(ref) == set(port), (path, sorted(ref), sorted(port))
        for k in ref:
            walk(ref[k], port[k], fn, f"{path}/{k}", stacked)
        return
    if hasattr(ref, "_fields"):
        assert ref._fields == port._fields, path
        for f in ref._fields:
            walk(getattr(ref, f), getattr(port, f), fn, f"{path}.{f}",
                 stacked)
        return
    assert isinstance(ref, (list, tuple)), (path, type(ref))
    assert len(ref) == len(port), (path, len(ref), len(port))
    for i, (r, p) in enumerate(zip(ref, port)):
        walk(r, p, fn, f"{path}/{i}", stacked)


def spec_of(ref, stacked):
    """The reference leaf's spec, without the layer axis where stacked."""
    spec = ref.spec if isinstance(ref, jax.sharding.NamedSharding) else ref
    spec = tuple(spec)
    if stacked and spec:
        assert spec[0] is None, spec
        spec = spec[1:]
    return P(*spec)


def shape_of(ref, stacked):
    return tuple(ref.shape[1:] if stacked else ref.shape)


ARCHS = ARCH_IDS + ["h1d-lm-53m", LRA]
MESHES = [((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((32, 8), ("data", "model"))]
SEQ, BATCH = 64, 2


def _port_init(name, tp):
    cfg = get_smoke_config(name)
    if name == LRA:
        return classifier_init(cfg, NUM_CLASSES, device="meta", tp=tp,
                               specs=True)
    return get_model(cfg).init(cfg, device="meta", tp=tp, specs=True)


def _check_specs(path, ref, port, stacked):
    assert spec_of(ref, stacked) == P(*port), (path, ref, port)


@pytest.mark.parametrize("tp", [None, 2, 16])
@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_match_reference(name, tp):
    _, ref = ref_init(jax_smoke(name), tp, classifier=name == LRA)
    params, specs = _port_init(name, tp)
    walk(ref, specs, _check_specs)
    # one spec per dimension of its leaf
    for t, s in tpar.sharding.leaf_shardings(params, specs):
        assert len(s) == t.dim()


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "seamless-m4t-medium", LRA])
def test_specs_leave_the_weights_alone(name):
    """The same seed gives the same leaves with and without specs."""
    from repro_torch.tree import tree_leaves
    cfg = get_smoke_config(name)
    if name == LRA:
        a = classifier_init(cfg, 10, seed=4, device="cpu")
        b, _ = classifier_init(cfg, 10, seed=4, device="cpu", tp=2,
                               specs=True)
    else:
        init = get_model(cfg).init
        a = init(cfg, seed=4, device="cpu")
        b, _ = init(cfg, seed=4, device="cpu", tp=2, specs=True)
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _check_sharding(path, ref, port, stacked):
    assert isinstance(port, tpar.NamedSharding), (path, port)
    assert spec_of(ref, stacked) == P(*port.spec), (path, ref, port)


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_and_batch_shardings_match_reference(name, shape, axes):
    from repro.launch import specs as JS
    jm, tm = jpar.abstract_mesh(shape, axes), tpar.abstract_mesh(shape, axes)
    tp = dict(zip(axes, shape))["model"]
    _, ref = ref_init(jax_smoke(name), tp)
    _, specs = _port_init(name, tp)
    walk(jpar.param_shardings(jm, ref), tpar.param_shardings(tm, specs),
              _check_sharding)
    jb = JS.train_batch_specs(jax_smoke(name), SEQ, BATCH)
    tb = TS.train_batch_specs(get_smoke_config(name), SEQ, BATCH)
    walk(jpar.batch_shardings(jm, jb), tpar.batch_shardings(tm, tb),
              _check_sharding)


@pytest.mark.parametrize("batch", [BATCH, 1])
@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("name", ARCH_IDS)
def test_cache_shardings_match_reference(name, shape, axes, batch):
    from repro.launch import specs as JS
    jcfg, tcfg = jax_smoke(name), get_smoke_config(name)
    jm, tm = jpar.abstract_mesh(shape, axes), tpar.abstract_mesh(shape, axes)
    with mesh_axes(None):
        jc, _, _ = JS.decode_arg_specs(jcfg, SEQ, batch)
    tc, _, _ = TS.decode_arg_specs(tcfg, SEQ, batch)
    kw = dict(batch=batch, kv_heads=max(jcfg.num_kv_heads, 1),
              long_context=batch == 1)
    # the layer offset only where the reference stacks its caches: on a
    # per-layer list its rule would take a batch equal to the depth for
    # a layer axis (seamless-m4t's smoke: 2 layers, batch 2)
    stacked = not isinstance(jc, list)
    ref = jpar.cache_shardings(jm, jc, **kw,
                               num_layers=jcfg.num_layers if stacked else 0)
    walk(ref, tpar.cache_shardings(tm, tc, **kw), _check_sharding)


def _zeros(*shape):
    return torch.zeros(shape, device="meta")


@pytest.mark.parametrize("case", ["big", "small", "long_context"])
def test_cache_shardings_heuristics(case):
    """``tests/test_system.py::test_cache_shardings_heuristics``'s cases."""
    mesh = tpar.abstract_mesh((2, 2), ("data", "model"))
    if case == "big":       # batch-major, divisible by dp*tp
        sh = tpar.cache_shardings(mesh, {"a": _zeros(8, 64, 4)}, batch=8,
                                  kv_heads=1, long_context=False)
        assert sh["a"].spec == (("data", "model"), None, None)
    elif case == "small":   # not divisible -> replicated
        sh = tpar.cache_shardings(mesh, {"b": _zeros(3, 64, 4)}, batch=8,
                                  kv_heads=1, long_context=False)
        assert sh["b"].spec == ()
    else:                   # the sequence axis shards over data
        sh = tpar.cache_shardings(mesh, {"c": _zeros(4, 128, 16)}, batch=1,
                                  kv_heads=4, long_context=True)
        assert sh["c"].spec[1] == "data"


def test_shard_shape_and_bytes():
    mesh = tpar.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert tpar.shard_shape((8, 6, 5), (("pod", "data"), "model", None),
                            mesh) == (2, 3, 5)
    # a dim the axes do not divide pads, as a padded shard does
    assert tpar.shard_shape((3, 7), ("data", "model"), mesh) == (2, 4)
    tree = {"a": _zeros(8, 6), "b": [torch.zeros(4, dtype=torch.bfloat16,
                                                 device="meta")]}
    specs = {"a": ("model", None), "b": [()]}
    assert tpar.per_device_bytes(tree, specs, mesh) == 4 * 6 * 4 + 4 * 2
    assert tpar.per_device_bytes(tree, tpar.replicated(mesh), mesh) == \
        8 * 6 * 4 + 4 * 2
    assert tpar.Mesh(("data", "model"), (32, 8)).size == 256
