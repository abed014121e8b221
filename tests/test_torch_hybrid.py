"""Port parity of the hybrid family (``zamba2-1.2b``'s smoke config: six
Mamba2 layers and one shared causal-H1D attention block run after every
third, with its own input projection each time) against the JAX
package, through ``params_from_jax``: configs, the parameter copy (the
shared block and its projections too), the loss and its gradients with
and without remat (the shared block's weights take gradient from both
invocations), prefill and decode with the SSM states and the shared
block's hierarchical caches in the reference's order, the serving
engine's greedy tokens, an in-place AdamW step and the CLIs; plus the
full config's parameter shapes on the ``meta`` device.  The checks and
their tolerances are ``_torch_family``'s."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_family as fam  # noqa: E402

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def smoke():
    return fam.smoke(ARCH)


@pytest.fixture(scope="module")
def jax_side():
    return {}


def test_configs_match_jax():
    fam.configs_match(ARCH)


def test_params_from_jax_round_trip(smoke):
    fam.params_round_trip(smoke)


def test_shared_block_carried(smoke):
    """The shared dense block and one (2d, d) projection per invocation,
    equal to JAX's; the shared block's weights are the same tensors at
    every invocation."""
    cfg, params, tcfg, tp = smoke
    inv = [i for i in range(cfg.num_layers) if cfg.layer_is_attn(i)]
    assert inv == [2, 5]
    assert len(tp["shared_proj"]) == 2
    for a, b in zip(tp["shared_proj"], params["shared_proj"]):
        assert tuple(a["w"].shape) == (2 * cfg.d_model, cfg.d_model)
        np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))
    assert set(tp["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    np.testing.assert_array_equal(
        tp["shared"]["attn"]["wkv"]["w"].numpy(),
        np.asarray(params["shared"]["attn"]["wkv"]["w"]))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(smoke, jax_side, remat):
    fam.loss_and_gradients(smoke, remat, jax_side)


def test_prefill_and_decode_match_jax(smoke):
    fam.prefill_and_decode(smoke)


def test_cache_order_interleaves_shared_block(smoke):
    """Eight caches for six layers: after layers 2 and 5 the shared
    block's hierarchical cache follows that layer's SSM state."""
    from repro_torch.models import get_model
    from repro_torch.models.ssm import SSMState
    _, _, tcfg, tp = smoke
    caches = get_model(tcfg).init_caches(tp, tcfg, 2, 64)
    kinds = ["ssm" if isinstance(c, SSMState) else "h1d" for c in caches]
    assert kinds == ["ssm"] * 3 + ["h1d"] + ["ssm"] * 3 + ["h1d"]
    assert caches[3].k.shape == (2 * tcfg.num_kv_heads, 64, tcfg.head_dim)


def test_engine_tokens_match_jax_manual_greedy(smoke):
    fam.engine_tokens(smoke)


def test_paged_and_sp_serving_refused(smoke):
    """Paged serving is refused; a 2-way SP mesh serves the family."""
    fam.paged_refused_sp_serves(smoke)


def test_in_place_train_step_matches_reference():
    fam.train_steps(ARCH)


def test_clis_run_the_smoke_config(capsys, tmp_path):
    fam.clis(ARCH, capsys, tmp_path)


def test_full_size_shapes_on_meta_match_jax():
    """1,155,269,504 parameters: ``jax.eval_shape`` of the reference's
    init."""
    fam.meta_shapes(ARCH, 1_155_269_504)
