"""Port parity of the SSM family (``mamba2-1.3b``'s smoke config: two
Mamba2 layers, tied embeddings) against the JAX package, through
``params_from_jax``: configs, the parameter copy, the loss and its
gradients with and without remat, prefill and decode with their SSM
states, the serving engine's greedy tokens, an in-place AdamW step and
the CLIs; plus the full config's parameter shapes on the ``meta``
device.  The checks and their tolerances are ``_torch_family``'s."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import _torch_family as fam  # noqa: E402

ARCH = "mamba2-1.3b"


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


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(smoke, jax_side, remat):
    fam.loss_and_gradients(smoke, remat, jax_side)


def test_prefill_and_decode_match_jax(smoke):
    fam.prefill_and_decode(smoke)


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
    """1,343,740,928 parameters: ``jax.eval_shape`` of the reference's
    init."""
    fam.meta_shapes(ARCH, 1_343_740_928)
