"""The port's SP ownership checker (``repro_torch.analysis.dist``), as
``tests/test_dist.py`` holds the reference's: the port's own SP rules
(``repro_torch.parallel.sp_attention``) verify clean on every mesh
size, and each violation kind (ownership-gap, ownership-overlap,
halo-mismatch, comm-mismatch) is caught -- a seeded mutation of the
rule behind it, injected through the checker's hooks, comes back with
the reference's kind.  Plus the rules against the reference's own
(the same tables at every position) and the ``check`` CLI's ``--dist``
report in the reference's schema.  Numpy and torch only on the port's
side; the reference is imported to compare rules and sweep sizes."""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import dist as jdist  # noqa: E402
from repro.parallel import sp_attention as jsp  # noqa: E402
from repro_torch.analysis import check, dist  # noqa: E402
from repro_torch.parallel import sp_attention as sp  # noqa: E402


def _kinds(violations):
    return sorted({v.kind for v in violations})


# the mutations of tests/test_dist.py, on numpy
UNCLAMPED_OWNER = dict(update_owner=lambda t, Lloc, d: t // Lloc)
GEQ_OWNED = dict(update_owned=lambda t, s, Lloc, d:
                 (t // Lloc >= s).astype(np.int32))
UPPER_CLIPPED_T = dict(update_local_t=lambda t, s, Lloc:
                       np.clip(t - s * Lloc, 0, Lloc - 1))
EMPTY_HALO = dict(halo_blocks=lambda s, nbl, d, causal: set())
ONE_SHALLOW = dict(n_shallow_fn=lambda M, Lloc, nr: 1)


# ---------------------------------------------------------------------------
# the port's rules verify clean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_decode_ownership_clean(d):
    checks, vs = dist.check_decode(d, 4, 64)
    assert checks > 0
    assert vs == [], _kinds(vs)


@pytest.mark.parametrize("d", [2, 4])
def test_halo_and_comm_clean(d):
    checks_h, vs_h = dist.check_halo(d, 4, 128)
    checks_c, vs_c = dist.check_comm(d, 4, 128)
    assert checks_h > 0 and checks_c > 0
    assert vs_h == [] and vs_c == []


def test_run_dist_sweep_shape():
    stats, vs = dist.run_dist(mesh_sizes=(2,), decode_geoms=((4, 64),),
                              band_geoms=((4, 64),))
    assert vs == []
    assert stats["configs"] == 3          # 1 decode + 1 halo/comm pair
    assert stats["checks"] > 0
    # the whole sweep covers the reference's grid of configurations
    full, vs = dist.run_dist()
    assert vs == []
    assert (dist.MESH_SIZES, dist.DECODE_GEOMS, dist.BAND_GEOMS,
            dist.DIST_KINDS) == (jdist.MESH_SIZES, jdist.DECODE_GEOMS,
                                 jdist.BAND_GEOMS, jdist.DIST_KINDS)
    # four mesh sizes x (two decode geometries + two halo/comm pairs)
    assert full["configs"] == 4 * (2 + 2 * 2)


@pytest.mark.parametrize("d,nr,Lmax", [(2, 4, 64), (4, 4, 128), (8, 4, 128),
                                       (4, 16, 2048)])
def test_rules_match_the_reference(d, nr, Lmax):
    """The rules the checker holds are the reference's at every position
    in [0, Lmax]: band geometry, update owner, local position, shallow
    and sharded level counts."""
    from repro_torch.core import hierarchy as hc
    t = np.arange(Lmax + 1)
    Lloc, M = Lmax // d, hc.num_levels(Lmax, nr)
    nsh = sp.sp_sharded_levels(Lmax, nr, d)
    assert nsh == jsp.sp_sharded_levels(Lmax, nr, d)
    assert sp.sp_n_shallow(M, Lloc, nr) == jsp.sp_n_shallow(M, Lloc, nr)
    np.testing.assert_array_equal(
        sp.sp_update_owner(t, Lloc, d),
        np.asarray(jsp.sp_update_owner(jnp.asarray(t), Lloc, d)))
    for s in range(d):
        np.testing.assert_array_equal(
            sp.sp_update_local_t(t, s, Lloc),
            np.asarray(jsp.sp_update_local_t(jnp.asarray(t), s, Lloc)))
        got = sp._band_geometry(t, s, nr, Lmax, d, nsh, M - 1)
        want = jsp._band_geometry(jnp.asarray(t, jnp.int32),
                                  jnp.asarray(s, jnp.int32), nr, Lmax, d,
                                  nsh, M - 1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# seeded mutations: every DIST kind is caught
# ---------------------------------------------------------------------------

def test_mutation_unclamped_owner_is_ownership_gap():
    """Without the clip to d-1 the final position t == Lmax has no
    owner."""
    _, vs = dist.check_decode(4, 4, 64, **UNCLAMPED_OWNER)
    assert "ownership-gap" in _kinds(vs)


def test_mutation_geq_owned_bits_is_ownership_overlap():
    """An ``owner >= s`` rule makes every earlier shard also claim the
    row."""
    _, vs = dist.check_decode(4, 4, 64, **GEQ_OWNED)
    assert "ownership-overlap" in _kinds(vs)


def test_mutation_upper_clipped_local_t_is_halo_mismatch():
    """Clamping the owner's local position to Lloc-1 breaks the sibling
    parity bits and the pair agreement."""
    _, vs = dist.check_decode(4, 4, 64, **UPPER_CLIPPED_T)
    assert "halo-mismatch" in _kinds(vs)


def test_mutation_doubled_band_index_is_halo_mismatch():
    """A band geometry that returns twice the local block index no
    longer reads the single-card attend's global block."""
    def bad_geo(t, s, nr, Lmax, d, nsh, nlevels):
        bidx, own = sp._band_geometry(t, s, nr, Lmax, d, nsh, nlevels)
        return bidx + bidx, own
    _, vs = dist.check_decode(4, 4, 64, band_geometry=bad_geo)
    assert "halo-mismatch" in _kinds(vs)


def test_mutation_replicated_levels_owned_everywhere_is_caught():
    """Every shard owning the replicated levels' bands: each such band
    counted d times, and d times the single-card attend's rows."""
    def bad_geo(t, s, nr, Lmax, d, nsh, nlevels):
        bidx, own = sp._band_geometry(t, s, nr, Lmax, d, nsh, nlevels)
        own = own.copy()
        own[..., 1 + nsh:] = 1
        return bidx, own
    _, vs = dist.check_decode(4, 4, 128, band_geometry=bad_geo)
    assert {"ownership-overlap", "halo-mismatch"} <= set(_kinds(vs))


def test_mutation_empty_halo_is_halo_mismatch():
    """Dropping the one-block-per-direction halo exchange leaves the
    band_mask neighbourhood uncovered at every shard boundary."""
    _, vs = dist.check_halo(4, 4, 64, **EMPTY_HALO)
    assert _kinds(vs) == ["halo-mismatch"]
    assert len(vs) > 1                     # both modes, several levels


def test_mutation_wrong_shallow_count_is_comm_mismatch():
    """An off n_shallow breaks the L >> l >= d*nr threshold rule, the
    decode path's agreement and the halo buffer's word count."""
    _, vs = dist.check_comm(4, 4, 64, **ONE_SHALLOW)
    assert "comm-mismatch" in _kinds(vs)


def test_all_dist_kinds_are_catchable():
    """The union over the seeded mutations covers every DIST kind."""
    caught = set()
    for kw in (UNCLAMPED_OWNER, GEQ_OWNED, UPPER_CLIPPED_T):
        caught |= {v.kind for v in dist.check_decode(4, 4, 64, **kw)[1]}
    caught |= {v.kind for v in dist.check_comm(4, 4, 64, **ONE_SHALLOW)[1]}
    caught |= {v.kind for v in dist.check_halo(4, 4, 64, **EMPTY_HALO)[1]}
    assert caught >= set(dist.DIST_KINDS)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_check_cli_dist_report(tmp_path, capsys):
    """``--dist --json PATH``: the reference's report schema, no
    violation, exit 0; ``--kernels`` runs the kernels section beside it
    and leaves it out of the dist report."""
    path = tmp_path / "r.json"
    assert check.main(["--dist", "--json", str(path)]) == 0
    out = capsys.readouterr().out
    assert "dist:" in out and "pool:" not in out
    rep = json.loads(path.read_text())
    assert set(rep) == {"sections", "contracts", "families", "violations",
                        "dist", "pool", "ok", "runtime_s"}
    assert rep["sections"] == ["dist"] and rep["pool"] is None
    assert rep["contracts"] == 0 and rep["families"] == {}
    assert rep["violations"] == [] and rep["ok"] is True
    assert rep["dist"]["configs"] == 24 and rep["dist"]["checks"] > 0
    assert isinstance(rep["runtime_s"], float)
    capsys.readouterr()
    assert check.main(["--kernels", "--family", "decode_update"]) == 0
    out = capsys.readouterr().out
    assert "checked" in out and "dist:" not in out
