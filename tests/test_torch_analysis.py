"""The port's kernels section of ``analysis/`` (``checker``, ``vmem``,
``check --kernels``), as ``tests/test_analysis.py`` holds the
reference's: launch records made on ``meta`` tensors at policy tiles
carry the launchers' grids and the plans' shared memory; clean records
check clean in every family; the seeded mutations each come back with
the reference's kind -- an off-by-one tile ``oob``, a folded output
``double-write`` and ``coverage-gap``, a page table one past the pool
``scalar-oob``, a dtype-mismatched alias ``alias-mismatch``; the shared
memory budget (its override, the static ``rejected:vmem`` in the
candidate path); and the CLI: exit 0 with no flag over all twelve
families, the JSON report's keys and the ``--family`` filter as the
reference's.  Nothing is traced through JAX: the reference is imported
for its names and its pool section's report."""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.analysis import check as jcheck  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.analysis import check, checker, contracts, vmem  # noqa: E402
from repro_torch.kernels import h1d_block as hb  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as dk  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels.tuning import KernelPolicy, set_policy  # noqa: E402

META = torch.device("meta")


@pytest.fixture
def fresh_policy(tmp_path):
    p = KernelPolicy(cache_dir=str(tmp_path))
    prev = set_policy(p)
    yield p
    set_policy(prev)


def _band(fam="band_fwd", L=256, nr=16, d=16, B=1, G=2, mode="l0_causal",
          ratio=1, tile=None):
    Lk = L // ratio
    q = torch.empty((B, G, L, d), device=META)
    k, v = torch.empty((B, Lk, d), device=META), torch.empty((B, Lk, d),
                                                             device=META)
    w = torch.empty((B, Lk), device=META)
    if fam.startswith("sub"):
        return getattr(contracts, fam)(q, k, v, w, nr=nr, ratio=ratio,
                                       tile=tile)
    return getattr(contracts, fam)(q, k, v, w, nr=nr, mode=mode, tile=tile)


@pytest.fixture(scope="module")
def decode_records():
    """Every decode family's records at the CLI's geometry (nr 4, d 8)."""
    return check.decode_contracts(KernelPolicy(cache_dir="/nonexistent"),
                                  nr=4, d=8)


def _first(labeled, family):
    for _, r in labeled:
        if r.family == family:
            return r
    raise AssertionError(f"no {family} record")


def _kinds(vs):
    return {v.kind for v in vs}


# ---------------------------------------------------------------------------
# records at policy tiles: grids and shared memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam,mode,ratio,tile,grid,smem", [
    ("band_fwd", "l0_causal", 1, {"tq": 32}, ((16, 1),),
     (4 * hb.band_fwd_floats("l0_causal", 32, 16, 16, 16),)),
    ("band_bwd", "l0_bidir", 1, {"tq": 16, "nkb": 1, "tk": 32},
     ((32, 1), (16, 1)),
     (4 * hb.band_dq_floats("l0_bidir", 16, 16, 16, 16),
      4 * hb.band_dkvw_floats("l0_bidir", 1, 32, 16, 16, 16))),
    ("sub_fwd", "sub", 4, {"tq": 64}, ((8, 1),),
     (4 * hb.sub_fwd_floats(16, 16, 16, 4),)),
    ("sub_bwd", "sub", 8, {"splits": 2}, ((4, 1),),
     (4 * hb.sub_bwd_floats(hb.sub_bwd_tq(2, 128, 2, 16, 16, 16), 16, 16,
                            16),)),
])
def test_record_at_a_tile_carries_the_launch(fam, mode, ratio, tile, grid,
                                             smem):
    rec = _band(fam, mode=mode, ratio=ratio, tile=tile)
    assert rec.grid == grid
    assert rec.smem == smem
    assert rec.meta["tile"] == tile
    assert rec.regs is None and rec.ctas_per_sm is None   # no card here
    assert checker.check_contract(rec) == []
    assert vmem.record_smem_bytes(rec) == max(smem)


def test_decode_records_carry_plans_and_domains(decode_records):
    for label, rec in decode_records:
        assert rec.grid == ((rec.meta["R"], 1),), label
        assert rec.scalars[0].name == "t", label
        if rec.family.startswith("decode_attend"):
            plan = dk.plan_attend_stages(
                rec.meta["G"], 8, 8, rec.meta["nr"], rec.meta["levels"],
                quant=rec.meta["qmask"] != 0, half=bool(rec.meta["half"]),
                cr=rec.meta["tile"]["cr"])
            assert rec.smem == (plan.smem,), label
        elif rec.family == "decode_update_paged_quant":
            assert rec.smem == (dk.update_quant_smem(
                8, 8, rec.meta["qmask"], rec.meta["levels"]),)
        else:
            assert rec.smem == (dk.update_chain_plan(
                8, 8, rec.meta["levels"],
                paged=rec.family == "decode_update_paged")[1],), label
    upd = _first(decode_records, "decode_update_paged")
    assert len(upd.aliases) == 2 * upd.meta["levels"]
    bidx = _first(decode_records, "decode_attend_paged").scalars[1]
    # per-level pools of unequal sizes: each column its own level's pages
    assert len(set(bidx.hi)) > 1


# ---------------------------------------------------------------------------
# clean records pass
# ---------------------------------------------------------------------------

def test_all_band_candidates_clean():
    labeled = check.band_contracts(KernelPolicy(cache_dir="/nonexistent"),
                                   nr=16, d=16)
    assert {r.family for _, r in labeled} == {"band_fwd", "band_bwd",
                                              "sub_fwd", "sub_bwd"}
    for label, rec in labeled:
        vs = checker.check_contract(rec, samples=1)
        assert vs == [], f"{label}: {[str(v) for v in vs]}"


def test_all_decode_families_clean(decode_records):
    assert {r.family for _, r in decode_records} == set(
        tuning.ATTEND_FAMILIES + tuning.UPDATE_FAMILIES)
    for label, rec in decode_records:
        vs = checker.check_contract(rec)
        assert vs == [], f"{label}: {[str(v) for v in vs]}"


def test_streamed_records_clean():
    """The streamed l0_causal bodies (gemma's window, nr 1024, d 256)."""
    for fam in ("band_fwd", "band_bwd"):
        body = (hb.check_window_fwd if fam == "band_fwd"
                else hb.check_window_bwd)("l0_causal", 1024, 256, 256)
        q = torch.empty((2, 2, 4096, 256), device=META)
        k = torch.empty((2, 4096, 256), device=META)
        rec = getattr(contracts, fam)(q, k, k, torch.empty((2, 4096),
                                                           device=META),
                                      nr=1024, mode="l0_causal", body=body,
                                      tile={"tq": hb.STREAM_TQ})
        assert body == "stream" and checker.check_contract(rec) == []


# ---------------------------------------------------------------------------
# seeded mutations: each comes back with its kind
# ---------------------------------------------------------------------------

def _mutate(op, fn):
    """A footprint whose accesses of operand ``op`` go through ``fn``."""
    def footprint(rec, tables):
        return [(n, rw, k, c, *fn(rec, lo, hi)) if n == op
                else (n, rw, k, c, lo, hi)
                for n, rw, k, c, lo, hi in checker.footprint(rec, tables)]
    return footprint


def test_clean_record_gives_no_violation():
    rec = _band(tile={"tq": 32})
    assert checker.check_contract(rec) == []
    assert checker.summarize([]) == {"total": 0, "by_kind": {}}


def test_mutation_off_by_one_tile():
    """q's tile one tile on walks past the last tile -> oob."""
    rec = _band(tile={"tq": 32})
    vs = checker.check_contract(rec, footprint_fn=_mutate(
        "q", lambda r, lo, hi: (lo + 32, hi + 32)))
    assert any(v.kind == "oob" and v.operand == "q" for v in vs), \
        [str(v) for v in vs]


def test_mutation_double_written_output():
    """y's tiles folded onto the first two of each head: revisits at
    non-consecutive CTAs AND rows never written."""
    rec = _band(tile={"tq": 32})
    L = rec.meta["Lq"]

    def fold(r, lo, hi):
        base = lo // L * L
        lo2 = base + (lo - base) % 64
        return lo2, lo2 + hi - lo
    kinds = _kinds(checker.check_contract(rec, footprint_fn=_mutate("y",
                                                                    fold)))
    assert {"double-write", "coverage-gap"} <= kinds, kinds


def test_mutation_out_of_range_page_table(decode_records):
    """The page table's domain one past the pool's pages -> scalar-oob."""
    rec = _first(decode_records, "decode_attend_paged")
    s = rec.scalars[1]
    assert s.name == "bidx"
    mut = dataclasses.replace(rec, scalars=(
        rec.scalars[0], dataclasses.replace(s, hi=np.asarray(s.hi) + 1)))
    vs = checker.check_contract(mut)
    assert any(v.kind == "scalar-oob" for v in vs), [str(v) for v in vs]
    assert "oob" not in _kinds(vs)      # the lo corner stays in bounds


def test_mutation_alias_dtype_mismatch(decode_records):
    """An in-place update whose read operand's dtype is not its
    written one's."""
    rec = _first(decode_records, "decode_update_paged")
    assert rec.aliases
    i, _ = rec.aliases[0]
    ins = list(rec.inputs)
    ins[i] = ins[i]._replace(dtype=torch.int8)
    vs = checker.check_contract(dataclasses.replace(rec, inputs=tuple(ins)))
    assert any(v.kind == "alias-mismatch" for v in vs), [str(v) for v in vs]
    assert checker.summarize(vs)["by_kind"]["alias-mismatch"] >= 1


def test_grid_and_smem_not_the_launchers_are_bad_specs():
    rec = _band(tile={"tq": 32})
    assert "bad-spec" in _kinds(checker.check_contract(
        dataclasses.replace(rec, grid=((rec.grid[0][0] + 2, 1),))))
    meta = dict(rec.meta, smem_set=(rec.smem[0] + 16,))
    assert "bad-spec" in _kinds(checker.check_contract(
        dataclasses.replace(rec, meta=meta)))


# ---------------------------------------------------------------------------
# the shared-memory budget
# ---------------------------------------------------------------------------

def test_budget_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_VMEM_BUDGET", "12345")
    assert vmem.default_budget() == 12345
    monkeypatch.delenv("REPRO_VMEM_BUDGET")
    assert vmem.default_budget() == vmem.SMEM_MAX == hb.SMEM_MAX
    monkeypatch.setenv("REPRO_VMEM_BUDGET", "lots")
    with pytest.warns(RuntimeWarning, match="REPRO_VMEM_BUDGET"):
        assert vmem.default_budget() == vmem.SMEM_MAX


def test_band_launch_bytes_grows_with_the_tile():
    small, big = (vmem.band_launch_bytes("band_fwd", L=256, nr=16,
                                         mode="l0_causal", tq=t, d=16)
                  for t in (16, 32))
    assert small < big
    assert big == 4 * hb.band_fwd_floats("l0_causal", 32, 16, 16, 16)
    bwd = vmem.band_launch_bytes("band_bwd", L=256, nr=16, mode="l0_causal",
                                 tq={"tq": 16, "nkb": 2, "tk": 32}, d=16)
    assert bwd == 4 * max(hb.band_dq_floats("l0_causal", 16, 16, 16, 16),
                          hb.band_dkvw_floats("l0_causal", 2, 32, 16, 16,
                                              16))


def test_rejection_is_static_and_logged(tmp_path):
    """Over-budget candidates are dropped before any measurement, logged
    as ``rejected:vmem`` with bytes and reason; listing them writes no
    table; the autotune pass measures the survivors only, and refuses
    when none survives."""
    p = KernelPolicy(backend="cuda", device="card", cache_dir=str(tmp_path))
    budget = vmem.band_launch_bytes("band_fwd", L=256, nr=16,
                                    mode="l0_causal", tq=32, d=16) - 1
    d0 = p.tuning_digest()
    cands = p.candidates("band_fwd", L=256, nr=16, mode="l0_causal", d=16,
                         vmem_budget=budget)
    assert [c["tq"] for c in cands] == [16]
    rej = [e for e in p.decisions if e["source"] == "rejected:vmem"]
    assert [e["config"]["tq"] for e in rej] == [32]
    assert rej[0]["config"]["vmem_bytes"] > budget
    assert "budget" in rej[0]["config"] and "reason" in rej[0]["config"]
    assert p.tuning_digest() == d0
    measured = []
    p._band_runner = lambda family, cand, **shape: cand
    p._measure = lambda fn, iters=10, warmup=2: measured.append(fn) or 1.0
    entry = p.autotune_band(L=256, nr=16, mode="l0_causal", d=16,
                            vmem_budget=budget)
    assert len(measured) == 1 and entry["tq"] == 16
    with pytest.raises(AssertionError, match="rejected:vmem"):
        p.autotune_band(L=512, nr=16, mode="l0_causal", d=16, vmem_budget=1)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_check_cli_kernels_default(capsys):
    """No section flag: the kernels section over every family, exit 0."""
    assert check.main(["--samples", "1"]) == 0
    out = capsys.readouterr().out
    assert "across 12 families" in out and "OK: no violations" in out
    for fam in kernels.FAMILY.values():
        assert f"  {fam}: " in out


def test_check_json_keys_match_the_reference(tmp_path, capsys):
    """The report's keys equal the reference's (its pool section's report
    on the same small model check); the kernels section fills
    ``contracts`` and ``families``."""
    rep = {}
    for name, main in (("ref", jcheck.main), ("port", check.main)):
        path = tmp_path / f"{name}.json"
        assert main(["--pool", "--pool-states", "300", "--json",
                     str(path)]) == 0
        rep[name] = json.loads(path.read_text())
    assert set(rep["port"]) == set(rep["ref"])
    path = tmp_path / "k.json"
    assert check.main(["--nr", "4", "--d", "8", "--samples", "1",
                       "--family", "decode_update", "--json",
                       str(path)]) == 0
    capsys.readouterr()
    k = json.loads(path.read_text())
    assert k["sections"] == ["kernels"] and k["contracts"] > 0
    assert set(k["families"]) == {f for f in tuning.FAMILIES
                                  if "decode_update" in f}
    assert k["pool"] is None and k["dist"] is None and k["ok"] is True


def test_check_family_filters_records(capsys):
    assert check.main(["--nr", "4", "--d", "8", "--samples", "1",
                       "--family", "band_fwd"]) == 0
    out = capsys.readouterr().out
    assert "band_fwd" in out and "decode" not in out
    assert check.main(["--pool", "--pool-states", "300"]) == 0
    out = capsys.readouterr().out
    assert "pool:" in out and "checked" not in out


@pytest.mark.parametrize("smem,attrs,want_smem,want", [
    ((41116, 0), (88, 0, 128, 5, 0, 0, 0, 0), (41116,), ((88,), (5,))),
    ((55260, 43016), (118, 0, 128, 4, 80, 0, 128, 5), (55260, 43016),
     ((118, 80), (4, 5)))])
def test_launch_readers_parse_the_exports(smem, attrs, want_smem, want):
    """``_build.last_smem`` / ``last_attrs`` read a library's exports
    (``csrc/launch_info.cuh``): one kernel's or two kernels' shared
    memory, registers and CTAs an SM."""
    import ctypes

    from repro_torch.kernels import _build

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
    def last_smem(ptr):
        (ctypes.c_int * 2).from_address(ptr)[:] = smem
        return 0

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
    def last_attrs(ptr):
        (ctypes.c_int * 8).from_address(ptr)[:] = attrs
        return 0

    lib = type("Lib", (), {})()
    lib.x_last_smem, lib.x_last_attrs = last_smem, last_attrs
    assert _build.last_smem(lib, "x") == want_smem
    assert _build.last_attrs(lib, "x") == want
