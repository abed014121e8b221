"""Launch policy of the Hopper kernels: impl validation, candidate tiles,
the override > table > default resolution and the measured autotune pass.

Port of ``repro.kernels.tuning``.  Every tile the port's launchers take
(``csrc/*.cu``: the band forward's rows a tile, the band backward's dQ
tile and dK/dV/dW key blocks and reader rows, the sub backward's splits,
the staged decode attend's chunk rows) resolves through one
:class:`KernelPolicy`, per launch::

    explicit override  >  on-disk tuning table  >  committed defaults

* **Override**: a caller's ``tq=`` (``kernels.ops.band_attention``, the
  kernel wrappers) bypasses tuning; it is legalized to the largest
  candidate at or below it (:func:`resolve_tq`) and logged as
  ``override``.
* **Table**: a versioned JSON table under
  ``~/.cache/repro_tune/cuda/<family>.json`` (``$REPRO_TUNE_CACHE``
  moves the root), keyed by :func:`table_key` and written by
  :meth:`KernelPolicy.autotune_band` on the card.  A table names the card
  it was measured on; a corrupt, stale or foreign one (another backend
  or another card) warns and is ignored.
* **Defaults**: ``tuning_defaults.json`` beside this module names, per
  family, the launcher's own rule (its Python mirror in the kernel
  modules: ``h1d_block.band_fwd_tq``, ``band_dkvw_tiles``,
  ``sub_bwd_splits``, ``h1d_decode_kernel.plan_attend_stages``), so with
  no table and no override every kernel launches as its launcher would
  choose.  A tile that is a compile-time constant (``sub_fwd`` at
  ``SUB_TQ``, the streamed bodies, the updates' one CTA a row) is one
  candidate, ``fixed``.

The backend is chosen by the tensors' device, never by this module:
``cuda`` where a card is present, else ``cpu``; the CPU path (the plain
versions) asks the policy nothing.  The impl strings of the reference
(:data:`IMPLS`) are validated by :func:`canonical_impl` and select
nothing here: ``resolve_impl('auto')`` logs the backend and returns
``'auto'``.

Every resolution is appended to the bounded decision log
(``policy.decisions``); :meth:`KernelPolicy.tuning_digest` hashes the
defaults, every readable table of the backend and the kernels' sources
(``_build.kernels_digest``).

This module imports no kernel module at import time (they import it);
the rules and the measurement import lazily.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

#: the reference's impl enum: every ``attn_impl`` / ``decode_impl`` string
#: is validated against it (the port selects its path by device)
IMPLS = ("auto", "jnp", "pallas", "pallas_interpret")

#: kernel families (the launch records' names, ``kernels.FAMILY``): the
#: reference's ten and the port's two sequence-parallel forms
FAMILIES = (
    "band_fwd", "band_bwd",
    "sub_fwd", "sub_bwd",
    "decode_attend", "decode_update",
    "decode_attend_paged", "decode_update_paged",
    "decode_attend_paged_quant", "decode_update_paged_quant",
    "decode_attend_partial", "decode_update_partial",
)
BAND_FAMILIES = FAMILIES[:4]
ATTEND_FAMILIES = ("decode_attend", "decode_attend_paged",
                   "decode_attend_paged_quant", "decode_attend_partial")
UPDATE_FAMILIES = ("decode_update", "decode_update_paged",
                   "decode_update_paged_quant", "decode_update_partial")

#: the fields of a candidate that a launcher takes
TILE_FIELDS = ("tq", "nkb", "tk", "splits", "cr")

TABLE_VERSION = 1
_DEFAULTS_PATH = os.path.join(os.path.dirname(__file__),
                              "tuning_defaults.json")
_SUB = "sub"


def canonical_impl(impl: str) -> str:
    """Validate ``impl`` against the reference's enum.  Raises
    ``ValueError`` naming the allowed set on anything else."""
    if impl not in IMPLS:
        raise ValueError(
            f"unknown impl {impl!r}: allowed impls are {IMPLS}")
    return impl


def detect_backend() -> str:
    """'cuda' where a card is present, else 'cpu'."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def shape_bucket(L: int) -> int:
    """Sequence lengths bucket to the next power of two."""
    b = 1
    while b < L:
        b *= 2
    return b


def table_key(L: int, nr: int, mode: str, ratio: int = 1,
              dtype: str = "float32") -> str:
    return f"L{shape_bucket(L)}_nr{nr}_{mode}_r{ratio}_{dtype}"


def decode_key(*, G: int, d: int, dv: int, nr: int, levels: int,
               quant: bool = False, dtype: str = "float32") -> str:
    """Table key of a staged decode attend: its plan depends on these."""
    return (f"G{G}_D{d}_Dv{dv}_nr{nr}_lev{levels}"
            f"{'_int8' if quant else ''}_{dtype}")


def tile_of(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The launcher's fields of a candidate or a decision (a sub
    backward's rows a tile follow its splits: not a field)."""
    return {f: int(cfg[f]) for f in TILE_FIELDS
            if f in cfg and not (f == "tq" and "splits" in cfg)}


# ---------------------------------------------------------------------------
# candidates and rules (mirrors of the launchers, in the kernel modules)
# ---------------------------------------------------------------------------

def _band_body(family: str, mode: str, nr: int, d: int, dv: int) -> str:
    from . import h1d_block as hb
    if family in ("sub_fwd", "sub_bwd"):
        return "sub"
    check = hb.check_window_fwd if family == "band_fwd" else \
        hb.check_window_bwd
    body = check(mode, nr, d, dv)
    return "sub" if mode == "coarse_causal" else body


def _split_cands(G: int, nq: int, d: int, dv: int, nr: int):
    from . import h1d_block as hb
    out = []
    for S in (1, 2, 4, 8):
        if S > 1 and (nq < hb.SUB_TQ or (G * (nq // hb.SUB_TQ)) % S):
            continue
        tq = hb.sub_bwd_tq(G, nq, S, d, dv, nr)
        if 4 * hb.sub_bwd_floats(tq, d, dv, nr) <= hb.SMEM_MAX:
            out.append({"splits": S, "tq": tq, "layout": "sub"})
    return out


def _dkvw_pairs(mode: str, L: int, d: int, dv: int, nr: int):
    """(key blocks a CTA, reader rows a chunk) pairs that
    ``band_dkvw_tiles`` walks: key blocks halved from BAND_KEYS / nr
    (capped at L / nr), reader rows BAND_KV_TQ or 16 where half of
    BAND_KV_TQ does not already hold a CTA's readers, within SMEM_MAX."""
    from . import h1d_block as hb
    nb = L // nr
    n = hb.BAND_KEYS // nr if hb.BAND_KEYS > nr else 1
    while n > nb:
        n //= 2
    out = []
    while n >= 1:
        readers = (n + (1 if mode == "l0_causal" else 2)) * nr
        for t in (hb.BAND_KV_TQ, 16):
            if t > 16 and t // 2 >= readers:
                continue
            if 4 * hb.band_dkvw_floats(mode, n, t, d, dv, nr) <= hb.SMEM_MAX:
                out.append((n, t))
        n //= 2
    return out


def band_candidates(family: str, *, L: int, nr: int, mode: str,
                    ratio: int = 1, d: int = 64, dv: Optional[int] = None,
                    B: int = 1, G: int = 1) -> List[Dict[str, Any]]:
    """Every tile the launcher of a band family takes at one shape (no
    budget applied: see :meth:`KernelPolicy.candidates`)."""
    from . import h1d_block as hb
    dv = d if dv is None else dv
    if family in ("sub_fwd", "sub_bwd"):
        mode = _SUB
    body = _band_body(family, mode, nr, d, dv)
    if body == "stream":
        return [{"tq": hb.STREAM_TQ, "layout": "stream", "fixed": True}]
    if family.endswith("fwd"):
        if body == "sub":
            return [{"tq": hb.SUB_TQ, "layout": "sub", "fixed": True}]
        return [{"tq": t, "layout": "band"} for t in (16, hb.BAND_TQ)
                if 4 * hb.band_fwd_floats(mode, t, d, dv, nr) <= hb.SMEM_MAX]
    if body == "sub":
        return _split_cands(G, nr * (ratio if mode == _SUB else 1), d, dv,
                            nr)
    dq = [t for t in (16, hb.BAND_TQ)
          if 4 * hb.band_dq_floats(mode, t, d, dv, nr) <= hb.SMEM_MAX]
    return [{"tq": t, "nkb": n, "tk": tk, "layout": "band"}
            for t in dq for n, tk in _dkvw_pairs(mode, L, d, dv, nr)]


def attend_candidates(*, G: int, d: int, dv: int, nr: int, levels: int,
                      quant: bool = False, half: bool = False
                      ) -> List[Dict[str, Any]]:
    """The staged decode attend's plans at one shape: chunks of nr rows
    halved while a multiple of the row quantum, each resident (nr rows,
    where every band fits) or a ring of as many stages as fit; rings of
    fewer than 2 stages only where the launcher's own rule takes one."""
    from . import h1d_decode_kernel as dk
    rule = dk.plan_attend_stages(G, d, dv, nr, levels, quant, half)
    out = []
    for cr in dk.attend_chunks(nr, rule.quantum):
        p = dk.plan_attend_stages(G, d, dv, nr, levels, quant, half, cr=cr)
        if p.stages >= 2 or (p.stages >= 1 and cr == rule.chunk_rows):
            out.append({"cr": cr, "stages": p.stages,
                        "resident": p.resident,
                        "layout": "resident" if p.resident else "ring",
                        "vmem_bytes": p.smem})
    return out


def default_tile(family: str, **shape) -> Dict[str, Any]:
    """The committed default of one launch: the rule that
    ``tuning_defaults.json`` names for the family (and mode or body),
    evaluated at the shape.  Logs nothing."""
    return _rule_tile(_load_defaults_cached(), family, shape)


def _rule_for(defaults, family: str, mode: Optional[str],
              body: Optional[str]) -> str:
    fam = defaults.get("tables", {}).get(family, {})
    ent = fam.get(f"body:{body}") if body == "stream" else None
    ent = ent or fam.get(f"mode:{mode}") or fam.get("default")
    if ent is not None:
        return ent.get("rule", "fixed")
    # no committed entry (an unreadable defaults file): the same rules
    if family in ATTEND_FAMILIES:
        return "plan_attend_stages"
    if body == "stream" or family.endswith("fwd") and body == "sub":
        return "fixed"
    if body == "sub":
        return "sub_bwd_splits"
    return {"band_fwd": "band_fwd_tq", "band_bwd": "band_bwd_tiles"}[family]


def _rule_tile(defaults, family: str, shape) -> Dict[str, Any]:
    from . import h1d_block as hb
    if family in ATTEND_FAMILIES:
        rule = _rule_for(defaults, family, None, None)
        if rule == "plan_attend_stages":
            from . import h1d_decode_kernel as dk
            p = dk.plan_attend_stages(shape["G"], shape["d"], shape["dv"],
                                      shape["nr"], shape["levels"],
                                      shape.get("quant", False),
                                      shape.get("dtype") == "bfloat16")
            return {"cr": p.chunk_rows, "stages": p.stages,
                    "resident": p.resident,
                    "layout": "resident" if p.resident else "ring",
                    "vmem_bytes": p.smem}
        raise ValueError(f"{family}: unknown default rule {rule!r}")
    if family in UPDATE_FAMILIES:
        rows = shape.get("rows")
        return {"grid": (int(rows),) if rows is not None else "rows",
                "fixed": True}
    mode = _SUB if family in ("sub_fwd", "sub_bwd") else shape["mode"]
    d = shape.get("d", 64)
    dv = shape.get("dv") or d
    L, nr, B, G = shape["L"], shape["nr"], shape.get("B", 1), \
        shape.get("G", 1)
    ratio = shape.get("ratio", 1)
    body = _band_body(family, mode, nr, d, dv)
    rule = _rule_for(defaults, family, mode, body)
    if rule == "fixed":
        (cand,) = band_candidates(family, L=L, nr=nr, mode=mode,
                                  ratio=ratio, d=d, dv=dv, B=B, G=G)
        return cand
    if rule == "band_fwd_tq":
        return {"tq": hb.band_fwd_tq(mode, B, G, L, d, dv, nr),
                "layout": "band"}
    if rule == "band_bwd_tiles":
        nkb, tk = hb.band_dkvw_tiles(mode, B, L, d, dv, nr)
        return {"tq": hb.band_fwd_tq(mode, B, G, L, d, dv, nr,
                                     backward=True),
                "nkb": nkb, "tk": tk, "layout": "band"}
    if rule == "sub_bwd_splits":
        nq = nr * (ratio if mode == _SUB else 1)
        S = hb.sub_bwd_splits(G, nq)
        return {"splits": S, "tq": hb.sub_bwd_tq(G, nq, S, d, dv, nr),
                "layout": "sub"}
    raise ValueError(f"{family}: unknown default rule {rule!r}")


def resolve_tq(L: int, nr: int, tq: int, mode: str, ratio: int = 1, *,
               family: Optional[str] = None, B: int = 1, G: int = 1,
               d: int = 64, dv: Optional[int] = None) -> int:
    """The largest rows-a-tile candidate of the band forward (``sub``:
    its one tile, ``SUB_TQ``) at or below the ``tq`` hint.  Raises on
    shapes no tile can cover (L not a multiple of nr) and on a hint
    below every candidate, naming the caller's mode / ratio."""
    if L % nr:
        raise ValueError(
            f"band_attention[mode={mode}, ratio={ratio}]: L={L} is not a "
            f"multiple of nr={nr}; no kernel tiling exists (pad the "
            f"sequence first)")
    if family is None:
        family = "sub_fwd" if mode == _SUB else "band_fwd"
    cands = band_candidates(family, L=L, nr=nr, mode=mode, ratio=ratio,
                            d=d, dv=dv, B=B, G=G)
    if len(cands) == 1 and cands[0].get("fixed"):
        return int(cands[0]["tq"])
    ok = [c["tq"] for c in cands if c["tq"] <= tq]
    if not ok:
        raise ValueError(
            f"band_attention[mode={mode}, ratio={ratio}]: tq hint {tq} is "
            f"below every tile that fits L={L} (nr={nr}, d={d}): "
            f"{[c['tq'] for c in cands]}")
    return int(max(ok))


_DEFAULTS_CACHE: Dict[str, Any] = {}


def _load_defaults(path: Optional[str] = None) -> Dict[str, Any]:
    try:
        with open(path or _DEFAULTS_PATH) as f:
            return json.load(f)
    except (OSError, ValueError) as e:  # pragma: no cover - repo file
        warnings.warn(f"repro_tune: committed defaults unreadable "
                      f"({e}); using the launchers' rules", RuntimeWarning)
        return {"version": TABLE_VERSION, "tables": {}}


def _load_defaults_cached() -> Dict[str, Any]:
    if "d" not in _DEFAULTS_CACHE:
        _DEFAULTS_CACHE["d"] = _load_defaults()
    return _DEFAULTS_CACHE["d"]


def _legal(cands, hint: Dict[str, int]) -> Optional[Dict[str, Any]]:
    """The candidate that equals ``hint`` in each of its tile fields, else
    the largest whose every such field is at or below the hint's."""
    if not cands:
        return None
    for c in cands:
        if all(c.get(f) == v for f, v in hint.items()):
            return c
    below = [c for c in cands
             if all(f in c and c[f] <= v for f, v in hint.items())]
    if not below:
        return None
    return max(below, key=lambda c: tuple(c.get(f, 0) for f in TILE_FIELDS))


class KernelPolicy:
    """One launch-policy object per process (:func:`get_policy`)."""

    def __init__(self, backend: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 defaults_path: Optional[str] = None,
                 device: Optional[str] = None):
        self.backend = backend or detect_backend()
        if device is None and self.backend == "cuda" and \
                torch.cuda.is_available():
            device = torch.cuda.get_device_name()
        self.device = device
        env_dir = os.environ.get("REPRO_TUNE_CACHE")
        if env_dir is not None and ("\0" in env_dir
                                    or not env_dir.strip()):
            warnings.warn(
                f"repro_tune: REPRO_TUNE_CACHE={env_dir!r} is not a "
                f"usable path; using the default cache dir",
                RuntimeWarning)
            env_dir = None
        self.cache_dir = (cache_dir or env_dir
                          or os.path.expanduser("~/.cache/repro_tune"))
        self.defaults = _load_defaults(defaults_path)
        self._tables: Dict[str, Dict[str, Any]] = {}
        self._memo: Dict[tuple, Tuple[Dict[str, Any], str, str]] = {}
        self.decisions: collections.deque = collections.deque(maxlen=512)

    # -- impl validation ----------------------------------------------------

    def resolve_impl(self, impl: str, family: str = "band") -> str:
        """Validate ``impl``.  The port selects nothing by it (a tensor's
        device chooses the path); ``'auto'`` logs the backend it meets."""
        impl = canonical_impl(impl)
        if impl == "auto":
            self._log(family, f"impl@{self.backend}", "auto",
                      {"impl": "auto", "backend": self.backend})
        return impl

    # -- candidates ---------------------------------------------------------

    def candidates(self, family: str, *, L: int = 0, nr: int = 16,
                   mode: str = "l0_bidir", ratio: int = 1,
                   rows: Optional[int] = None, d: int = 64,
                   dv: Optional[int] = None, B: int = 1, G: int = 1,
                   dtype: str = "float32", levels: Optional[int] = None,
                   quant: bool = False,
                   vmem_budget: Optional[int] = None
                   ) -> List[Dict[str, Any]]:
        """Legal launch configs of one family at one shape: the tiles its
        launcher takes, each with its shared memory (``vmem_bytes``, the
        larger launch of a backward; ``analysis.vmem``); those over the
        budget (``analysis.vmem.default_budget``, the H100's 227 KB) are
        dropped and logged as ``rejected:vmem``.  The decode attends take
        ``levels``; the updates have one config, their ``(rows,)`` grid."""
        if family not in FAMILIES:
            raise ValueError(f"unknown kernel family {family!r}: "
                             f"allowed families are {FAMILIES}")
        dv = d if dv is None else dv
        if family in UPDATE_FAMILIES:
            return [{"grid": (int(rows),) if rows is not None else "rows",
                     "fixed": True}]
        from ..analysis import vmem as vmem_mod
        budget = (vmem_mod.default_budget() if vmem_budget is None
                  else int(vmem_budget))
        if family in ATTEND_FAMILIES:
            if levels is None:
                from ..core import hierarchy as hc
                levels = hc.num_levels(L, nr) + 1
            key = decode_key(G=G, d=d, dv=dv, nr=nr, levels=levels,
                             quant=quant, dtype=dtype)
            out = attend_candidates(G=G, d=d, dv=dv, nr=nr, levels=levels,
                                    quant=quant, half=dtype == "bfloat16")
        else:
            if family in ("sub_fwd", "sub_bwd"):
                mode = _SUB
            key = table_key(L, nr, mode, ratio, dtype)
            out = []
            for cand in band_candidates(family, L=L, nr=nr, mode=mode,
                                        ratio=ratio, d=d, dv=dv, B=B, G=G):
                nbytes = vmem_mod.band_launch_bytes(
                    family, L=L, nr=nr, mode=mode, ratio=ratio, tq=cand,
                    d=d, dv=dv, B=B, G=G, dtype=dtype)
                out.append(dict(cand, vmem_bytes=int(nbytes)))
        kept = []
        for cand in out:
            if cand["vmem_bytes"] > budget:
                self._log(family, key, "rejected:vmem",
                          dict(cand, budget=int(budget),
                               reason=f"vmem {cand['vmem_bytes']} > "
                                      f"budget {int(budget)}"))
            else:
                kept.append(cand)
        return kept

    # -- resolution: override > table > default ------------------------------

    def resolve(self, family: str, *, override=None, **shape
                ) -> Tuple[Dict[str, Any], str]:
        """(config, source) of one launch of ``family`` at ``shape`` (the
        keyword arguments of :meth:`candidates`).  ``override`` (an int:
        rows a tile; or a candidate's fields) bypasses tuning, legalized
        to the largest candidate at or below it; else the table entry of
        the shape's key, legalized the same way; else the committed
        default.  Every resolution is logged; the configs are shared
        between the log and the callers, which read them only.  A launch
        asks once per call, so a shape seen before costs one lookup."""
        if override is None:
            hit = self._memo.get((family, *shape.items()))
            if hit is not None:
                self.decisions.append({"family": family, "key": hit[2],
                                       "source": hit[1], "config": hit[0]})
                return hit[0], hit[1]
        if family in UPDATE_FAMILIES:
            key, cfg, src = "grid", _rule_tile(self.defaults, family,
                                               shape), "default"
        else:
            key = self._key(family, shape)
            if override is not None:
                cfg = self._legalize(family, shape, override, strict=True)
                self._log(family, key, "override", cfg)
                return cfg, "override"
            entry = self._entries(family).get(key)
            cfg = None
            if entry is not None:
                cfg = self._legalize(family, shape, tile_of(entry),
                                     strict=False)
            src = "table"
            if cfg is None:
                cfg, src = _rule_tile(self.defaults, family, shape), \
                    "default"
        self._memo[(family, *shape.items())] = (cfg, src, key)
        self._log(family, key, src, cfg)
        return cfg, src

    def band_tq(self, *, L: int, nr: int, mode: str, ratio: int = 1,
                dtype: str = "float32", override: Optional[int] = None,
                family: Optional[str] = None, B: int = 1, G: int = 1,
                d: int = 64, dv: Optional[int] = None) -> int:
        """Rows a tile of one band forward launch (the reference's
        surface over :meth:`resolve`)."""
        if family is None:
            family = "sub_fwd" if mode == _SUB else "band_fwd"
        cfg, _ = self.resolve(family, override=override, L=L, nr=nr,
                              mode=mode, ratio=ratio, dtype=dtype, B=B, G=G,
                              d=d, dv=d if dv is None else dv)
        return int(cfg["tq"])

    def note_launch(self, family: str, **config) -> None:
        """Record a launch whose config space is trivial."""
        self._log(family, "grid", "default",
                  dict(config, grid=config.get("grid", "rows")))

    def _key(self, family: str, shape) -> str:
        if family in ATTEND_FAMILIES:
            return decode_key(G=shape["G"], d=shape["d"], dv=shape["dv"],
                              nr=shape["nr"], levels=shape["levels"],
                              quant=shape.get("quant", False),
                              dtype=shape.get("dtype", "float32"))
        mode = _SUB if family in ("sub_fwd", "sub_bwd") else shape["mode"]
        return table_key(shape["L"], shape["nr"], mode,
                         shape.get("ratio", 1),
                         shape.get("dtype", "float32"))

    def _legalize(self, family: str, shape, hint, strict: bool
                  ) -> Optional[Dict[str, Any]]:
        cands = self.candidates(family, **shape)
        if len(cands) == 1 and cands[0].get("fixed"):
            return cands[0]        # a compile-time tile: nothing to choose
        if isinstance(hint, int):
            hint = {"tq": hint}
        hint = {f: int(v) for f, v in hint.items()
                if f in TILE_FIELDS and any(f in c for c in cands)}
        if any("splits" in c for c in cands):
            hint.pop("tq", None)   # the rows a tile follow the splits
        if family == "band_bwd" and "tq" in hint and "nkb" not in hint:
            rule = _rule_tile(self.defaults, family, shape)
            hint.update(nkb=rule["nkb"], tk=rule["tk"])
        if not hint:
            return _rule_tile(self.defaults, family, shape)
        cfg = _legal(cands, hint)
        if cfg is None and strict:
            raise ValueError(
                f"{family}: tile {hint} fits no launch at {shape}; the "
                f"candidates are {[tile_of(c) for c in cands]}")
        return cfg

    # -- on-disk tables -----------------------------------------------------

    def _table_path(self, family: str) -> str:
        return os.path.join(self.cache_dir, self.backend, f"{family}.json")

    def _entries(self, family: str) -> Dict[str, Any]:
        if family in self._tables:
            return self._tables[family]
        path = self._table_path(family)
        entries: Dict[str, Any] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    table = json.load(f)
                if not isinstance(table, dict):
                    raise ValueError("not a JSON object")
                if table.get("version") != TABLE_VERSION:
                    warnings.warn(
                        f"repro_tune: tuning table {path} has version "
                        f"{table.get('version')!r} != {TABLE_VERSION}; "
                        f"ignoring it (falling back to defaults)",
                        RuntimeWarning)
                elif (table.get("backend") not in (None, self.backend)
                      or table.get("device") not in (None, self.device)):
                    warnings.warn(
                        f"repro_tune: tuning table {path} was measured on "
                        f"backend {table.get('backend')!r} (card "
                        f"{table.get('device')!r}), not {self.backend!r} "
                        f"(card {self.device!r}); ignoring it (falling "
                        f"back to defaults)", RuntimeWarning)
                else:
                    entries = dict(table.get("entries", {}))
            except (OSError, ValueError) as e:
                warnings.warn(
                    f"repro_tune: corrupt tuning table {path} ({e}); "
                    f"falling back to defaults", RuntimeWarning)
        self._tables[family] = entries
        return entries

    def _save_table(self, family: str) -> Optional[str]:
        """Persist one family's table; an unwritable cache dir keeps the
        entries in memory with a ``RuntimeWarning``."""
        path = self._table_path(family)
        payload = {"version": TABLE_VERSION, "backend": self.backend,
                   "device": self.device, "kernel": family,
                   "entries": self._tables.get(family, {})}
        tmp = path + ".tmp"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except (OSError, ValueError) as e:
            warnings.warn(
                f"repro_tune: cannot persist tuning table {path} ({e}); "
                f"keeping measured entries in memory only", RuntimeWarning)
            return None
        return path

    # -- measured autotune pass ---------------------------------------------

    def autotune_band(self, *, L: int, nr: int, mode: str, ratio: int = 1,
                      d: int = 64, dv: Optional[int] = None, B: int = 1,
                      G: int = 1, iters: int = 10, warmup: int = 2,
                      family: Optional[str] = None,
                      vmem_budget: Optional[int] = None) -> Dict[str, Any]:
        """Measure every candidate of one band family at one shape on the
        card (device microseconds a call, :meth:`_measure`), persist the
        fastest to the table of the shape's key and return its entry
        (``measured``: every candidate's microseconds).  A table hit
        measures nothing; on the CPU (no card to measure) a miss raises
        ``RuntimeError``."""
        if family is None:
            family = "sub_fwd" if mode == _SUB else "band_fwd"
        if family not in BAND_FAMILIES:
            raise ValueError(f"autotune_band tunes {BAND_FAMILIES}, not "
                             f"{family!r}")
        dv = d if dv is None else dv
        key = table_key(L, nr, mode, ratio)
        entries = self._entries(family)
        if key in entries:
            self._log(family, key, "table", tile_of(entries[key]))
            return dict(entries[key])
        if self.backend != "cuda":
            raise RuntimeError(
                f"autotune_band measures on the card; the backend is "
                f"{self.backend!r}")
        best: Optional[Tuple[Dict[str, Any], float]] = None
        measured = []
        for cand in self.candidates(family, L=L, nr=nr, mode=mode,
                                    ratio=ratio, d=d, dv=dv, B=B, G=G,
                                    vmem_budget=vmem_budget):
            fn = self._band_runner(family, cand, L=L, nr=nr, mode=mode,
                                   ratio=ratio, d=d, dv=dv, B=B, G=G)
            us = self._measure(fn, iters=iters, warmup=warmup)
            measured.append([tile_of(cand), round(us, 3)])
            if best is None or us < best[1]:
                best = (cand, us)
        assert best is not None, (
            f"no measurable candidates for {family} {key} (all rejected? "
            f"see rejected:vmem decision-log entries)")
        entry = dict(best[0], us=round(best[1], 3), source="measured",
                     measured=measured)
        entries[key] = entry
        self._save_table(family)
        self._memo.clear()
        self._log(family, key, "measured", tile_of(entry))
        return dict(entry)

    def _band_runner(self, family: str, cand, *, L, nr, mode, ratio, d, dv,
                     B, G):
        """A call of the family's kernel wrapper at ``cand`` on seeded
        CUDA tensors (w all positive, so every key is live)."""
        from . import h1d_block, h1d_block_bwd
        gen = torch.Generator(device="cuda").manual_seed(0)
        sub = family.startswith("sub")
        Lk = L // ratio if sub else L

        def rnd(*s):
            return torch.randn(s, generator=gen, device="cuda")
        q, k, v = rnd(B, G, L, d), rnd(B, Lk, d), rnd(B, Lk, dv)
        w = torch.rand((B, Lk), generator=gen, device="cuda") + 0.5
        tile = tile_of(cand)
        if sub:
            fwd = lambda: h1d_block.band_attention_sub_fwd(  # noqa: E731
                q, k, v, w, nr=nr, ratio=ratio)
        else:
            fwd = lambda: h1d_block.band_attention_fwd(  # noqa: E731
                q, k, v, w, nr=nr, mode=mode,
                tq=tile if family == "band_fwd" else None)
        if family.endswith("fwd"):
            return fwd
        y, dn, m = fwd()
        gy, gdn, gm = rnd(*y.shape), rnd(*dn.shape), rnd(*m.shape)
        if sub:
            return lambda: h1d_block_bwd.band_attention_sub_bwd(
                q, k, v, w, y, dn, m, gy, gdn, gm, nr=nr, ratio=ratio,
                tq=tile)
        return lambda: h1d_block_bwd.band_attention_bwd(
            q, k, v, w, y, dn, m, gy, gdn, gm, nr=nr, mode=mode, tq=tile)

    def _measure(self, fn, iters: int = 10, warmup: int = 2,
                 repeats: int = 5) -> float:
        """Device microseconds a call: ``warmup`` calls, then the median
        over ``repeats`` of CUDA events around ``iters`` calls enqueued
        back to back behind a spin kernel long enough to cover their host
        time, so that the events see the kernels' time and not the
        host's.  Separated out so tests can stub it."""
        import time
        t0 = time.perf_counter()
        for _ in range(max(warmup, 1)):
            fn()
        torch.cuda.synchronize()
        host_s = (time.perf_counter() - t0) / max(warmup, 1)
        # ~2e9 cycles a second: twice the enqueue time of the iterations
        spin = int(min(4 * host_s * max(iters, 1) * 1e9, 2e9))
        times = []
        for _ in range(max(repeats, 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(max(iters, 1)):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / max(iters, 1))
        return sorted(times)[len(times) // 2]

    # -- observability ------------------------------------------------------

    def _log(self, family: str, key: str, source: str,
             config: Dict[str, Any]) -> None:
        self.decisions.append({"family": family, "key": key,
                               "source": source, "config": config})

    def tuning_digest(self) -> str:
        """12-hex digest over the committed defaults, every readable table
        of the backend and the kernels' sources and flags."""
        from ._build import kernels_digest
        tables: Dict[str, Any] = {}
        bdir = os.path.join(self.cache_dir, self.backend)
        if os.path.isdir(bdir):
            for f in sorted(os.listdir(bdir)):
                if f.endswith(".json"):
                    tables[f[:-5]] = self._entries(f[:-5])
        blob = {"version": TABLE_VERSION, "backend": self.backend,
                "defaults": self.defaults, "tables": tables,
                "kernels": kernels_digest()}
        return hashlib.sha1(
            json.dumps(blob, sort_keys=True).encode()).hexdigest()[:12]


_POLICY: Optional[KernelPolicy] = None


def get_policy() -> KernelPolicy:
    """The process-wide launch policy (constructed on first use)."""
    global _POLICY
    if _POLICY is None:
        _POLICY = KernelPolicy()
    return _POLICY


def set_policy(policy: Optional[KernelPolicy]) -> Optional[KernelPolicy]:
    """Swap the process policy (tests, benchmarks); returns the previous
    one so that callers can restore it."""
    global _POLICY
    prev, _POLICY = _POLICY, policy
    return prev


def _main(argv=None):  # pragma: no cover - runs on the card
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--autotune-smoke", action="store_true",
                    help="measured autotune round trip on a small shape "
                         "(respects $REPRO_TUNE_CACHE; needs the card)")
    ap.add_argument("--assert-cached", action="store_true",
                    help="assert a prior --autotune-smoke's table is "
                         "applied WITHOUT measuring (pair with the same "
                         "$REPRO_TUNE_CACHE)")
    ap.add_argument("--L", type=int, default=64)
    ap.add_argument("--nr", type=int, default=16)
    ap.add_argument("--d", type=int, default=16)
    args = ap.parse_args(argv)
    p = KernelPolicy()
    print(f"backend={p.backend} device={p.device} cache_dir={p.cache_dir}")
    if args.assert_cached:
        p._measure = None  # any measurement attempt would TypeError
        tq = p.band_tq(L=args.L, nr=args.nr, mode="l0_causal", d=args.d)
        src = p.decisions[-1]["source"]
        assert src == "table", (src, list(p.decisions))
        print(f"cross-process round-trip OK: tq={tq} source={src}")
    if args.autotune_smoke:
        for family, mode, ratio in (("band_fwd", "l0_causal", 1),
                                    ("band_bwd", "l0_causal", 1),
                                    ("sub_bwd", "sub", 2)):
            e = p.autotune_band(L=args.L, nr=args.nr, mode=mode,
                                ratio=ratio, d=args.d, family=family)
            print(f"{family} {mode} r{ratio}: {e}")
        p2 = KernelPolicy(cache_dir=p.cache_dir)
        tq = p2.band_tq(L=args.L, nr=args.nr, mode="l0_causal", d=args.d)
        src = p2.decisions[-1]["source"]
        assert src == "table", (src, list(p2.decisions))
        print(f"round-trip OK: tq={tq} source={src}")
    print(f"tuning_digest={p.tuning_digest()}")


if __name__ == "__main__":  # pragma: no cover
    _main()
