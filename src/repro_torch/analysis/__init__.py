"""Analysis of the port's kernels and serving layer.

* :mod:`.contracts` -- the launch record each kernel wrapper hands over
  (the telemetry's per-launch accounting, ``repro_torch.obs.traffic``,
  reads it).
* :mod:`.dist` -- cross-shard ownership, halo protocol and comm volume
  of the SP layer's rules over mesh sizes 1..8, with no device.
* :mod:`.pool_model` -- bounded exhaustive model checker of the serving
  layer's :class:`~repro_torch.serve.paged_cache.PagePool`, with
  replayable minimized counterexamples (also behind the pool's
  ``REPRO_POOL_CHECK=1`` hook).
* :mod:`.checker` -- what each CTA of a launch record reads and writes,
  from the kernels' host mirrors: in bounds, outputs written once,
  in-place updates aliased, tables within their domains, the launchers'
  grids and shared memory.
* :mod:`.vmem` -- each launch's shared memory from the launchers' plan
  mirrors, and the budget the launch policy (``kernels.tuning``) drops
  candidates against.
* :mod:`.violation` -- the record every checker reports.
* ``python -m repro_torch.analysis.check`` -- the gate: the kernels
  section (the default), ``--dist``, ``--pool`` and ``--json`` reports.

Only ``contracts`` is imported eagerly (the kernels import it).
"""
from . import contracts

__all__ = ["contracts"]
