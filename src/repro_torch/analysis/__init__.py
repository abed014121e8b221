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
* :mod:`.violation` -- the record both checkers report.
* ``python -m repro_torch.analysis.check`` -- the gate: ``--dist``,
  ``--pool`` and ``--json`` reports.  The reference's kernels section
  (its ``checker``, ``vmem`` and ``tuning``) is not ported yet.

Only ``contracts`` is imported eagerly (the kernels import it).
"""
from . import contracts

__all__ = ["contracts"]
