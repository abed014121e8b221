"""Launch analysis of the port's CUDA kernels.

Port of ``repro.analysis`` so far: :mod:`.contracts`, the launch record
each kernel wrapper hands over (the telemetry's per-launch accounting,
``repro_torch.obs.traffic``, reads it).  The reference's static checker,
SP ownership checker, pool model and VMEM estimator are not ported.
"""
from . import contracts

__all__ = ["contracts"]
