"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``.  Libraries go to ``build/kernels/`` at the repository
root, named by the hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

from ..analysis import contracts

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _target(name: str) -> Path:
    """Library path keyed by the source, every shared header and the
    flags, so an edit to any of them rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that have no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns the library
    paths; raises with the compiler's output if a build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=1)
def kernels_digest() -> str:
    """First 12 hex digits of a sha256 over every kernel source
    (``csrc/*.cu`` and ``*.cuh``, in name order) and the ``nvcc`` flags:
    the inputs a library's build is keyed by (:func:`_target`)."""
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def sources():
    """Stems of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``, with the
    ``argtypes`` of each launcher in ``signatures`` declared (every
    launcher returns its ``cudaGetLastError()`` as an int)."""
    lib = _LOADED.get(name)
    if lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel library {name!r} needs a CUDA card "
                               "and none is available")
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def expect(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """Validate a kernel operand: CUDA (or meta, :func:`on_meta`), dtype,
    exact shape, contiguous."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch_signatures(prefix: str) -> Dict[str, list]:
    """``argtypes`` of the readers a library exports for the launch
    records (``csrc/launch_info.cuh``): ``<prefix>_last_smem`` and
    ``<prefix>_last_attrs``."""
    return {f"{prefix}_last_smem": [ctypes.c_void_p],
            f"{prefix}_last_attrs": [ctypes.c_void_p]}


def last_smem(lib: ctypes.CDLL, prefix: str):
    """The dynamic shared memory, in bytes, of each kernel that the
    library's last launch ran, as its launcher set it."""
    out = (ctypes.c_int * 2)()
    getattr(lib, f"{prefix}_last_smem")(ctypes.addressof(out))
    return (out[0],) if out[1] == 0 else (out[0], out[1])


def last_launch(lib: ctypes.CDLL, prefix: str):
    """(shared memory, registers, CTAs an SM) of each kernel that the
    library's last launch ran (:func:`last_smem`, :func:`last_attrs`)."""
    return (last_smem(lib, prefix), *last_attrs(lib, prefix))


def last_attrs(lib: ctypes.CDLL, prefix: str):
    """((registers, ...), (CTAs an SM, ...)) of each kernel that the
    library's last launch ran: ``cudaFuncGetAttributes``' ``numRegs`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's block
    and dynamic shared memory."""
    out = (ctypes.c_int * 8)()
    check(getattr(lib, f"{prefix}_last_attrs")(ctypes.addressof(out)),
          f"{prefix}_last_attrs")
    n = 1 if out[6] == 0 and out[4] == 0 else 2
    return (tuple(out[4 * i] for i in range(n)),
            tuple(out[4 * i + 3] for i in range(n)))


def on_meta(operands, record, *args, **kw) -> bool:
    """Whether a wrapper's ``operands`` (every tensor it hands its kernel;
    ``None`` entries are skipped) are meta tensors.  A wrapper asks once
    its operands are validated and its outputs made: on meta it returns
    those empty outputs, of the kernel's shapes and dtypes, and builds,
    launches and counts nothing (``launch.specs``, ``dryrun`` and
    ``roofline`` run the models on meta tensors).  While a hook is
    registered or a ``contracts.capture()`` is open it also hands over
    the launch record ``record(*args, **kw)``, with the grid the launcher
    would build.  The route is all or nothing: a set that mixes meta with
    CUDA tensors raises ValueError, whichever operand comes first.  A CPU
    tensor takes the plain version before this point and an all-CUDA set
    answers False."""
    kinds = {t.device.type for t in operands if t is not None}
    if "meta" not in kinds:
        return False
    if kinds != {"meta"}:
        raise ValueError(f"kernel operands mix meta with "
                         f"{sorted(kinds - {'meta'})} tensors: the meta "
                         f"route takes meta operands only")
    if contracts.ACTIVE:
        contracts.record(record(*args, **kw))
    return True
