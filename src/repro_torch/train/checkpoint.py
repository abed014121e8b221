"""Atomic checkpoints of tensor trees, in the reference's on-disk layout.

Port of ``repro.train.checkpoint``.  Layout per step::

    <dir>/step_00000100.tmp/    # written first
        manifest.json           # {"step", "leaves": [{path, file, dtype,
        arr_00000.npy ...       #   shape}]}, one .npy file per leaf
        COMMIT                  # marker written last
    <dir>/step_00000100/        # renamed from .tmp on completion

A crash mid-write leaves only a ``.tmp`` directory (or a directory
without ``COMMIT``), which ``latest_step`` ignores, so a restart resumes
from the last complete checkpoint.  Leaf paths follow
``repro_torch.tree`` (JAX's path names), and ``restore`` loads each leaf
onto the device of the matching leaf of ``like`` unless given a
``device``.  A bfloat16 leaf, which numpy has no type for, is stored as
its uint16 bit pattern with ``"dtype": "bfloat16"`` in the manifest and
restored bit for bit.  ``AsyncCheckpointer`` copies the tree to host
memory on the caller's thread and writes it on a background thread, so
the train loop blocks only on a save that is still running.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_flatten_with_paths, tree_map, tree_map_with_path


def _host(x):
    """A leaf in host memory: a CPU tensor, or a numpy array.  A tensor
    is always copied, a CPU one too: a train step updates the state's
    tensors in place while the saver's thread writes the copy."""
    return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _stored(x):
    """(the array written to disk, the manifest's dtype) of a leaf."""
    x = _host(x)
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = x.numpy() if isinstance(x, torch.Tensor) else x
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tree_flatten_with_paths(tree)):
        arr, dtype = _stored(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "dtype": dtype,
             "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            best = max(best or 0, int(m.group(1)))
    return best


def restore(ckpt_dir: str, step: int, like: Any, *, device=None) -> Any:
    """The checkpoint of ``step`` in the structure of ``like``; each leaf
    goes to ``device``, or to the device of ``like``'s leaf."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    def load(p, ref):
        entry = by_path[p]
        arr = np.load(os.path.join(path, entry["file"]))
        dev = device if device is not None else getattr(ref, "device", "cpu")
        if entry["dtype"] == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    return tree_map_with_path(load, like)


class AsyncCheckpointer:
    """Background-thread saver; blocks only if a save is still running.
    An error of a save is raised by the next ``wait`` or ``save``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[Exception] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, step: int, tree: Any):
        self.wait()
        host_tree = tree_map(_host, tree)

        def _run():
            try:
                save(self.dir, step, host_tree)
                self._gc()
            except Exception as e:      # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.dir))
            if m)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
