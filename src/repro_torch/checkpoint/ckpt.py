"""Checkpoint save / restore with a manifest and async save, in the
reference's on-disk format, so a checkpoint written by either package
restores in the other bit for bit.

Layout: <dir>/step_<N>/
    manifest.json   tree structure (``str`` of a JAX ``PyTreeDef``),
                    shapes, dtype names, step, extra metadata
    arrays.npz      the flattened leaves as raw bytes (``leaf_00000``, ...)

Leaves are flattened in ``jax.tree_util``'s order (sorted dict keys,
``models.common.tree_flatten``). npz cannot hold bfloat16 or the float8
types, so every leaf is stored as its raw bytes (uint8) and rebuilt from
the manifest's dtype name; bf16 travels through its uint16 bits, with no
``ml_dtypes``. ``load_checkpoint(..., device=)`` takes the place of the
reference's ``shardings``: leaves land on that device (the CPU when
None). One card has no mesh to re-shard onto.

Async mode copies the leaves to host memory first, then hands those host
arrays to a writer thread, so the train loop does not wait on the disk;
the thread never touches CUDA (each thread that runs CUDA work holds its
own library state, a cuBLAS thread a 32 MiB workspace on the card).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.common import (tree_flatten, tree_unflatten,
                                       treedef_str)

# dtypes numpy lacks: stored and read back through same-sized integer bits
_BITS = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16),
         "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
         "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8)}


def _dtype_name(t) -> str:
    if torch.is_tensor(t):
        return str(t.dtype).split(".")[-1]
    return str(np.asarray(t).dtype)


def to_host(t) -> np.ndarray:
    """A leaf as a host numpy array with the same bytes (bf16 as its
    uint16 bits)."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    name = _dtype_name(t)
    t = t.detach().cpu().contiguous()
    if name in _BITS:
        _, np_bits, torch_bits = _BITS[name]
        return t.view(torch_bits).numpy().view(np_bits)
    return t.numpy()


def from_host(raw: np.ndarray, name: str, shape, device=None) -> torch.Tensor:
    """Raw leaf bytes (uint8) as a tensor of dtype ``name`` and ``shape``."""
    if name in _BITS:
        dt, np_bits, torch_bits = _BITS[name]
        a = np.frombuffer(raw.tobytes(), np_bits).reshape(shape)
        t = torch.from_numpy(a.copy().view(
            np.int16 if np_bits is np.uint16 else np.uint8)).view(dt)
    else:
        a = np.frombuffer(raw.tobytes(), np.dtype(name)).reshape(shape)
        t = torch.from_numpy(a.copy())
    return t if device is None else t.to(device)


def _key(i: int) -> str:
    return f"leaf_{i:05d}"


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None, _async: bool = False):
    """Writes a checkpoint; returns a join() callable (no-op when sync)."""
    leaves, treedef = tree_flatten(tree)
    names = [_dtype_name(x) for x in leaves]
    host = [to_host(x) for x in leaves]
    stepdir = os.path.join(directory, f"step_{step:08d}")
    tmpdir = stepdir + ".tmp"

    def write():
        os.makedirs(tmpdir, exist_ok=True)
        np.savez(os.path.join(tmpdir, "arrays.npz"),
                 **{_key(i): np.frombuffer(a.tobytes(), np.uint8)
                    for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "treedef": treedef_str(treedef),
            "n_leaves": len(host),
            "shapes": [list(a.shape) for a in host],
            "dtypes": names,
            "extra": extra or {},
        }
        with open(os.path.join(tmpdir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(stepdir):
            shutil.rmtree(stepdir)
        os.replace(tmpdir, stepdir)  # atomic publish

    if _async:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t.join
    write()
    return lambda: None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                    device=None):
    """Restore into the structure of ``like``, each leaf on ``device`` (the
    CPU when None). Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    stepdir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(stepdir, "arrays.npz"))
    leaves, treedef = tree_flatten(like)
    assert len(leaves) == manifest["n_leaves"], (
        f"checkpoint has {manifest['n_leaves']} leaves, expected "
        f"{len(leaves)}")
    loaded = [from_host(data[_key(i)], manifest["dtypes"][i],
                        manifest["shapes"][i], device)
              for i in range(len(leaves))]
    return tree_unflatten(treedef, loaded), step, manifest["extra"]


class CheckpointManager:
    """Rolling checkpoint manager with async save and keep-N retention."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._pending = lambda: None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self._pending()  # back-pressure: one in-flight save at a time
        self._pending = save_checkpoint(self.directory, step, tree, extra,
                                        _async=self.async_save)
        # the in-flight save counts toward the retention budget
        self._gc(keep=self.keep - 1 if self.async_save else self.keep)

    def restore(self, like: Any, step: Optional[int] = None, device=None):
        self.wait()
        return load_checkpoint(self.directory, like, step, device)

    def wait(self):
        self._pending()
        self._pending = lambda: None

    def _gc(self, keep: Optional[int] = None):
        keep = max(1, keep if keep is not None else self.keep)
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
