"""Fault-tolerant checkpointing.

Port of ``src/repro/checkpoint/checkpointer.py``, with its on-disk
layout, so a checkpoint written by either package restores in the other:

  * ``step_%010d/`` holds one ``leaf_%05d.npy`` per leaf and a
    ``manifest.json`` of ``{"step", "leaves": [{"key", "file", "shape",
    "dtype"}]}``.  Leaves are numbered in JAX's flattening order (dict
    keys sorted, list and tuple items by index, ``None`` and empty
    containers holding none), and a key joins the path's dict keys and
    indices with ``/`` — the reference's ``_path_str`` rule.
  * **Atomicity** — a checkpoint is written into ``step_<n>.tmp`` and
    ``os.replace``d to ``step_<n>`` only after every leaf and the manifest
    are fsynced; ``latest_step`` skips ``.tmp`` directories and
    directories without a manifest.
  * **bf16** — numpy has no bfloat16, so a bf16 leaf is saved as its raw
    2-byte payload (``void`` of 2 bytes, the bytes the reference's
    ``ml_dtypes`` array holds) with ``"dtype": "bfloat16"`` in the
    manifest, and restored by the manifest's dtype.
  * **Placement** — restore puts each leaf on the device of the target's
    leaf, or on the device of the matching leaf of ``devices`` (a tree of
    ``torch.device`` in the target's structure): the one-device
    counterpart of the reference's ``shardings=``.  A leaf keeps the
    checkpoint's dtype, as the reference's does.
  * **Async** — ``Checkpointer(async_save=True)`` copies every leaf to
    host memory before it returns and writes on a worker thread, so the
    train loop blocks only for the device-to-host copy.
  * **Retention** — keep the last ``keep`` checkpoints.
  * **Sharded states and elastic restore** — the reference stores every
    leaf whole, whatever its sharding, and restores it under any target
    sharding.  ``Checkpointer(mesh=, placements=)`` takes a state whose
    leaves are this rank's slabs (``parallel.sharding.Placement``, by
    key; a leaf without one is whole): each save all-gathers every leaf
    over the mesh, rank 0 alone writes the whole leaves, then every rank
    meets at a barrier (after the write, or in ``wait`` when async).
    ``restore_checkpoint(placements=)`` cuts each rank's slab from the
    whole leaf, so a checkpoint saved on one mesh restores onto another,
    onto one device, and in the reference.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import gather_tensor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "Checkpointer"]

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


def _leaf_paths(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """``[(key, leaf)]`` in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaf_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaf_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _map_with_path(fn, tree, prefix: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, the
    containers (and their order) kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return fn("/".join(prefix), tree)


def _host(leaf) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of one leaf: a tensor read off its
    device, a bf16 one as its raw 2-byte payload."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(leaf):
    """A host copy of one leaf, made now (async saves write it later)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Atomic synchronous save.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_leaf_paths(tree)):
        arr, dtype = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": dtype}
        )
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, entry: dict) -> torch.Tensor:
    """One leaf's file as a CPU tensor of the manifest's dtype."""
    arr = np.load(os.path.join(path, entry["file"]))
    if entry["dtype"] == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, step: int, target, devices=None,
                       placements=None):
    """Restore into the structure of ``target`` (tensors, numpy arrays or
    numbers as leaves), each leaf a tensor on the device of the target's
    leaf (the CPU for a leaf that is not a tensor), or of ``devices``'s
    matching leaf when given.  With ``placements`` (a tree of
    ``Placement`` in the target's structure; a leaf without one is
    whole), each leaf is this rank's slab of the whole leaf saved, and the
    target holds slabs.  A key the checkpoint lacks raises ``KeyError``; a
    shape that differs from the target's (or a placement's whole shape),
    ``ValueError``."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    placed = dict(_leaf_paths(devices)) if devices is not None else {}
    slabs = dict(_leaf_paths(placements)) if placements is not None else {}

    def restore(key, leaf):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _load(path, entry)
        if key in slabs:
            if tuple(t.shape) != slabs[key].shape:
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {tuple(t.shape)} != "
                    f"placed {slabs[key].shape}")
            t = t[slabs[key].slices]
        if tuple(t.shape) != tuple(_shape(leaf)):
            raise ValueError(
                f"leaf {key!r}: checkpoint shape {tuple(t.shape)} != target "
                f"{tuple(_shape(leaf))}"
            )
        if key in placed:
            dev = placed[key]
        elif isinstance(leaf, torch.Tensor):
            dev = leaf.device
        else:
            dev = torch.device("cpu")
        return t.to(dev)

    return _map_with_path(restore, target)


class Checkpointer:
    """Retention + optional async writes over save/restore; with ``mesh``
    and ``placements``, of a sharded state (module docstring)."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False,
                 mesh=None, placements=None):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh
        self.placements = placements
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._errors: list[BaseException] = []
        if async_save:
            self._queue = queue.Queue()
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            step, host_tree = item
            try:
                save_checkpoint(self.directory, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def save(self, step: int, tree):
        if self.placements is not None:
            tree = self._gather(tree)
            if dist.get_rank() != 0:  # rank 0 alone writes
                if not self.async_save:
                    dist.barrier()
                return
        if self.async_save:
            host = _map_with_path(lambda _, leaf: _snapshot(leaf), tree)
            self._queue.put((step, host))
        else:
            save_checkpoint(self.directory, step, tree)
            self._gc()
            if self.placements is not None:
                dist.barrier()

    def _gather(self, tree):
        """Every leaf whole, gathered over the mesh leaf by leaf; rank 0
        keeps a host copy of each, the others drop theirs."""
        slabs = dict(_leaf_paths(self.placements))
        keep = dist.get_rank() == 0

        def whole(key, leaf):
            if key in slabs:
                leaf = gather_tensor(leaf, slabs[key], self.mesh)
            return _snapshot(leaf) if keep else None

        return _map_with_path(whole, tree)

    def wait(self):
        if self._queue is not None:
            self._queue.join()
        if self.placements is not None:
            dist.barrier()
        if self._errors:
            raise self._errors[0]

    def close(self):
        if self._queue is not None:
            self._queue.join()
            self._queue.put(None)
            self._worker.join()

    def latest_step(self):
        return latest_step(self.directory)

    def restore(self, step: int, target, devices=None):
        return restore_checkpoint(self.directory, step, target, devices,
                                  self.placements)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:010d}"),
                ignore_errors=True,
            )
