"""Atomic, restartable checkpointing with no external dependencies
(counterpart of ``repro.checkpoint.store``, the same on-disk layout):

    <dir>/step_00000123/
        skeleton.json      (the tree's nested dict/list/tuple structure)
        manifest.json      (step, and per leaf: file, shape, dtype, checksum)
        leaf_0000.npy ...

Leaves are numbered in sorted-key order, as ``jax.tree.flatten`` numbers a
dict tree. A checkpoint is written to a temporary directory and renamed
into place (atomic on POSIX), so a crash mid-save never corrupts the latest
checkpoint; ``load_latest`` skips checkpoints whose manifest or checksums
do not validate. Tensors are saved from the device as numpy arrays and come
back as numpy arrays; the caller moves them to its device. Restoring onto
a mesh (the reference's ``shardings``) waits for ROADMAP queue 1,
*Multi-device*, placement and entry points: a data-parallel rank holds
every parameter whole and loads as one device does.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _leaves(tree) -> list:
    """Leaves in the skeleton's order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, async_: bool = False):
        """Write ``tree`` (nested dicts/lists/tuples of tensors or arrays) as
        ``step``. The device-to-host copy happens here; with ``async_`` the
        files are written by a background thread (``wait`` joins it)."""
        host_tree = _to_host(tree)
        if async_:
            self.wait()
            self._async_thread = threading.Thread(
                target=self._write, args=(step, host_tree), daemon=True)
            self._async_thread.start()
        else:
            self._write(step, host_tree)

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, host_tree):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, f".tmp_{name}")
        final = os.path.join(self.dir, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "skeleton.json"), "w") as f:
            json.dump(_make_skeleton(host_tree, [0]), f)
        manifest = {"step": step, "leaves": []}
        for i, leaf in enumerate(_leaves(host_tree)):
            arr = np.asarray(leaf)
            fn = f"leaf_{i:04d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            with open(os.path.join(tmp, fn), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            manifest["leaves"].append({"file": fn, "shape": list(arr.shape),
                                       "dtype": str(arr.dtype), "sha": digest})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- load ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_"):
                try:
                    out.append(int(n[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _validate(self, path) -> Optional[dict]:
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            for rec in manifest["leaves"]:
                with open(os.path.join(path, rec["file"]), "rb") as f:
                    if hashlib.sha256(f.read()).hexdigest()[:16] != rec["sha"]:
                        return None
            return manifest
        except (OSError, json.JSONDecodeError, KeyError):
            return None

    def load_latest(self):
        """``(step, tree of numpy arrays)`` of the newest checkpoint that
        validates, or None. Corrupt checkpoints are skipped."""
        for step in reversed(self.all_steps()):
            path = os.path.join(self.dir, f"step_{step:08d}")
            manifest = self._validate(path)
            if manifest is None:
                continue
            leaves = [np.load(os.path.join(path, rec["file"]))
                      for rec in manifest["leaves"]]
            with open(os.path.join(path, "skeleton.json")) as f:
                skeleton = json.load(f)
            return step, _from_skeleton(skeleton, leaves)
        return None


def _make_skeleton(tree, counter):
    """JSON-serializable structure with leaf indices (dict/list/tuple trees)."""
    if isinstance(tree, dict):
        return {"__dict__": {k: _make_skeleton(tree[k], counter) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        kind = "__tuple__" if isinstance(tree, tuple) else "__list__"
        return {kind: [_make_skeleton(v, counter) for v in tree]}
    i = counter[0]
    counter[0] += 1
    return {"__leaf__": i}


def _from_skeleton(skel, leaves):
    if "__leaf__" in skel:
        return leaves[skel["__leaf__"]]
    if "__dict__" in skel:
        return {k: _from_skeleton(v, leaves) for k, v in skel["__dict__"].items()}
    if "__list__" in skel:
        return [_from_skeleton(v, leaves) for v in skel["__list__"]]
    if "__tuple__" in skel:
        return tuple(_from_skeleton(v, leaves) for v in skel["__tuple__"])
    raise ValueError(f"bad skeleton node: {skel}")
