"""Checkpointing: atomic, manifest-versioned, async-capable, placed on
restore — in the reference's layout, so that either package restores
what the other wrote.

The port of ``repro/train/checkpoint.py``. Layout:
    <dir>/step_<N>/arrays.npz      the flattened tree ('/'-joined keys)
    <dir>/step_<N>/manifest.json   step, tree description, keys, shapes, dtypes
    <dir>/LATEST                   atomic pointer file (rename-committed)

Keys are the reference's: dict keys, ``#i`` for a list or tuple entry;
an ``LMParams`` is written as the reference's tree of its parameters,
every layer leaf stacked along its layer axis (``LMParams.tree``). The
manifest's ``treedef`` is the port's own description of the tree (the
reference writes a JAX repr there and never reads it back).

Fault-tolerance contract, as the reference's:
  * ``save`` is crash-safe: written to step_<N>.tmp, fsync'd, renamed;
    LATEST is updated last, also by rename. A death at any point leaves a
    valid previous checkpoint.
  * ``restore(..., shardings)`` places each array where it is told: on a
    device (one for all, or a tree of them), or over a mesh by a
    ``sharding.partitioning.NamedSharding`` (``device_put``; the
    reference's elastic-remesh path). Restoring onto another device or
    mesh is the same code path.
  * ``AsyncCheckpointer`` writes on a worker thread after a copying
    host snapshot, taken before ``save`` returns: a point-in-time copy
    even where a CPU tensor's ``numpy()`` would share memory with a
    parameter the next step updates in place.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.models.transformer import LMParams
from repro_torch.sharding.partitioning import NamedSharding, device_put
from repro_torch.train.tree import as_tree, leaves_with_paths, tree_map, tree_map_with_path

SEP = "/"


def _key(path: tuple) -> str:
    return SEP.join(f"#{p}" if isinstance(p, int) else str(p) for p in path)


def _host(leaf) -> np.ndarray:
    """A copy of ``leaf`` on the host, as numpy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def flatten(tree) -> dict[str, np.ndarray]:
    """The tree as a checkpoint stores it: ``/``-joined keys, host copies."""
    return _snapshot(tree)[0]


def _snapshot(tree) -> tuple[dict[str, np.ndarray], str]:
    """(``flatten(tree)``, the port's description of the tree: its nesting
    with a null at each leaf)."""
    tree = as_tree(tree)
    flat = {_key(path): _host(leaf) for path, leaf in leaves_with_paths(tree)}
    return flat, "repro_torch " + json.dumps(tree_map(lambda _: None, tree), sort_keys=True)


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def _write(ckpt_dir: str, step: int, flat: dict[str, np.ndarray], treedef: str) -> str:
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = os.path.join(tmp, "arrays.npz")
    np.savez(arrays, **flat)
    with open(arrays, "rb") as f:
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "treedef": treedef,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
    }
    _fsync_write(os.path.join(tmp, "manifest.json"), json.dumps(manifest))
    if os.path.exists(final):
        os.rename(final, final + ".old")
    os.rename(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    _fsync_write(latest_tmp, str(step))
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    return final


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous crash-safe save. Returns the committed directory."""
    return _write(ckpt_dir, step, *_snapshot(tree))


class AsyncCheckpointer:
    """One-in-flight async saver: a copying snapshot to the host, then the
    write on a thread."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None
        self.last_committed: int | None = None

    def save(self, step: int, tree: Any):
        self.wait()
        flat, treedef = _snapshot(tree)  # a point-in-time copy

        def work():
            _write(self.ckpt_dir, step, flat, treedef)
            self.last_committed = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> int | None:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            return int(f.read().strip())
    except FileNotFoundError:
        return None


def _placed(arr: np.ndarray, like, dev) -> torch.Tensor:
    """``arr`` as a tensor on ``dev``, else on ``like``'s device (the CPU
    for a ``meta`` or non-tensor ``like``)."""
    if dev is None:
        on = like.device if isinstance(like, torch.Tensor) else None
        dev = on if on is not None and on.type != "meta" else torch.device("cpu")
    return torch.from_numpy(arr).to(dev)


def restore(ckpt_dir: str, step: int, like: Any, shardings: Any | None = None) -> Any:
    """Restore into the structure of ``like``: tensors (``meta`` ones
    give only a shape), numpy arrays, or an ``LMParams`` (restored into a
    copy of it). ``shardings``, the port's counterpart of the reference's:
    one device or one ``NamedSharding`` for every array, or a tree of
    them matching ``like``. A ``NamedSharding`` places its array over its
    mesh by ``device_put`` (a ``Sharded``). An ``LMParams`` restored
    under one device stays an ``LMParams``; under a tree (its spec tree's
    layout, ``tree()``'s) it comes back as that tree of placed arrays.
    Without ``shardings`` each array goes to its ``like`` leaf's device."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}

    def array(key_path: tuple, shape) -> np.ndarray:
        key = _key(key_path)
        arr = flat[key]
        assert arr.shape == tuple(shape), f"{key}: {arr.shape} != {tuple(shape)}"
        return arr

    def build(node, place, prefix: tuple):
        whole = _is_place(place) or isinstance(place, NamedSharding)
        if isinstance(node, LMParams) and not _is_place(place):
            node = node.tree(leaf=lambda p: p.to("meta"))
        if isinstance(node, LMParams):
            dev = None if place is None else torch.device(place)
            out = copy.deepcopy(node) if dev is None else copy.deepcopy(node).to(dev)
            ref = out.tree()
            arrays = tree_map_with_path(lambda p, leaf: array(prefix + p, leaf.shape), ref)
            return out.assign(tree_map(torch.from_numpy, arrays))
        if isinstance(node, (dict, list, tuple)):
            keys = node.keys() if isinstance(node, dict) else range(len(node))
            built = {
                k: build(node[k], place if whole else place[k], prefix + (k,))
                for k in keys
            }
            return built if isinstance(node, dict) else type(node)(built[i] for i in keys)
        shape = node.shape if hasattr(node, "shape") else np.shape(node)
        if isinstance(place, NamedSharding):
            return device_put(torch.from_numpy(array(prefix, shape)), place)
        dev = None if place is None else torch.device(place)
        return _placed(array(prefix, shape), node, dev)

    return build(like, shardings, ())


def _is_place(x) -> bool:
    return x is None or isinstance(x, (str, torch.device))
