"""Atomic checkpoints in the reference's layout.

Counterpart of ``repro/training/checkpoint.py``.  Layout:
``<dir>/step_<n>/{manifest.json, <flat-key>.npy...}``, keys the tree's
paths joined with ``/`` (``/`` written as ``__`` in file names), so either
package reads the other's trees.
  * atomic commit: written to ``step_<n>.tmp``, then renamed;
  * the manifest records the step, the keys, the device count and the
    package that wrote it (``"package": "repro_torch"``), so a reader can
    refuse a checkpoint written by another package (the stream-model
    cache does: the reference stores conv kernels HWIO, the port OIHW);
  * restore puts every tensor on the manager's device and, where given a
    sharding (``common/sharding.py``'s ``NamedSharding``, by the same
    keys), lays it out on that mesh (``sharding.place``: the identity on
    a world of one; a mesh of more ranks than the world is refused);
  * retention: keeps the last ``keep`` checkpoints.
A tree is nested dicts (and lists) of tensors, numpy arrays or scalars.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.sharding import place

#: the ``package`` this package's manifests carry
PACKAGE = "repro_torch"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 device: DeviceLike = None):
        self.dir = directory
        self.keep = keep
        self.device = resolve_device(device)
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def list_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(tree)
        manifest = {"step": step, "keys": sorted(flat), "n_devices": 1,
                    "package": PACKAGE}
        for key, leaf in flat.items():
            np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"),
                    _to_numpy(leaf))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, shardings: Any = None) -> Any:
        """The tree saved at ``step``, every leaf a tensor on the
        manager's device (a 0-d array becomes a 0-d tensor).
        ``shardings``: a prefix tree of ``NamedSharding``s keyed as the
        saved tree; a matching leaf is placed on its mesh (the reference's
        elastic re-shard), the rest load whole."""
        d = self._step_dir(step)
        flat_shard = _flatten(shardings) if shardings is not None else {}
        out: Dict[str, Any] = {}
        for key in self.manifest(step)["keys"]:
            arr = np.load(os.path.join(d, key.replace("/", "__") + ".npy"))
            t = torch.from_numpy(arr).to(self.device)
            sh = flat_shard.get(key)
            out[key] = place(t, sh) if sh is not None else t
        return _unflatten(out)


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def _listify(node: Any) -> Any:
    """Dicts whose keys are 0..n-1 back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    keys = list(out.keys())
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [out[str(i)] for i in idx]
    return out


def nest(flat: Dict[str, Any], sep: str = ".") -> Dict[str, Any]:
    """{dotted name: leaf} -> nested dicts (a module's parameters as the
    reference's tree)."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(sep)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root

