"""Sharded numpy checkpointing with a manifest: the layout of
``repro.checkpoint.checkpoint``, so either package reads what the other
wrote.

Layout (one directory per step, atomically renamed into place)::

    ckpt_dir/step_000000123/
      manifest.json        step, meta, and per leaf its shape, dtype and
                           shard count
      <leaf-name>.s0.npy   shard files (chunks along axis 0)
      ...

- *atomicity*: a save writes to ``.tmp-step_...`` and then ``os.replace``s
  it into place, so a crash mid-save never damages the latest step;
- *sharded files*: each leaf splits into ``num_shards`` axis-0 chunks;
- *retention*: the newest ``keep`` steps survive.

A tree is nested dicts, lists and tuples of arrays (numpy arrays, tensors
on any device, or scalars).  Leaf names are the reference's: the path's
keys joined by ``_`` (dict keys sorted, sequence positions as numbers),
so ``{"a": {"w": x}, "b": [y, z]}`` gives ``a_w``, ``b_0`` and ``b_1``.
Arrays come back as host numpy; placing them on a device is the caller's.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _host(leaf: Any) -> np.ndarray:
    detach = getattr(leaf, "detach", None)   # a torch tensor on any device
    if detach is not None:
        return detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order and naming."""
    if isinstance(tree, dict):
        items = [(str(key), tree[key]) for key in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [("_".join(k.strip("'[]") for k in prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out += _leaf_paths(sub, prefix + (key,))
    return out


def _rebuild(template: Any, leaves: List[np.ndarray]) -> Any:
    """``template``'s structure with its leaves taken from ``leaves`` in
    :func:`_leaf_paths` order (consumed from the front)."""
    if isinstance(template, dict):
        built = {key: _rebuild(template[key], leaves)
                 for key in sorted(template)}
        return {key: built[key] for key in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, leaves) for x in template)
    return leaves.pop(0)


def save(
    ckpt_dir: str,
    step: int,
    tree: Any,
    meta: Optional[Dict] = None,
    num_shards: int = 2,
    keep: int = 3,
) -> str:
    """Write ``tree`` as step ``step``; returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {
        "step": step,
        "meta": meta or {},
        "leaves": {},
        "treedef": None,
    }
    for name, leaf in _leaf_paths(tree):
        arr = _host(leaf)
        shards = max(1, min(num_shards, arr.shape[0] if arr.ndim else 1))
        chunks = np.array_split(arr, shards, axis=0) if arr.ndim else [arr]
        for i, c in enumerate(chunks):
            np.save(os.path.join(tmp, f"{name}.s{i}.npy"), c)
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "shards": len(chunks),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def all_steps(ckpt_dir: str) -> List[int]:
    """Completed step numbers, ascending (``.tmp-`` directories left out):
    a caller can fall back to an older step when the newest fails its
    checks."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_")
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any,
            step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (shapes must match), as
    host numpy arrays; the newest step unless ``step`` is given."""
    step = latest_step(ckpt_dir) if step is None else step
    assert step is not None, f"no checkpoint in {ckpt_dir}"
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    out = []
    for name, leaf in _leaf_paths(template):
        info = manifest["leaves"][name]
        chunks = [
            np.load(os.path.join(d, f"{name}.s{i}.npy"))
            for i in range(info["shards"])
        ]
        arr = np.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]
        assert list(arr.shape) == list(_host(leaf).shape), (
            name, arr.shape, _host(leaf).shape)
        out.append(arr.astype(info["dtype"]))
    return step, _rebuild(template, out)


def _gc(ckpt_dir: str, keep: int) -> None:
    dirs = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in dirs[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
