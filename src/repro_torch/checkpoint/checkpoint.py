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

A tree is nested dicts, lists, tuples and NamedTuples of arrays
(numpy arrays, tensors on any device, or scalars).  Leaf names are the
reference's: the path's keys joined by ``_`` (dict keys sorted, sequence
positions as numbers, a ``NamedTuple``'s fields by name), so ``{"a": {"w":
x}, "b": [y, z]}`` gives ``a_w``, ``b_0`` and ``b_1``, and a training
state ``(params, OptState(step, m, v))`` gives ``0_w``, ``1_step``,
``1_m_w`` and ``1_v_w``.

A bfloat16 leaf is written as the reference writes one (through
``ml_dtypes``): manifest dtype ``"bfloat16"``, an ``.npy`` of 2-byte void
items (descr ``<V2``) holding the raw bits, so either package's files are
byte for byte the other's.  numpy has no bfloat16 of its own, so such a
leaf comes back from :func:`restore` as a CPU ``torch.bfloat16`` tensor;
every other leaf as host numpy.  :func:`restore_resharded` gives tensors
on the devices a caller names.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


BF16 = "bfloat16"
_BF16_DESCR = "<V2"   # what numpy writes for ml_dtypes' bfloat16


def _torch():
    import torch
    return torch


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a leaf; a bfloat16 leaf's array
    holds its raw bits as uint16."""
    detach = getattr(leaf, "detach", None)   # a torch tensor on any device
    if detach is not None:
        t = detach().cpu()
        if t.dtype == _torch().bfloat16:
            return t.view(_torch().int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == BF16:               # an ml_dtypes array
        return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


def _shape(leaf: Any) -> List[int]:
    return list(getattr(leaf, "shape", np.shape(leaf)))


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _save_bf16(path: str, bits: np.ndarray) -> None:
    """``bits`` (uint16) as the ``.npy`` that ``np.save`` writes for an
    ml_dtypes bfloat16 array of that shape."""
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": bits.shape})
        f.write(np.ascontiguousarray(bits).tobytes())


def _load_bf16(arr: np.ndarray):
    """The CPU bfloat16 tensor of a loaded ``<V2`` (or uint16) array."""
    torch = _torch()
    bits = np.array(arr).view(np.int16)   # a copy, 0-d kept 0-d
    return torch.from_numpy(bits).view(torch.bfloat16)


def _leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order and naming."""
    if isinstance(tree, dict):
        items = [(str(key), tree[key]) for key in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f, getattr(tree, f)) for f in type(tree)._fields]
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
    if _is_namedtuple(template):
        return type(template)(*[_rebuild(x, leaves) for x in template])
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
        arr, dtype = _host(leaf)
        shards = max(1, min(num_shards, arr.shape[0] if arr.ndim else 1))
        chunks = np.array_split(arr, shards, axis=0) if arr.ndim else [arr]
        for i, c in enumerate(chunks):
            path = os.path.join(tmp, f"{name}.s{i}.npy")
            if dtype == BF16:
                _save_bf16(path, c)
            else:
                np.save(path, c)
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": dtype,
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
    host numpy arrays (bfloat16 leaves as CPU bfloat16 tensors); the newest
    step unless ``step`` is given."""
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
        assert list(arr.shape) == _shape(leaf), (name, arr.shape,
                                                 _shape(leaf))
        out.append(_load_bf16(arr) if info["dtype"] == BF16
                   else arr.astype(info["dtype"]))
    return step, _rebuild(template, out)


def restore_resharded(ckpt_dir: str, template: Any, devices: Any,
                      step: Optional[int] = None) -> Tuple[int, Any]:
    """Elastic restore: :func:`restore`, then each array placed as a
    tensor on the device that the matching leaf of ``devices`` names (a
    tree of ``template``'s structure whose leaves are ``torch.device``s or
    device strings), as the reference places each under a new sharding."""
    import torch

    step, tree = restore(ckpt_dir, template, step)
    placed = [torch.as_tensor(np.ascontiguousarray(arr)
                              if isinstance(arr, np.ndarray) else arr).to(dev)
              for (_, arr), (_, dev) in zip(_leaf_paths(tree),
                                            _leaf_paths(devices))]
    return step, _rebuild(template, placed)


def _gc(ckpt_dir: str, keep: int) -> None:
    dirs = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in dirs[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
