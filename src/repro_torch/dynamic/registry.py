"""Persistent plan registry: serve warm without running ``prepare`` again.

The port of ``repro.dynamic.registry`` for single-device plans, on the
same disk layout, so that an entry written by either package loads in the
other.  Plans and their dynamic state go through ``checkpoint``'s atomic
manifest + ``.npy`` layout (a temporary directory ``os.replace``d into
place, so a crash mid-save never damages the latest entry)::

    root/<name>/step_000000NN/
      manifest.json                 leaf shapes, dtypes, shard counts and
                                    the plan's metadata
      leaf_flat_values.s0.npy ...   plan leaves (host copies)
      maps_vals.s0.npy ...          COO->slot update maps
      delta_keys.s0.npy ...         the structural overlay

An entry is checked on load against the registry format version, the plan
format version (``PLAN_FORMAT_VERSION``, 2 in both packages) and the
signature of the restored plan.  Any mismatch, truncated shard or bad
manifest raises :class:`RegistryError`, which ``load_or_prepare`` answers
with a fresh ``prepare``; a damaged newest generation falls back to the
one before it.

Across packages: the manifest stores ``dataclasses.asdict(config)``, whose
``impl`` is the writer's.  ``load(name, impl=...)`` puts the plan on the
impl the caller gives (by default the stored one, when it is one of the
port's), as ``interop.plan_from_arrays`` does, and checks the restored
signature with the stored impl in its place.  The reference's
``degrade_to_xla`` is an execution-only field (it is left out of the
fingerprint too) that the port's config does not have (no degrade tier):
it is dropped on load.  A tuple ``structure_hint``, which JSON stores as
a list, is made a tuple again (the reference's loader keeps the list,
and its next ``prepare`` then ignores the hint: ROADMAP C10).

Sharded entries (``kind: "sharded"``) store the base COO, the config,
the shard axis and the overlay: a mesh cannot outlive its process, so
``load`` re-shards through ``prepare_sharded`` onto the caller's mesh (or
a new one of the stored shard count: repeated CPUs for ``"torch"``, the
visible cards for ``"cuda"``, never fewer shards), and the warm start
keeps the state (value updates and the overlay), not the plan build.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import checkpoint
from ..core import spmm
from ..core.plan_ir import (
    IMPL_DEVICE, LEAF_NAMES, PLAN_FORMAT_VERSION, SIG_IMPL, SpmmConfig,
    UpdateMaps, plan_from_leaves,
)
# RegistryError lives in the shared taxonomy and is re-exported here for
# the reference's import path
from ..errors import PlanBuildError, RegistryError  # noqa: F401
from ..robust.faults import HARNESS
from .delta import DynamicPlan

REGISTRY_FORMAT_VERSION = 1

_MAPS_NAMES = (
    "rows", "cols", "vals", "path", "core_lin", "fringe_pos", "kb_pos",
    "core_lin_sorted", "core_members_sorted", "key_sorted", "key_order",
)

# SpmmConfig fields that only tune execution (cache sizing, the
# reference's degrade policy), not the plan's structure: left out of the
# fingerprint, and dropped on load where the port's config lacks them
_EXECUTION_ONLY_CONFIG_FIELDS = ("executor_cache_capacity", "degrade_to_xla")


def coo_fingerprint(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    shape: Tuple[int, int], config: SpmmConfig,
) -> str:
    """Content hash binding a registry entry to its source matrix and
    config, as the reference computes it: indices as int64 and values as
    float64, so the hash of a plan's evolved ``to_coo()`` matches a caller
    registering the same matrix from narrower arrays; execution-only
    config fields are left out."""
    h = hashlib.sha256()
    for a, dtype in ((rows, np.int64), (cols, np.int64),
                     (vals, np.float64)):
        arr = np.ascontiguousarray(np.asarray(a, dtype))
        h.update(arr.tobytes())
    h.update(repr(tuple(shape)).encode())
    cfg = dataclasses.asdict(config)
    for field in _EXECUTION_ONLY_CONFIG_FIELDS:
        cfg.pop(field, None)
    h.update(repr(sorted(cfg.items())).encode())
    return h.hexdigest()


def _safe_name(name: str) -> str:
    if not re.fullmatch(r"[A-Za-z0-9._-]+", name):
        raise RegistryError(
            f"registry names must be filesystem-safe "
            f"([A-Za-z0-9._-]+), got {name!r}")
    return name


def _port_config(cfg: Dict[str, Any], impl: str) -> Dict[str, Any]:
    """The stored config's fields for the port's ``SpmmConfig`` on
    ``impl``: the impl mapped, execution-only fields the port lacks
    dropped, and a ``structure_hint`` that JSON turned into a list made a
    tuple again (as a list the hint would be ignored by the next
    ``prepare``, and the config could not be hashed)."""
    known = {f.name for f in dataclasses.fields(SpmmConfig)}
    out = {key: value for key, value in cfg.items()
           if key in known or key not in _EXECUTION_ONLY_CONFIG_FIELDS}
    out["impl"] = impl
    if isinstance(out.get("structure_hint"), list):
        out["structure_hint"] = tuple(out["structure_hint"])
    return out


class PlanRegistry:
    """On-disk registry of prepared plans keyed by matrix name."""

    def __init__(self, root: str, keep: int = 2):
        self.root = root
        self.keep = keep
        # times load() served an older generation because the newest one
        # failed its checks
        self.generation_fallbacks = 0
        os.makedirs(root, exist_ok=True)

    def names(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d)))

    def has(self, name: str) -> bool:
        d = os.path.join(self.root, _safe_name(name))
        return os.path.isdir(d) and checkpoint.latest_step(d) is not None

    # -- save ---------------------------------------------------------------
    def save(self, name: str, dplan: DynamicPlan) -> str:
        """Persist a dynamic plan: its leaves (host copies), update maps
        and overlay, so that ``load`` runs no ``prepare``.  A sharded plan
        stores its base COO, config and shard axis instead (the
        reference's layout): ``load`` re-shards it."""
        _safe_name(name)
        if dplan.is_sharded:
            return self._save_sharded(name, dplan)
        plan = dplan.plan
        maps = plan.update_maps
        tree: Dict[str, np.ndarray] = {}
        for lname, leaf in plan.leaves().items():
            tree[f"leaf_{lname}"] = leaf.detach().cpu().numpy()
        for mname in _MAPS_NAMES:
            tree[f"maps_{mname}"] = (
                maps.host_values() if mname == "vals"
                else np.asarray(getattr(maps, mname)))
        tree.update(self._overlay_tree(dplan))

        rows, cols, vals = dplan.to_coo()
        meta = {
            "registry_format_version": REGISTRY_FORMAT_VERSION,
            "plan_format_version": PLAN_FORMAT_VERSION,
            "kind": "plan",
            "name": name,
            "shape": list(plan.shape),
            "config": dataclasses.asdict(plan.config),
            "stats": [list(kv) for kv in plan.stats],
            "fringe_tier": plan.fringe_tier,
            "fringe_bk": plan.fringe_bk,
            "matrix_format": plan.matrix_format,
            "format_params": list(plan.format_params),
            "signature": repr(plan.signature()),
            "coo_hash": coo_fingerprint(rows, cols, vals, plan.shape,
                                        plan.config),
            "compactions": dplan.compactions,
        }
        return self._write_entry(name, tree, meta)

    @staticmethod
    def _overlay_tree(dplan: DynamicPlan) -> Dict[str, np.ndarray]:
        overlay = dplan._overlay
        keys = np.fromiter(overlay, np.int64, count=len(overlay))
        has_target = np.array(
            [overlay[int(key)] is not None for key in keys], bool)
        targets = np.array(
            [overlay[int(key)] if overlay[int(key)] is not None else 0.0
             for key in keys], np.float64)
        return {"delta_keys": keys, "delta_has_target": has_target,
                "delta_targets": targets}

    def _save_sharded(self, name: str, dplan: DynamicPlan) -> str:
        splan = dplan.plan
        maps = splan.update_maps
        # base COO (current values: the fast path advances maps.vals) and
        # the structural overlay; load re-shards and restores the overlay
        tree: Dict[str, np.ndarray] = {
            "coo_rows": np.asarray(maps.rows, np.int64),
            "coo_cols": np.asarray(maps.cols, np.int64),
            "coo_vals": np.asarray(maps.vals),
        }
        tree.update(self._overlay_tree(dplan))
        rows, cols, vals = dplan.to_coo()
        meta = {
            "registry_format_version": REGISTRY_FORMAT_VERSION,
            "plan_format_version": PLAN_FORMAT_VERSION,
            "kind": "sharded",
            "name": name,
            "shape": list(splan.shape),
            "config": dataclasses.asdict(splan.config),
            "shard_axis": splan.shard_axis,
            "axis_name": splan.axis_name,
            "n_shards": splan.n_shards,
            "coo_hash": coo_fingerprint(rows, cols, vals, splan.shape,
                                        splan.config),
            "compactions": dplan.compactions,
        }
        return self._write_entry(name, tree, meta)

    def _write_entry(self, name: str, tree: Dict, meta: Dict) -> str:
        d = os.path.join(self.root, _safe_name(name))
        step = (checkpoint.latest_step(d) or 0) + 1
        try:
            HARNESS.fire("registry_write", context=name)
            return checkpoint.save(d, step, tree, meta=meta, num_shards=1,
                                   keep=self.keep)
        except RegistryError:
            raise
        except Exception as e:
            # a crash mid-save (injected or real) is a clean RegistryError;
            # the atomic layout keeps the previous generation the latest
            raise RegistryError(
                f"failed to persist registry entry for {name!r}: {e}") from e

    # -- load ---------------------------------------------------------------
    def _read_entry(self, name: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
        """Read the newest valid generation of ``name``, newest first: a
        generation that fails its checks gives way to the one before it,
        with a warning and a count in ``generation_fallbacks``.  Only when
        every generation fails does the aggregate RegistryError raise."""
        d = os.path.join(self.root, _safe_name(name))
        steps = checkpoint.all_steps(d)
        if not steps:
            raise RegistryError(f"no registry entry for {name!r}")
        failures: List[str] = []
        for gen_idx, step in enumerate(reversed(steps)):
            try:
                meta, arrays = self._read_step(name, d, step)
            except RegistryError as e:
                failures.append(f"step_{step:09d}: {e}")
                continue
            if gen_idx:
                self.generation_fallbacks += 1
                warnings.warn(
                    f"registry entry {name!r}: newest generation failed "
                    f"validation; serving step_{step:09d} instead "
                    f"({'; '.join(failures)})",
                    RuntimeWarning, stacklevel=3)
            return meta, arrays
        raise RegistryError(
            f"every retained generation of {name!r} failed validation: "
            + "; ".join(failures))

    def _read_step(self, name: str, d: str,
                   step: int) -> Tuple[Dict, Dict[str, np.ndarray]]:
        entry = os.path.join(d, f"step_{step:09d}")
        try:
            HARNESS.fire("registry_read", context=name)
            with open(os.path.join(entry, "manifest.json")) as f:
                manifest = json.load(f)
        except RegistryError:
            raise
        except (OSError, json.JSONDecodeError) as e:
            raise RegistryError(
                f"unreadable manifest for {name!r}: {e}") from e
        except Exception as e:  # injected faults count as read corruption
            raise RegistryError(
                f"failed reading registry entry for {name!r}: {e}") from e
        meta = manifest.get("meta", {})
        if meta.get("registry_format_version") != REGISTRY_FORMAT_VERSION:
            raise RegistryError(
                f"{name!r} was saved under registry format "
                f"{meta.get('registry_format_version')}, this build reads "
                f"{REGISTRY_FORMAT_VERSION}")
        if meta.get("plan_format_version") != PLAN_FORMAT_VERSION:
            raise RegistryError(
                f"{name!r} was saved under plan format "
                f"{meta.get('plan_format_version')}, this build is "
                f"{PLAN_FORMAT_VERSION}")
        arrays: Dict[str, np.ndarray] = {}
        try:
            for lname, info in manifest["leaves"].items():
                chunks = [
                    np.load(os.path.join(entry, f"{lname}.s{i}.npy"),
                            allow_pickle=False)
                    for i in range(info["shards"])
                ]
                arr = (np.concatenate(chunks, axis=0) if len(chunks) > 1
                       else chunks[0])
                if list(arr.shape) != list(info["shape"]) or (
                        str(arr.dtype) != info["dtype"]):
                    raise RegistryError(
                        f"shard data for {name!r}/{lname} does not match "
                        f"its manifest (got {arr.shape}/{arr.dtype}, "
                        f"manifest says {info['shape']}/{info['dtype']})")
                arrays[lname] = arr
        except RegistryError:
            raise
        except (OSError, ValueError, KeyError, EOFError) as e:
            raise RegistryError(
                f"corrupt or truncated registry entry for {name!r}: {e}"
            ) from e
        return meta, arrays

    def load(self, name: str, *, impl: Optional[str] = None,
             device: Any = None, mesh: Any = None,
             **dynamic_kwargs) -> DynamicPlan:
        """Restore an entry as a :class:`DynamicPlan`.

        A single-device entry needs no ``prepare``.  ``impl`` ("cuda" or
        "torch") is the impl to run the plan on; by default the stored
        one, which must then be one of the port's (an entry written by the
        JAX package says "xla" or "pallas").  ``device`` defaults to the
        one ``impl`` runs on.  A sharded entry re-shards onto ``mesh`` (see
        the module docstring).
        """
        meta, arrays = self._read_entry(name)
        stored_impl = meta.get("config", {}).get("impl")
        impl = impl or stored_impl
        if impl not in IMPL_DEVICE:
            raise RegistryError(
                f"{name!r} was written for impl {stored_impl!r}; pass "
                f"impl= one of {sorted(IMPL_DEVICE)} to load it here")
        if meta.get("kind", "plan") == "sharded":
            return self._load_sharded(name, meta, arrays, mesh, impl,
                                      **dynamic_kwargs)
        try:
            shape = tuple(int(s) for s in meta["shape"])
            maps = UpdateMaps(
                shape=shape, **{n: arrays[f"maps_{n}"] for n in _MAPS_NAMES
                                if n != "vals"},
                vals=torch.from_numpy(np.array(arrays["maps_vals"])))
            plan = plan_from_leaves(
                {n: arrays[f"leaf_{n}"] for n in LEAF_NAMES},
                {"shape": shape,
                 "config": _port_config(meta["config"], impl),
                 "stats": tuple(tuple(kv) for kv in meta["stats"]),
                 "fringe_tier": meta["fringe_tier"],
                 "fringe_bk": int(meta["fringe_bk"]),
                 "matrix_format": meta.get("matrix_format", "general"),
                 "format_params": tuple(meta.get("format_params", (0, 0))),
                 "update_maps": maps},
                device if device is not None else IMPL_DEVICE[impl])
        except RegistryError:
            raise
        except (KeyError, TypeError, ValueError, PlanBuildError) as e:
            raise RegistryError(
                f"registry entry for {name!r} does not reconstruct a "
                f"plan: {e}") from e
        sig = list(plan.signature())
        sig[SIG_IMPL] = stored_impl
        if repr(tuple(sig)) != meta.get("signature"):
            raise RegistryError(
                f"restored plan signature for {name!r} disagrees with the "
                "manifest; refusing to serve a structurally inconsistent "
                "plan")
        dplan = DynamicPlan(plan, **dynamic_kwargs)
        self._restore_overlay(dplan, meta, arrays)
        return dplan

    def _load_sharded(self, name: str, meta: Dict, arrays: Dict, mesh,
                      impl: str, **dynamic_kwargs) -> DynamicPlan:
        try:
            cfg = SpmmConfig(**_port_config(meta["config"], impl))
            shape = tuple(int(s) for s in meta["shape"])
            shard_axis = meta["shard_axis"]
            axis_name = meta["axis_name"]
            n_shards = int(meta["n_shards"])
            rows = arrays["coo_rows"]
            cols = arrays["coo_cols"]
            vals = arrays["coo_vals"]
        except (KeyError, TypeError, ValueError) as e:
            raise RegistryError(
                f"sharded registry entry for {name!r} does not reconstruct "
                f"a plan: {e}") from e
        if mesh is None:
            from ..distributed import make_spmm_mesh

            try:
                mesh = (make_spmm_mesh(devices=["cpu"] * n_shards,
                                       axis_name=axis_name)
                        if IMPL_DEVICE[impl] == "cpu"
                        else make_spmm_mesh(n_shards, axis_name))
            except ValueError as e:
                raise RegistryError(
                    f"sharded entry {name!r} wants {n_shards} shards and no "
                    f"mesh was provided: {e}") from e
        splan = spmm.prepare_sharded(
            rows, cols, vals, shape, mesh, cfg, shard_axis=shard_axis,
            axis_name=axis_name)
        dplan = DynamicPlan(splan, **dynamic_kwargs)
        self._restore_overlay(dplan, meta, arrays)
        return dplan

    @staticmethod
    def _restore_overlay(dplan: DynamicPlan, meta: Dict,
                         arrays: Dict) -> None:
        keys = arrays["delta_keys"]
        has_target = arrays["delta_has_target"]
        targets = arrays["delta_targets"]
        dplan._overlay = {
            int(key): (float(targets[i]) if has_target[i] else None)
            for i, key in enumerate(keys)
        }
        dplan.compactions = int(meta.get("compactions", 0))

    def stored_coo_hash(self, name: str) -> str:
        meta, _ = self._read_entry(name)
        return meta["coo_hash"]

    def load_or_prepare(
        self,
        name: str,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: Tuple[int, int],
        config: SpmmConfig = SpmmConfig(),
        *,
        device: Any = None,
        **dynamic_kwargs,
    ) -> DynamicPlan:
        """Warm-start from disk when the stored entry matches this matrix
        and config; otherwise prepare fresh (on ``device``) and persist.  A
        damaged entry costs a ``prepare``, never a wrong answer."""
        fp = coo_fingerprint(rows, cols, vals, shape, config)
        if self.has(name):
            try:
                meta, _ = self._read_entry(name)
                if meta.get("coo_hash") == fp:
                    return self.load(name, impl=config.impl, device=device,
                                     **dynamic_kwargs)
            except RegistryError:
                pass  # fall through to a fresh prepare
        dplan = DynamicPlan(
            spmm.prepare(rows, cols, vals, shape, config, device=device),
            **dynamic_kwargs)
        self.save(name, dplan)
        return dplan

    def load_or_prepare_sharded(
        self,
        name: str,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: Tuple[int, int],
        mesh,
        config: SpmmConfig = SpmmConfig(),
        shard_axis: str = "auto",
        axis_name: Optional[str] = None,
        **dynamic_kwargs,
    ) -> DynamicPlan:
        """Sharded counterpart of :meth:`load_or_prepare`: a matching entry
        (same COO fingerprint, same shard count) restores its state
        re-sharded onto ``mesh``; anything else prepares fresh and
        persists.  A damaged entry costs a ``prepare_sharded``."""
        fp = coo_fingerprint(rows, cols, vals, shape, config)
        n_shards = int(mesh.shape[axis_name or mesh.axis_names[0]])
        if self.has(name):
            try:
                meta, _ = self._read_entry(name)
                if (meta.get("kind") == "sharded"
                        and meta.get("coo_hash") == fp
                        and int(meta.get("n_shards", -1)) == n_shards):
                    return self.load(name, impl=config.impl, mesh=mesh,
                                     **dynamic_kwargs)
            except RegistryError:
                pass  # fall through to a fresh prepare
        dplan = DynamicPlan(
            spmm.prepare_sharded(rows, cols, vals, shape, mesh, config,
                                 shard_axis=shard_axis, axis_name=axis_name),
            **dynamic_kwargs)
        self.save(name, dplan)
        return dplan
