"""Registry-backed persistence for the autotuner's table
(``core.tuner``): the port of ``repro.dynamic.tuning``.

The tuner lives in ``core`` and must not import upward, so persistence is
dependency-inverted: this module (the dynamic layer, where
``PlanRegistry`` lives) implements the store protocol, ``save(table)`` /
``load()``, and hands an instance *down* through
``core.tuner.install_store``.

Tables ride ``PlanRegistry``'s generational atomic layout as
``kind="tuning"`` entries named by device fingerprint, on the reference's
disk layout: the JSON-encoded table is one uint8 array leaf, written
through the same temporary directory + ``os.replace`` path as plans (the
``registry_write`` seam included) and read through the same newest to
oldest generation fallback (``registry_read``).  Entries are versioned by
``PLAN_FORMAT_VERSION`` (checked by the registry) and by the tuner's
``TABLE_FORMAT_VERSION`` (checked per record on load).

Across packages: a record's key ends in its impl (``core.tuner.
shape_class``).  A table written by the reference holds ``"xla"`` or
Pallas records, which no impl of the port reads.  A store built with
``impl=`` (``"torch"`` or ``"cuda"``) reads them as records of that impl,
as ``PlanRegistry.load(impl=)`` reads a reference's plan entry: the key's
last field (and the record's ``key``) becomes ``impl``, and the device
field becomes the fingerprint of the device ``impl`` runs on, which must
be the table's device.  Without ``impl=`` such records are left out.

A corrupt or missing table is never an error on the load path: ``load``
returns ``None`` (missing) or raises ``RegistryError`` (corrupt), and the
tuner maps both to the analytic model with a counter.
"""
from __future__ import annotations

import json
import re
from typing import Optional, Union

import numpy as np

from ..core import tuner as core_tuner
from ..core.plan_ir import IMPL_DEVICE, PLAN_FORMAT_VERSION
from ..errors import RegistryError
from .registry import REGISTRY_FORMAT_VERSION, PlanRegistry

# tuning entries share the plan namespace; the prefix keeps them listable
# and apart from matrix names
ENTRY_PREFIX = "tuning-"


def _entry_name(device: Optional[str] = None) -> str:
    device = device or core_tuner.device_fingerprint()
    return ENTRY_PREFIX + re.sub(r"[^A-Za-z0-9._-]", "_", device)


class RegistryTuningStore:
    """``core.tuner``'s store protocol over a :class:`PlanRegistry`.

    ``impl`` ("torch" or "cuda") reads the records of a table that the
    reference wrote as records of that impl (see the module docstring).
    """

    def __init__(self, registry: PlanRegistry, impl: Optional[str] = None):
        if impl is not None and impl not in IMPL_DEVICE:
            raise ValueError(
                f"impl must be one of {sorted(IMPL_DEVICE)}, got {impl!r}")
        self.registry = registry
        self.impl = impl

    def save(self, table: dict) -> None:
        device = core_tuner.device_fingerprint()
        payload = json.dumps({"device": device, "table": table},
                             sort_keys=True).encode("utf-8")
        tree = {
            "tuning_json": np.frombuffer(payload, dtype=np.uint8).copy()
        }
        meta = {
            "registry_format_version": REGISTRY_FORMAT_VERSION,
            "plan_format_version": PLAN_FORMAT_VERSION,
            "kind": "tuning",
            "name": _entry_name(device),
            "device_fingerprint": device,
            "table_format_version": core_tuner.TABLE_FORMAT_VERSION,
            "n_records": len(table),
        }
        self.registry._write_entry(_entry_name(device), tree, meta)

    def load(self) -> Optional[dict]:
        """The persisted table for this device, or None if never saved.

        Raises :class:`RegistryError` when every retained generation is
        corrupt; the tuner catches it, counts it, and serves the analytic
        model.
        """
        name = _entry_name()
        if not self.registry.has(name):
            return None
        meta, arrays = self.registry._read_entry(name)
        if meta.get("kind") != "tuning":
            raise RegistryError(
                f"registry entry {name!r} is kind={meta.get('kind')!r}, "
                "expected 'tuning'")
        device = core_tuner.device_fingerprint()
        if meta.get("device_fingerprint") != device:
            # a table measured on other hardware is absent, not a fallback
            return None
        try:
            payload = json.loads(
                arrays["tuning_json"].tobytes().decode("utf-8"))
        except (KeyError, UnicodeDecodeError, json.JSONDecodeError) as e:
            raise RegistryError(
                f"corrupt tuning table payload in {name!r}: {e}") from e
        if payload.get("device") != device:
            raise RegistryError(
                f"tuning table {name!r} payload/meta device mismatch")
        table = payload.get("table")
        if not isinstance(table, dict):
            return None
        return {key: rec for key, rec in map(self._port_record,
                                             table.items()) if key}

    def _port_record(self, item):
        """``(key, record)`` as the port reads it: its own records as they
        are; another package's record as one of ``self.impl``, or
        ``(None, None)`` without one."""
        key, rec = item
        head, _, impl = str(key).rpartition("|")
        if impl in IMPL_DEVICE:
            return key, rec
        if self.impl is None or not head:
            return None, None
        device, _, shape = head.partition("|")
        mine = core_tuner.device_fingerprint(IMPL_DEVICE[self.impl])
        if device != mine:
            return None, None
        key = f"{mine}|{shape}|{self.impl}"
        if isinstance(rec, dict):
            rec = dict(rec, key=key, device=mine)
        return key, rec


def install_registry_store(
    registry: Union[PlanRegistry, str], impl: Optional[str] = None,
) -> RegistryTuningStore:
    """Build a registry-backed tuning store and install it into the tuner.

    Accepts a :class:`PlanRegistry` or a root path.  This is the
    sanctioned caller of ``core.tuner.install_store``
    (``tools/check_layers_torch.py`` checks it): the seam points downward.
    """
    if not isinstance(registry, PlanRegistry):
        registry = PlanRegistry(str(registry))
    store = RegistryTuningStore(registry, impl=impl)
    core_tuner.install_store(store)
    return store
