"""Named-sharding rules for the LM stack: DP / FSDP / TP (+ pod axis) for
every param family.  The LM half of ``repro.distributed.sharding``, rule
for rule; the SpMM half (the sharded executor's mesh and per-shard
slicing) is :mod:`.mesh`.

The launcher installs :class:`AxisRules`, mapping logical axes onto mesh
axes; :func:`param_specs` derives a :class:`PartitionSpec` tree for any
model's params by leaf name, :func:`cache_specs` for a decode cache, and
:func:`batch_spec` for a batch.  Defaults implement Megatron-style 1-D TP
on the "model" axis with ZeRO-3/FSDP parameter sharding on the "data"
axis; the batch runs DP over ("pod", "data").

The port has no GSPMD: nothing places a tensor by these specs, and
:func:`constrain` returns its input unchanged.  It resolves the logical
names as the reference does (:func:`logical_spec`), so the rules can be
compared; the one consumer of the installed rules at run time is
``models.moe.apply_moe_shard_map``, which reads the batch, FSDP and TP
axes from them.  :class:`NamedSharding` pairs a spec with a mesh and
gives each device's block (:meth:`NamedSharding.shard_shape`), from
which the dry run (``launch.dryrun``) reckons per-device memory;
:func:`named_shardings` gives one per param leaf, as the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple


class PartitionSpec(tuple):
    """A tuple of mesh axes per tensor dimension (``None``: not sharded;
    a tuple: sharded over several axes), as ``jax.sharding.PartitionSpec``
    is; ``tuple(spec)`` compares with the reference's."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisRules:
    batch_axes: Tuple[str, ...] = ("data",)   # DP axes for the batch dim
    fsdp_axes: Tuple[str, ...] = ("data",)    # param-shard axes (ZeRO-3)
    tp_axis: Optional[str] = "model"          # tensor-parallel axis
    seq_axis: Optional[str] = None            # sequence-parallel residual
    expert_axis: Optional[str] = None         # MoE expert parallelism
    moe_fsdp: bool = True                     # False: MoE weights DP-replicated

    @property
    def batch(self):
        return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]

    @property
    def fsdp(self):
        if not self.fsdp_axes:
            return None
        return self.fsdp_axes if len(self.fsdp_axes) > 1 else self.fsdp_axes[0]


_ACTIVE: Dict[str, Any] = {"rules": None}


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = _ACTIVE["rules"]
    _ACTIVE["rules"] = rules
    try:
        yield
    finally:
        _ACTIVE["rules"] = prev


def active_rules() -> Optional[AxisRules]:
    return _ACTIVE["rules"]


def logical_spec(*logical: Optional[str]) -> Optional[PartitionSpec]:
    """The spec the installed rules give logical axes ("batch", "seq",
    "embed", "vocab", "heads", "ff", "expert"); ``None`` without rules.
    A mesh axis appears at most once: later uses resolve to ``None``."""
    rules = _ACTIVE["rules"]
    if rules is None:
        return None
    resolved = []
    for name in logical:
        if name == "batch":
            resolved.append(rules.batch)
        elif name == "seq":
            resolved.append(rules.seq_axis)
        elif name in ("heads", "ff", "vocab"):
            resolved.append(rules.tp_axis)
        elif name == "expert":
            resolved.append(rules.expert_axis)
        else:
            resolved.append(None)
    seen = set()
    deduped = []
    for r in resolved:
        axes = (r,) if isinstance(r, str) else tuple(r or ())
        if any(a in seen for a in axes):
            deduped.append(None)
            continue
        seen.update(axes)
        deduped.append(r)
    return PartitionSpec(*deduped)


def constrain(x: Any, *logical: Optional[str]) -> Any:
    """The reference's sharding constraint: ``x`` itself (the port places
    nothing by spec), after resolving ``logical`` under the installed
    rules."""
    logical_spec(*logical)
    return x


# ---------------------------------------------------------------------------
# parameter specs by leaf name
# ---------------------------------------------------------------------------
_COL_PARALLEL = {  # (.., in, out) -> (.., fsdp, tp): out-dim TP-sharded
    "wq", "wk", "wv", "w_in", "w_gate", "in_proj", "shared_w_in",
    "shared_w_gate", "adapter", "lm_head", "frontend_proj",
}
_ROW_PARALLEL = {  # (.., in, out) -> (.., tp, fsdp): in-dim TP-sharded
    "wo", "w_out", "out_proj", "shared_w_out",
}
_REPLICATED = {"router"}  # small; gathered everywhere anyway


def _axes_size(axes, sizes: Dict[str, int]) -> int:
    if axes is None:
        return 1
    axs = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axs:
        n *= sizes.get(a, 1)
    return n


def _fit(dim: int, axes, sizes: Dict[str, int], allow_uneven: bool = False):
    """Return ``axes`` if dim is shardable over them, else None."""
    if axes is None:
        return None
    n = _axes_size(axes, sizes)
    if n <= 1:
        return None
    if dim % n == 0 or (allow_uneven and dim >= n):
        return axes
    return None


def _leaf_spec(
    path: str, shape: Tuple[int, ...], rules: AxisRules, sizes: Dict[str, int]
) -> PartitionSpec:
    name = path.split("/")[-1]
    rank = len(shape)
    lead = rank - 2
    fsdp, tp = rules.fsdp, rules.tp_axis
    moe_leaf = "moe" in path.split("/") and name in ("w_in", "w_gate", "w_out")
    if name == "table":  # embedding (V, D) — vocab may shard unevenly
        return P(_fit(shape[0], tp, sizes, allow_uneven=True),
                 _fit(shape[1], fsdp, sizes))
    if name == "lm_head":  # (D, V)
        return P(_fit(shape[0], fsdp, sizes),
                 _fit(shape[1], tp, sizes, allow_uneven=True))
    if rank <= 1 or name in _REPLICATED:
        return P(*([None] * rank))
    if moe_leaf and rules.expert_axis:
        # (.., E, d1, d2): expert-parallel; inner in-dim FSDP-sharded
        spec = [None] * rank
        spec[-3] = _fit(shape[-3], rules.expert_axis, sizes)
        spec[-2] = _fit(shape[-2], fsdp, sizes) if name not in _ROW_PARALLEL else None
        return P(*spec)
    if moe_leaf and not rules.moe_fsdp:
        # shard_map dispatch: ff-sharded over TP only, DP-replicated
        spec = [None] * rank
        if name in _ROW_PARALLEL:
            spec[-2] = _fit(shape[-2], tp, sizes)
        else:
            spec[-1] = _fit(shape[-1], tp, sizes)
        return P(*spec)
    if name in _COL_PARALLEL:
        return P(*([None] * lead), _fit(shape[-2], fsdp, sizes),
                 _fit(shape[-1], tp, sizes))
    if name in _ROW_PARALLEL:
        return P(*([None] * lead), _fit(shape[-2], tp, sizes),
                 _fit(shape[-1], fsdp, sizes))
    if name == "conv_w":  # (K, C)
        return P(*([None] * lead), None, _fit(shape[-1], tp, sizes))
    return P(*([None] * rank))


def _cache_leaf_spec(
    path: str, shape: Tuple[int, ...], rules: AxisRules, sizes: Dict[str, int]
) -> PartitionSpec:
    """Decode-cache specs: shard batch over DP and heads/channels over TP."""
    name = path.split("/")[-1]
    rank = len(shape)
    if name in ("k", "v"):  # (.., B, S, KV, hd)
        # hd-sharded (not kv): hd divides the TP degree for every arch
        lead = rank - 4
        batch = _batch_axes_fit(rules, shape[lead], sizes)
        hd_tp = _fit(shape[lead + 3], rules.tp_axis, sizes)
        return P(*([None] * lead), batch, None, None, hd_tp)
    if name == "ssd":  # (.., B, H, P, N)
        lead = rank - 4
        batch = _batch_axes_fit(rules, shape[lead], sizes)
        h_tp = _fit(shape[lead + 1], rules.tp_axis, sizes)
        return P(*([None] * lead), batch, h_tp, None, None)
    if name == "conv":  # (.., B, t, C)
        lead = rank - 3
        batch = _batch_axes_fit(rules, shape[lead], sizes)
        c_tp = _fit(shape[lead + 2], rules.tp_axis, sizes)
        return P(*([None] * lead), batch, None, c_tp)
    return P(*([None] * rank))


def _batch_axes_fit(rules: AxisRules, dim: int, sizes: Dict[str, int]):
    """Longest prefix of batch axes whose product divides ``dim``."""
    axes = []
    n = 1
    for a in rules.batch_axes:
        if dim % (n * sizes.get(a, 1)) == 0:
            axes.append(a)
            n *= sizes.get(a, 1)
        else:
            break
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn("/"-joined path, leaf)`` over a tree of dicts, NamedTuples,
    lists and tuples, with the reference's path keys (dict keys, field
    names, ``[i]`` for positions)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*[_map_with_path(fn, getattr(tree, f),
                                           path + (f,))
                            for f in type(tree)._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def param_specs(params: Any, rules: AxisRules,
                sizes: Optional[Dict[str, int]] = None) -> Any:
    """PartitionSpec tree matching ``params`` (leaves need ``.shape``
    only: ``meta`` tensors do)."""
    sizes = sizes or {}
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), rules, sizes),
        params)


def cache_specs(cache: Any, rules: AxisRules,
                sizes: Optional[Dict[str, int]] = None) -> Any:
    sizes = sizes or {}
    return _map_with_path(
        lambda path, leaf: _cache_leaf_spec(path, tuple(leaf.shape), rules,
                                            sizes),
        cache)


class NamedSharding:
    """A spec over a named mesh, as ``jax.sharding.NamedSharding``:
    ``mesh`` (anything with ``axis_names`` and a name -> size ``shape``,
    such as :class:`~repro_torch.distributed.mesh.DeviceMesh`) and
    ``spec``.  Nothing is placed; :meth:`shard_shape` gives the block one
    device holds."""

    def __init__(self, mesh: Any, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def shard_shape(self, global_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Each dimension over the product of the mesh axes its spec entry
        names.  An uneven split rounds up, as XLA pads the last block (JAX
        raises there instead)."""
        sizes = dict(self.mesh.shape)
        spec = tuple(self.spec) + (None,) * (len(global_shape)
                                             - len(self.spec))
        if len(spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(global_shape)}")
        return tuple(-(-int(d) // _axes_size(axes, sizes))
                     for d, axes in zip(global_shape, spec))

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh.shape}, spec={self.spec!r})"


def named_shardings(params: Any, rules: AxisRules, mesh: Any) -> Any:
    """A :class:`NamedSharding` per leaf of ``params``: the reference's
    ``named_shardings``.  As there, the specs come from
    :func:`param_specs` without the mesh's sizes, so every ``_fit`` sees
    axes of size 1 and every leaf is replicated; the dry run builds its
    shardings from ``param_specs(params, rules, sizes)`` instead."""
    specs = param_specs(params, rules)
    return _map_specs(lambda s: NamedSharding(mesh, s), specs)


def _map_specs(fn, tree: Any) -> Any:
    """``fn`` on every :class:`PartitionSpec` of a spec tree."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*[_map_specs(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def batch_spec(
    rules: AxisRules,
    batch_dim: int,
    extra_dims: int = 1,
    sizes: Optional[Dict[str, int]] = None,
) -> PartitionSpec:
    """Batch sharding over the longest divisible prefix of the DP axes."""
    axes = _batch_axes_fit(rules, batch_dim, sizes or {})
    return P(axes, *([None] * extra_dims))
