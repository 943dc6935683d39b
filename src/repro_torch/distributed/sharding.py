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

:class:`NamedSharding` pairs a spec with a mesh and gives each device's
block (:meth:`NamedSharding.shard_shape`); :func:`named_shardings` gives
one per param leaf, as the reference's.

A partitioned program is a DTensor program, the port's counterpart of
``jax.jit`` with shardings.  :func:`placements` turns a spec into one
DTensor placement per mesh dimension, :func:`place` turns a tree of
tensors into DTensors by their shardings, and :func:`use_dtensor_mesh`
installs a ``torch.distributed`` device mesh for the program.  Under an
installed mesh :func:`constrain` redistributes to the resolved spec, as
``jax.lax.with_sharding_constraint`` does (at the reference's constraint
points, and at the port's own where GSPMD's choice has to be spelled
out: a row-parallel product's output is summed over TP there), and
:func:`gather_weight` gathers a product's weight over its FSDP axes at
its use (after the cast to the compute dtype, as XLA orders it).
Without one, both return their input unchanged: every entry point runs
as an unpartitioned program.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


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
    """The reference's sharding constraint.  Under an installed DTensor
    mesh (:func:`use_dtensor_mesh`) a DTensor ``x`` is redistributed to
    the spec ``logical`` resolves to; otherwise ``x`` itself, after
    resolving ``logical`` under the installed rules."""
    spec = logical_spec(*logical)
    mesh = dtensor_mesh()
    if mesh is None or spec is None or not _is_dtensor(x):
        return x
    return to_placements(x, placements(_even(spec, x.shape, mesh), mesh,
                                      x.ndim))


def _even(spec: PartitionSpec, shape, mesh: Any) -> PartitionSpec:
    """``spec`` with each entry cut to the longest prefix of its axes
    whose sizes divide the dimension (a batch of 1 stays whole, as the
    batch's own spec leaves it, where XLA would pad)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        keep, n = [], 1
        for a in axes:
            if dim % (n * sizes[a]):
                break
            keep.append(a)
            n *= sizes[a]
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else tuple(keep))
    return PartitionSpec(*out)


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


# ---------------------------------------------------------------------------
# DTensor programs
# ---------------------------------------------------------------------------
_ACTIVE["dtensor_mesh"] = None


def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@contextlib.contextmanager
def use_dtensor_mesh(mesh: Any):
    """Run the ``with`` block as a partitioned program over ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh`` with the rules' axis
    names): :func:`constrain`, :func:`gather_weight` and
    :func:`grad_reduced` act, and a plain tensor that meets a DTensor is
    taken as replicated (``implicit_replication``: positions, masks).
    ``None`` installs nothing."""
    if mesh is None:
        yield None
        return
    from torch.distributed.tensor.experimental import implicit_replication

    prev = _ACTIVE["dtensor_mesh"]
    _ACTIVE["dtensor_mesh"] = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE["dtensor_mesh"] = prev


def dtensor_mesh() -> Any:
    """The installed DTensor mesh, or ``None``."""
    return _ACTIVE["dtensor_mesh"]


def placements(spec: Any, mesh: Any, ndim: Optional[int] = None) -> tuple:
    """One DTensor placement per dimension of ``mesh``: ``Shard(d)`` on
    every mesh axis that entry ``d`` of ``spec`` names (a dimension split
    over several axes is ``Shard(d)`` on each, in the spec's order, which
    must be the mesh's), ``Replicate()`` on the others.  ``ndim`` checks
    the spec's length against the tensor's."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    spec = tuple(spec or ())
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec} splits a dimension over axes "
                             f"out of the mesh's order {names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def logical_placements(ndim: int, logical) -> Optional[tuple]:
    """The placements ``logical`` resolves to for a tensor of ``ndim``
    dimensions under the installed rules and DTensor mesh; ``None``
    without either."""
    spec = logical_spec(*logical)
    mesh = dtensor_mesh()
    if spec is None or mesh is None:
        return None
    return placements(spec, mesh, ndim)


def _dtensor_of(t: Any, sharding: "NamedSharding", mesh: Any) -> Any:
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(sharding.spec, mesh, t.ndim)
    grad = t.requires_grad
    t = t.detach()
    if t.device.type == "meta" or _is_fake(t):
        local = torch.empty(sharding.shard_shape(tuple(t.shape)),
                            dtype=t.dtype, device=t.device)
        out = DTensor.from_local(local, mesh, pl, run_check=False,
                                 shape=t.shape, stride=t.stride())
    else:
        out = distribute_tensor(t, mesh, pl)
    return out.requires_grad_(grad) if grad else out


def _is_fake(t: Any) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def place(tree: Any, shardings: Any, mesh: Any) -> Any:
    """``tree``'s tensors as DTensors over ``mesh`` by the matching
    :class:`NamedSharding` of ``shardings`` (a tree of the same shape):
    real data through ``distribute_tensor``; ``meta`` or fake data as
    each device's block at ``NamedSharding.shard_shape`` (an uneven split
    rounds up, as XLA pads; DTensor's own split does so on rank 0).  A
    leaf that requires grad is a leaf DTensor that requires grad.
    Anything that is not a tensor (the decode length) is kept."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*[place(v, s, mesh)
                            for v, s in zip(tree, shardings)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s, mesh) for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        return _dtensor_of(tree, shardings, mesh)
    return tree


def _fsdp_dims(mesh: Any) -> set:
    rules = _ACTIVE["rules"]
    axes = set(rules.fsdp_axes) if rules is not None else set()
    return {i for i, n in enumerate(mesh.mesh_dim_names) if n in axes}


def gather_weight(w: Any, dtype: Any) -> Any:
    """A product's weight at its use: cast to ``dtype``, then, under an
    installed DTensor mesh, all-gathered over the FSDP axes that split
    it (the TP split stays).  Casting on the shard first is XLA's order
    and FSDP2's; under ``torch.utils.checkpoint`` the recompute gathers
    again."""
    w = w.to(dtype)
    mesh = dtensor_mesh()
    if mesh is None or not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    fsdp = _fsdp_dims(mesh)
    target = tuple(Replicate() if i in fsdp and p.is_shard() else p
                   for i, p in enumerate(w.placements))
    return to_placements(w, target)


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient into ``x``'s own
    placements (an all-reduce of a TP-partial gradient)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return to_placements(g, ctx.placements)


def grad_reduced(x: Any) -> Any:
    """``x`` as the input of a column-parallel product: under an
    installed DTensor mesh its gradient, partial over TP, is summed there
    (XLA all-reduces each such product's input gradient); else ``x``."""
    if dtensor_mesh() is None or not _is_dtensor(x) \
            or not torch.is_grad_enabled():
        return x
    return _ReduceGrad.apply(x)


def to_placements(x: Any, target: tuple) -> Any:
    """A DTensor ``x`` redistributed to ``target``; ``x`` itself when it
    is no DTensor or is already there."""
    target = tuple(target)
    if not _is_dtensor(x) or tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)
