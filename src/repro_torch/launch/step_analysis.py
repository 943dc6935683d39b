"""Step analysis for the dry run: what one step costs, counted on the
``meta`` device, and its H100 roofline terms.  The port's counterpart of
``repro.launch.hlo_analysis``: the reference reads XLA's compiled,
partitioned program; the port runs its partitioned DTensor program
eagerly as one device (rank 0) on ``meta`` tensors (shapes, no data)
and counts.

:func:`count_step` runs ``fn(*args)`` once under its dispatch modes and
returns four numbers, each one device's when the args are DTensors (an
op on DTensors is handed to DTensor, whose local ops and collectives are
counted, so each op counts once; the tensor ops DTensor's sharding
propagation and redistribution planning run for themselves are not):

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s formulas on
  the local ops.  It counts the products it has formulas for: ``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions and scaled-dot-product
  attention, forward and backward (einsums reach it as ``bmm``).
  Elementwise work, reductions, softmax, norms, RoPE, casts and the
  optimizer's update are left out.  ``model_flops_total`` in the dry
  run's record (6·N·D or 2·N·D) is the count that does not depend on the
  implementation.
- ``bytes_accessed``: the operand bytes plus the output bytes of every
  local aten op the step dispatches, the eager analogue of XLA's ``bytes
  accessed``.  View ops (``is_view``, ``_unsafe_view``), bare
  allocations (``empty*``) and collectives move no bytes here and are
  left out; an in-place op reads and writes its first operand; an
  ``out=`` op's buffer counts as written, not read.
- ``temp_peak_bytes``: the peak of live (local) storage bytes above the
  state passed in, from ``torch.distributed._tools.mem_tracker.
  MemTracker`` (storages tracked by weak reference from a dispatch mode;
  ``args``' local blocks are registered with ``track_external`` first and
  their bytes subtracted).  On a card it rounds each storage up to 512
  bytes, as the caching allocator does; on ``meta`` it counts exact
  bytes.
- ``collectives``: every collective the program issues
  (``torch.ops._c10d_functional`` and DTensor's all-to-all, the ops
  ``CommDebugMode`` counts), by kind, in the reference's result-bytes
  convention (an all-reduce counts its result, the whole buffer; an
  all-gather the gathered tensor; a reduce-scatter its shard; ``count``
  the number of collectives).

:func:`collective_bytes` reckons the collectives a cell's sharding
implies, per device, from its spec trees and mesh sizes, with the rules
below: the dry run records the counted collectives and keeps this
reckoning as a cross-check (``tests/test_torch_launch.py`` holds the two
equal on a dense cell for the groups the rules cover, and the counted
ones against XLA's partitioned module group by group).  The rules follow
what XLA's SPMD partitioner emits for the reference's step.  Per
microbatch:

- FSDP all-gather of each FSDP-sharded leaf (over those axes; TP axes
  stay split), in the compute dtype: the layer casts the leaf on its
  shard, then gathers the cast.  A leaf of the layer stack is gathered
  in the forward and, in a train step with ``remat="full"``, once more
  for the recompute, whose gathered copy the backward reuses; without
  remat the backward reuses the forward's.  A leaf outside the stack
  (the head) is gathered once.  A stacked leaf is one gather per group.
- Gradient reduction (train): a leaf FSDP-sharded over an axis that
  carries the batch is reduce-scattered over those axes; over the batch
  axes that do not shard it, its shard is all-reduced.  Results are
  shards, in the compute dtype for a leaf the layers cast (a product's
  weight), else in the param dtype (norm scales, biases, the router).
- TP all-reduce of the residual stream (one device's tokens of the
  microbatch x ``d_model``, in the compute dtype; one token per
  sequence for decode): after each row-parallel product (``wo``,
  ``w_out``, ``out_proj``, ``shared_w_out``) whose in-dimension is split
  over the TP axis, in the forward, and again in the recompute for
  ``wo`` where an MLP or MoE follows it in the layer (the recompute
  stops before a layer's last product, whose output only feeds the
  residual); in the backward, after each column-parallel product whose
  out-dimension is split over the TP axis (``wq``, ``wk``, ``wv``,
  ``w_in``, ``w_gate``, ``in_proj``, the head, ...): its input's
  gradient, summed over the TP shards.  ``frontend_proj`` reads the
  batch, which needs no gradient.  zamba2's shared block counts once per
  application.  A device's tokens of a microbatch are rounded up to a
  whole sequence (:func:`device_microbatch`), as XLA pads an uneven
  split.
- Expert parallelism (``AxisRules.expert_axis``): two all-to-alls per
  MoE layer and direction (dispatch and combine), each the packed
  ``(E, C, d_model)`` buffer of the local tokens.

The rules leave out what the counted program issues besides: the
embedding lookup (the ids gathered over the axes that split the table's
d_model, the looked-up rows summed over the vocab axis and moved to the
batch split, and back in the backward), the vocab-parallel softmax's
statistics (three float32 all-reduces of one number per token), scalar
all-reduces (the loss, the token count, the gradient norm), the MoE's and
the SSM's own layout collectives, and sequence parallelism.  The
reduce-scatters are what XLA's GPU pipeline forms; the CPU partitioner
leaves each as an all-reduce of the whole TP shard followed by a slice.

The H100 constants price the three terms, as ``hlo_analysis``'s TPU
constants did for the reference.  ``LINK_BW`` is one card's 400 Gb/s NDR
port: every axis of the production meshes (16 wide, and the pod axis)
spans DGX H100 nodes of 8 cards, so every collective leaves the node.
NVLink's 450 GB/s a direction inside a node prices no axis of these
meshes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import types
from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core.cost_model import H100_HBM_BYTES_PER_S
from ..distributed.sharding import (
    _COL_PARALLEL, _ROW_PARALLEL, AxisRules, NamedSharding, _batch_axes_fit,
    _axes_size,
)

# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit:
# dense bf16 tensor-core peak, from the data sheet
PEAK_FLOPS_BF16 = 989.4e12   # FLOP/s per card
# HBM3 bandwidth, the data sheet's (shared with core/cost_model.py)
HBM_BW = H100_HBM_BYTES_PER_S  # 3.35e12 bytes/s per card
# one 400 Gb/s NDR InfiniBand port per card (the DGX H100's layout)
LINK_BW = 50e9               # bytes/s per card
# NVIDIA H100 80GB HBM3, 700 W: nvidia-smi --query-gpu=memory.total
HBM_BYTES = 81559 * 2**20    # 81,559 MiB per card

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


# ---------------------------------------------------------------------------
# counting one step on the meta device
# ---------------------------------------------------------------------------
class StepCount(NamedTuple):
    flops: int
    bytes_accessed: int
    temp_peak_bytes: int
    # result bytes by kind (COLLECTIVES) and ``count``: the collectives
    # the step issued (none for an unpartitioned program)
    collectives: Dict[str, int] = {}


def _local_of(t: Any) -> Any:
    """A DTensor's local block; any other value itself."""
    return t.to_local() if hasattr(t, "placements") else t


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


_NO_TRAFFIC: Dict[Any, bool] = {}


def _moves_no_bytes(func) -> bool:
    hit = _NO_TRAFFIC.get(func)
    if hit is None:
        name = func.overloadpacket.__name__
        hit = bool(func.is_view) or name in (
            "_unsafe_view", "empty", "empty_strided", "empty_like",
            "new_empty", "new_empty_strided", "lift_fresh")
        _NO_TRAFFIC[func] = hit
    return hit


# collective ops as DTensor issues them (``torch.ops._c10d_functional``
# and DTensor's own all-to-all), by the reference's kind names
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def _collective_kind(func) -> Any:
    """The kind of a collective op, ``"wait"`` for its wait, else None."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func.overloadpacket.__name__
    if name == "wait_tensor":
        return "wait"
    return _COLLECTIVE_KINDS.get(name)


class _LocalMode(TorchDispatchMode):
    """A dispatch mode that sees one device's program: an op on DTensors
    is handed to DTensor (``NotImplemented``), which runs it as local ops
    and collectives that come back here; ops DTensor runs under its own
    fake mode to propagate shardings are run uncounted."""

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def _counted(self, types) -> bool:
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        if _PLANNING[0] or any(issubclass(t, DTensor) for t in types):
            return False
        return active_fake_mode() is self._fake_on_entry


# DTensor's sharding propagation and redistribution planning run a few
# tensor ops of their own (shard sizes and offsets) the first time they
# meet an op or a layout, then cache the plan: they are not the
# program's, and counting them would make a count depend on what ran
# before it in the process
_PLANNING = [0]


def _uncounted(fn):
    def run(*args, **kwargs):
        _PLANNING[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _PLANNING[0] -= 1
    return run


_PLANNERS = {
    "redistribute": ("_gen_transform_infos_non_cached",),
    "propagator": ("propagate", "propagate_op_sharding",
                   "propagate_op_sharding_non_cached",
                   "_propagate_tensor_meta",
                   "_propagate_tensor_meta_non_cached"),
}


@contextlib.contextmanager
def _planning_uncounted():
    """Keep DTensor's planning functions out of the counts.  They are
    private, so a torch release may rename them: if either group has none
    of its names, this raises rather than count the planning ops."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute

    owners = {"redistribute": _redistribute,
              "propagator": DTensor._op_dispatcher.sharding_propagator}
    saved = []
    for group, names in _PLANNERS.items():
        found = [(owners[group], n) for n in names
                 if hasattr(owners[group], n)]
        if not found:
            raise RuntimeError(
                f"DTensor's {group} has none of {names} in torch "
                f"{torch.__version__}: count_step cannot keep its planning "
                f"ops out of the counts")
        saved += found
    before = [(obj, name, obj.__dict__.get(name)) for obj, name in saved]
    for obj, name in saved:
        setattr(obj, name, _uncounted(getattr(obj, name)))
    try:
        yield
    finally:
        for obj, name, old in before:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


class _BytesMode(_LocalMode):
    """Sums operand and output bytes of every op that moves data, and the
    result bytes of every collective, by kind."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collectives["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if not self._counted(types):
            return func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind == "wait":
            # a meta collective's result is complete; its wait is no op
            return args[0] if args[0].device.type == "meta" \
                else func(*args, **kwargs)
        out = func(*args, **kwargs)
        if kind is not None:
            self.collectives[kind] = self.collectives.get(kind, 0) \
                + _nbytes(out)
            self.collectives["count"] += 1
        elif not _moves_no_bytes(func):
            reads = kwargs
            if func._overloadname.startswith("out") and "out" in kwargs:
                reads = {k: v for k, v in kwargs.items() if k != "out"}
            self.total += _nbytes(args) + _nbytes(reads) + _nbytes(out)
        return out


def _flop_mode(counter):
    """``FlopCounterMode``'s dispatch mode counting local ops only."""
    from torch.utils.flop_counter import _FlopCounterMode

    class _LocalFlops(_FlopCounterMode, _LocalMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor

            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if not self._counted(types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _LocalFlops(counter)


def _mem_tracker():
    """torch's ``MemTracker``, blind to DTensor's planning ops (some
    releases run sharding propagation on ``meta`` inputs as they are,
    not under a fake mode, where the tracker would count them)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class _LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _PLANNING[0]:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _LocalMemTracker()


def _tracked_total(snapshot: Dict[Any, Dict[str, int]]) -> int:
    return sum(dev_snap.get("Total", 0) for dev_snap in snapshot.values())


def count_step(fn: Callable[..., Any], *args: Any,
               memory: bool = True) -> StepCount:
    """Run ``fn(*args)`` once and count it (see the module docstring).
    ``memory=False`` skips the memory tracker (``temp_peak_bytes`` 0).
    The result of ``fn`` is dropped before the count returns.

    On a partitioned program (DTensor args) every number is one
    device's: FLOPs and bytes of the local ops only, each op once (an op
    on DTensors is counted as the local ops DTensor runs for it), the
    temp peak of the local storages, and the collectives issued."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    bytes_mode = _BytesMode()
    base = 0
    with contextlib.ExitStack() as stack:
        tracker = None
        if memory:
            tracker = _mem_tracker()
            tracker.track_external(*[_local_of(t) for t in tree_leaves(args)
                                     if isinstance(t, torch.Tensor)])
            base = _tracked_total(tracker.get_tracker_snapshot("current"))
            stack.enter_context(tracker)
        stack.enter_context(_planning_uncounted())
        stack.enter_context(_flop_mode(counter))
        stack.enter_context(bytes_mode)
        out = fn(*args)
        del out
    peak = (_tracked_total(tracker.get_tracker_snapshot("peak"))
            if tracker is not None else base)
    return StepCount(int(counter.get_total_flops()), int(bytes_mode.total),
                     max(peak - base, 0), dict(bytes_mode.collectives))


# ---------------------------------------------------------------------------
# collectives reckoned from the specs
# ---------------------------------------------------------------------------
def _leaves(tree: Any, specs: Any, path: Tuple[str, ...] = (),
            layer: Any = None
            ) -> Iterator[Tuple[str, torch.Tensor, Tuple[Any, ...], Any]]:
    """(path, leaf, spec, layer) over a param tree and its spec tree;
    ``layer`` is the dict two levels up (the layer that holds the leaf's
    block, e.g. ``attn`` and ``mlp``)."""
    if isinstance(tree, dict):
        for k in tree:
            sub = tree[k]
            yield from _leaves(sub, specs[k], path + (str(k),),
                               tree if isinstance(sub, dict) else layer)
    else:
        yield "/".join(path), tree, tuple(specs), layer


def _axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _bytes_of(shape, itemsize: int) -> int:
    return math.prod(shape) * itemsize


def device_microbatch(batch: int, microbatches: int, n_batch: int) -> int:
    """Sequences one device holds of one microbatch: the microbatch
    (``batch // microbatches``) over the ``n_batch`` devices of the batch
    axes, rounded up (so at least one), as XLA pads an uneven split."""
    return max(-(-(batch // microbatches) // n_batch), 1)


_CAST = _COL_PARALLEL | _ROW_PARALLEL | {"table"}  # read in the compute dtype


def collective_bytes(
    params: Any,
    param_specs: Any,
    sizes: Dict[str, int],
    rules: AxisRules,
    cfg: Any,
    *,
    kind: str,
    batch: int,
    seq_len: int,
    microbatches: int = 1,
) -> Dict[str, int]:
    """Per-device collective result bytes of one step of a cell, by kind,
    and ``count`` (the rules are in the module docstring).  ``params`` is
    the param tree (``meta`` tensors), ``param_specs`` its spec tree
    under ``rules`` and the mesh's ``sizes``; ``batch`` is the global
    batch, ``kind`` the cell's ("train", "prefill" or "decode")."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0

    def add(key: str, nbytes: int, n: int) -> None:
        out[key] += nbytes * n
        out["count"] += n

    mesh = types.SimpleNamespace(shape=dict(sizes))  # as NamedSharding reads it
    train = kind == "train"
    m = microbatches if train else 1
    recompute = train and cfg.remat == "full"
    batch_axes = tuple(a for a in _axes(_batch_axes_fit(rules, batch, sizes))
                       if sizes.get(a, 1) > 1)
    fsdp = set(rules.fsdp_axes)
    tp = rules.tp_axis if rules.tp_axis and sizes.get(rules.tp_axis, 1) > 1 \
        else None
    n_shared = sum(1 for k in cfg.layer_kinds() if k == "shared_attn")
    cd = torch.empty((), dtype=cfg.compute_dtype).element_size()
    n_b = _axes_size(batch_axes, sizes) if batch_axes else 1
    tokens = device_microbatch(batch, m, n_b) * (
        1 if kind == "decode" else seq_len)
    residual = tokens * cfg.d_model * cd

    for path, leaf, spec, layer in _leaves(params, param_specs):
        name = path.split("/")[-1]
        if name == "table" and not cfg.tie_embeddings:
            continue  # the lookup: left out
        in_stack = path.startswith("stack/")
        # a stacked leaf is one collective per group, of one group's slice
        stacked = path.startswith("stack/groups/")
        ops = int(leaf.shape[0]) if stacked else 1
        apps = ops * (n_shared if path.startswith("stack/shared/") else 1)
        shape = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
        spec = spec[1:] if stacked else spec
        itemsize = cd if name in _CAST else leaf.element_size()
        shard_bytes = _bytes_of(
            NamedSharding(mesh, spec).shard_shape(shape), itemsize)
        f_axes = {a for e in spec for a in _axes(e)
                  if a in fsdp and sizes.get(a, 1) > 1}
        if f_axes:
            gathered = tuple(e if not (set(_axes(e)) & f_axes) else None
                             for e in spec)
            g_shape = NamedSharding(mesh, gathered).shard_shape(shape)
            passes = 2 if recompute and in_stack else 1
            add("all-gather", _bytes_of(g_shape, itemsize), ops * passes * m)
        if train:
            rs = f_axes & set(batch_axes)
            ar = [a for a in batch_axes if a not in f_axes]
            if rs:
                add("reduce-scatter", shard_bytes, ops * m)
            if ar:
                add("all-reduce", shard_bytes, ops * m)
        if tp is None or len(shape) < 2:
            continue
        if name in _ROW_PARALLEL and tp in _axes(spec[-2]):
            again = recompute and name == "wo" and (
                "mlp" in layer or "moe" in layer)
            add("all-reduce", residual, apps * (2 if again else 1) * m)
        elif train and name != "frontend_proj" and (
                name in _COL_PARALLEL and tp in _axes(spec[-1])
                or name == "table" and tp in _axes(spec[0])):
            add("all-reduce", residual, apps * m)
    if rules.expert_axis and sizes.get(rules.expert_axis, 1) > 1 \
            and cfg.moe_num_experts:
        spec_moe = cfg.moe_spec()
        n_moe = sum(1 for k in cfg.layer_kinds() if k == "attn_moe")
        packed = (spec_moe.num_experts * spec_moe.capacity(tokens)
                  * cfg.d_model * cd)
        passes = (3 if recompute else 2) if train else 1
        add("all-to-all", packed, 2 * n_moe * passes * m)
    return out


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Fraction of the step the compute term occupies at the bound —
        1.0 means perfectly compute-bound (roofline-saturating)."""
        if self.bound_s <= 0:
            return 0.0
        return self.compute_s / self.bound_s


def roofline_terms(
    flops_pd: float, bytes_pd: float, coll_bytes_pd: float
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_pd / PEAK_FLOPS_BF16,
        memory_s=bytes_pd / HBM_BW,
        collective_s=coll_bytes_pd / LINK_BW,
        flops_per_device=flops_pd,
        bytes_per_device=bytes_pd,
        collective_bytes_per_device=coll_bytes_pd,
    )
