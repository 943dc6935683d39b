"""Roofline terms by probe extrapolation.  A port of
``repro.launch.roofline``.

A full-depth trace of a big cell takes minutes (nemotron-4-340b's train
cell runs 96 layers and 16 microbatches), so, as the reference compiles
probes, the port traces *probe* builds at depth L groups and M
microbatches and solves

    metric(L, M) = a + b*L + c*M + d*L*M

exactly.  Every counted metric (FLOPs, bytes accessed, collective bytes
and count) is bilinear in (L, M) for an eager step: each extra group
adds the same layer ops, collectives and optimizer update, each extra
microbatch re-runs the per-group forward and backward.  One exception
sits at M = 1: a one-microbatch step keeps the backward's gradients,
where more microbatches add each into an fp32 accumulator
(``train_loop``).  So a cell with M > 1 is probed at M in {2, 3}, both
on the accumulating path, and the solve runs in M - 1; a cell with M = 1
needs only L.  The full-cell value is the polynomial at
(num_layers / pattern_len, M); fractional L handles pattern tails
(zamba2: 38 = 6 x 6 + 2).

Probes are traced as partitioned programs (``specs.build_cell(...,
partitioned=True)``) on the cell's mesh, as rank 0: every metric is one
device's, counted on its local tensors, and the collectives are those
the program issues.  A probe holds the size of one device's share of a
microbatch at the cell's (:func:`~.step_analysis.device_microbatch`,
rounded up to one sequence as XLA pads).  The full-depth trace that
proves the cell builds, and gives its memory, is ``dryrun.py``'s.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..configs.base import SHAPES, ArchDef
from ..distributed import sharding as shd
from . import step_analysis
from .specs import build_cell, default_rules, partition


def _probe_metrics(
    arch: ArchDef,
    shape_name: str,
    mesh,
    l_groups: int,
    m_micro: int,
    micro_size: int,
    overrides: Optional[Dict[str, Any]] = None,
    rules=None,
) -> Dict[str, float]:
    """Per-device metrics of one probe build (L groups, M microbatches)."""
    pattern_len = len(arch.full.group_pattern())
    ov = dict(overrides or {})
    ov["num_layers"] = pattern_len * l_groups
    kind = SHAPES[shape_name].kind
    if kind == "train":
        # hold the microbatch SIZE fixed, vary the count — keeps the metric
        # bilinear in (L, M)
        ov["num_microbatches"] = m_micro
        ov["global_batch"] = micro_size * m_micro
    cell = build_cell(arch, shape_name, mesh, overrides=ov, analysis_mode=True,
                      rules=rules, partitioned=True)
    count = step_analysis.count_step(cell.fn, *cell.args, memory=False)
    coll = count.collectives
    out = {
        "flops": float(count.flops),
        "bytes": float(count.bytes_accessed),
        "coll_total": float(sum(coll.get(k, 0)
                                for k in step_analysis.COLLECTIVES)),
        "coll_count": float(coll["count"]),
    }
    for k in step_analysis.COLLECTIVES:
        out[f"coll_{k}"] = float(coll.get(k, 0))
    return out


def cell_collectives(cell) -> Dict[str, int]:
    """The collectives one device's partitioned program of a built cell
    issues, counted (``step_analysis.count_step``): result bytes by kind
    and ``count``."""
    pcell = cell if cell.dmesh is not None else partition(cell)
    count = step_analysis.count_step(pcell.fn, *pcell.args, memory=False)
    return count.collectives


def reckoned_collectives(cell) -> Dict[str, int]:
    """``step_analysis.collective_bytes`` of a built cell: the hand
    reckoning from its specs, kept as a cross-check of the counted
    collectives."""
    sizes = dict(cell.mesh.shape)
    meta = cell.meta
    return step_analysis.collective_bytes(
        cell.args[0], shd.param_specs(cell.args[0], cell.rules, sizes),
        sizes, cell.rules, cell.cfg, kind=meta["kind"],
        batch=meta["global_batch"], seq_len=meta["seq_len"],
        microbatches=meta.get("microbatches", 1))


def _bilinear(m11, m21, m12, m22, L: float, M: float) -> float:
    """Solve m(L,M)=a+bL+cM+dLM from probes at (1,1),(2,1),(1,2),(2,2)."""
    d = m22 - m21 - m12 + m11
    b = m21 - m11 - d
    c = m12 - m11 - d
    a = m11 - b - c - d
    return a + b * L + c * M + d * L * M


def _linear(m1, m2, L: float) -> float:
    b = m2 - m1
    return m1 + b * (L - 1.0)


def probe_roofline(
    arch: ArchDef,
    shape_name: str,
    mesh,
    overrides: Optional[Dict[str, Any]] = None,
    micro_override: Optional[int] = None,
    rules=None,
) -> Dict[str, Any]:
    """Returns extrapolated per-device cost metrics + roofline terms."""
    cell = SHAPES[shape_name]
    pattern_len = len(arch.full.group_pattern())
    L = arch.full.num_layers / pattern_len
    if overrides and "num_layers" in overrides:
        L = overrides["num_layers"] / pattern_len
    M = (micro_override
         or (overrides or {}).get("num_microbatches")
         or arch.microbatches.get(shape_name, 1))
    is_train = cell.kind == "train"
    global_batch = (overrides or {}).get("global_batch") or cell.global_batch
    r = rules or default_rules(mesh)
    sizes = dict(mesh.shape)
    n_b = shd._axes_size(shd._batch_axes_fit(r, global_batch, sizes), sizes)
    micro_size = step_analysis.device_microbatch(global_batch, M, n_b) * n_b

    def probe(l_groups, m_micro):
        return _probe_metrics(arch, shape_name, mesh, l_groups, m_micro,
                              micro_size, overrides, rules)

    if is_train and M > 1:
        # the accumulating path: probes at M in {2, 3}, solved in M - 1
        p11, p21 = probe(1, 2), probe(2, 2)
        p12, p22 = probe(1, 3), probe(2, 3)
        est = {
            k: max(0.0, _bilinear(p11[k], p21[k], p12[k], p22[k], L, M - 1))
            for k in p11
        }
        m_probes = [2, 3]
    else:
        p11, p21 = probe(1, 1), probe(2, 1)
        est = {k: max(0.0, _linear(p11[k], p21[k], L)) for k in p11}
        m_probes = [1]

    terms = step_analysis.roofline_terms(
        est["flops"], est["bytes"], est["coll_total"]
    )
    return {
        "probes": {"L": L, "M": M, "M_probes": m_probes, "p11": p11,
                   "p21": p21},
        "est": est,
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "bound_s": terms.bound_s,
            "roofline_fraction": terms.roofline_fraction(),
        },
    }
