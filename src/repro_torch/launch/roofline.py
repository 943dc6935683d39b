"""Roofline terms by probe extrapolation.  A port of
``repro.launch.roofline``.

A full-depth trace of a big cell takes a minute or more on ``meta``
(nemotron-4-340b's train cell runs 96 layers and 16 microbatches; its
trace of 2 microbatches at one shard's batch took about 100 s on one
core of a Linux x86 host), so, as the reference compiles probes, the
port traces *probe* builds at depth L groups and M microbatches and
solves

    metric(L, M) = a + b*L + c*M + d*L*M

exactly.  Every counted metric (FLOPs, bytes accessed, collective bytes
and count) is bilinear in (L, M) for an eager step: each extra group
adds the same layer ops and its optimizer update, each extra microbatch
re-runs the per-group forward and backward.  One exception sits at
M = 1: a one-microbatch step keeps the backward's gradients, where more
microbatches add each into an fp32 accumulator (``train_loop``).  So a
cell with M > 1 is probed at M in {2, 3}, both on the accumulating path,
and the solve runs in M - 1; a cell with M = 1 needs only L.  The
full-cell value is the polynomial at (num_layers / pattern_len, M);
fractional L handles pattern tails (zamba2: 38 = 6 x 6 + 2).

Probes are traced at the cell's global batch (microbatch size held at
the cell's): the counts are the whole program's, and the per-device
figures are those over the mesh's device count.  The full-depth trace
that proves the cell builds, and gives its memory, is ``dryrun.py``'s.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

from ..configs.base import SHAPES, ArchDef
from ..distributed import sharding as shd
from . import step_analysis
from .specs import build_cell


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
                      rules=rules)
    count = step_analysis.count_step(cell.fn, *cell.args, memory=False)
    coll = cell_collectives(cell)
    n = math.prod(mesh.axis_sizes)
    out = {
        "flops": count.flops / n,
        "bytes": count.bytes_accessed / n,
        "coll_total": float(sum(v for k, v in coll.items() if k != "count")),
        "coll_count": float(coll["count"]),
    }
    for k in step_analysis.COLLECTIVES:
        out[f"coll_{k}"] = float(coll[k])
    return out


def cell_collectives(cell) -> Dict[str, int]:
    """``step_analysis.collective_bytes`` of a built cell."""
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
    micro_size = max(global_batch // M, 1)

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
