"""Matrix-path vs fringe-path roofline attribution.

The paper's core analysis measured where each heterogeneous engine sat
idle; this module reproduces that analysis for the port's own dispatches.
Input is the telemetry profiler's records (measured wall-clock joined with
modeled FLOPs/bytes per engine path); output is:

- per (op, tier, plan signature): calls, measured time, and — per engine
  path — modeled FLOPs, modeled bytes, the roofline *bound*
  (``max(flops/peak_flops, bytes/peak_bw)``), whether that path is
  compute- or memory-bound, and the share of modeled cost it carries;
- an overall matrix-path vs fringe-path split: measured time attributed
  to each path proportionally to its modeled roofline bound, plus the
  aggregate utilization (modeled bound / measured wall) — how far from
  the card's ceiling each engine path runs.

The ceilings ride on each record (``peaks``): ``exec.api`` gives the
H100's (``cost_model.H100_HBM_BYTES_PER_S`` and ``H100_FP32_FLOPS_PER_S``).
Calls that built an executor or a kernel are excluded by default
(``traced`` records measure the build, not the engines).  Everything here
is plain aggregation over host-side records, with no imports from the
layers above.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

from .metrics import format_sample
from .profile import PATHS, DispatchRecord


def _path_bound_us(terms: Dict[str, float], peaks: Dict[str, float]) -> float:
    """Roofline lower bound (us) for one path's modeled work."""
    peak_flops = peaks.get("flops_per_s", 0.0)
    peak_bw = peaks.get("bytes_per_s", 0.0)
    t_compute = terms["flops"] / peak_flops if peak_flops > 0 else 0.0
    t_memory = terms["bytes"] / peak_bw if peak_bw > 0 else 0.0
    return max(t_compute, t_memory) * 1e6


def _bound_kind(terms: Dict[str, float], peaks: Dict[str, float]) -> str:
    peak_flops = peaks.get("flops_per_s", 0.0)
    peak_bw = peaks.get("bytes_per_s", 0.0)
    t_compute = terms["flops"] / peak_flops if peak_flops > 0 else 0.0
    t_memory = terms["bytes"] / peak_bw if peak_bw > 0 else 0.0
    if t_compute == t_memory == 0.0:
        return "none"
    return "compute" if t_compute >= t_memory else "memory"


def roofline_attribution(
    records: Iterable[DispatchRecord], *, include_traced: bool = False
) -> Dict[str, Any]:
    """Aggregate profiler records into the engine-path roofline report."""
    rows: Dict[tuple, Dict[str, Any]] = {}
    skipped_traced = 0
    for rec in records:
        if rec.traced and not include_traced:
            skipped_traced += 1
            continue
        key = (rec.op, rec.tier, rec.sig_key)
        row = rows.get(key)
        if row is None:
            row = rows[key] = {
                "op": rec.op,
                "tier": rec.tier,
                "sig": rec.sig_key,
                "calls": 0,
                "measured_us": 0.0,
                "paths": {p: {"flops": 0.0, "bytes": 0.0, "bound_us": 0.0}
                          for p in PATHS},
                "peaks": dict(rec.peaks),
                "matrix_format": None,
                "_waste_sum": 0.0,
                "_waste_n": 0,
            }
        row["calls"] += 1
        row["measured_us"] += rec.measured_us
        if "matrix_format" in rec.attrs:
            row["matrix_format"] = rec.attrs["matrix_format"]
        if "padding_waste" in rec.attrs:
            row["_waste_sum"] += float(rec.attrs["padding_waste"])
            row["_waste_n"] += 1
        for p in PATHS:
            terms = rec.terms.get(p)
            if terms is None:
                continue
            acc = row["paths"][p]
            acc["flops"] += terms["flops"]
            acc["bytes"] += terms["bytes"]
            acc["bound_us"] += _path_bound_us(terms, rec.peaks)

    out_rows: List[Dict[str, Any]] = []
    total = {p: {"bound_us": 0.0, "attributed_us": 0.0, "flops": 0.0,
                 "bytes": 0.0} for p in PATHS}
    total_measured = 0.0
    for key in sorted(rows):
        row = rows[key]
        measured = row["measured_us"]
        bound_total = sum(p["bound_us"] for p in row["paths"].values())
        for p, acc in row["paths"].items():
            # measured wall covers the whole fused dispatch; attribute it
            # to engine paths proportionally to each path's modeled bound
            share = acc["bound_us"] / bound_total if bound_total > 0 else 0.0
            acc["share"] = share
            acc["attributed_us"] = measured * share
            acc["bound"] = _bound_kind(acc, row["peaks"])
            total[p]["bound_us"] += acc["bound_us"]
            total[p]["attributed_us"] += acc["attributed_us"]
            total[p]["flops"] += acc["flops"]
            total[p]["bytes"] += acc["bytes"]
        row["mean_us"] = measured / row["calls"] if row["calls"] else 0.0
        row["utilization"] = bound_total / measured if measured > 0 else 0.0
        # padding waste of the matrix path's streamed tiles (from the plan
        # stats, via the dispatch attrs): structured payloads model fewer
        # bytes for the same waste, which shows up as a higher utilization
        waste_n = row.pop("_waste_n")
        waste_sum = row.pop("_waste_sum")
        row["padding_waste"] = waste_sum / waste_n if waste_n else None
        total_measured += measured
        out_rows.append(row)

    overall_bound = sum(t["bound_us"] for t in total.values())
    for t in total.values():
        t["share"] = (t["bound_us"] / overall_bound
                      if overall_bound > 0 else 0.0)
    return {
        "rows": out_rows,
        "matrix_path": total["matrix"],
        "fringe_path": total["fringe"],
        "measured_us_total": total_measured,
        "utilization": (overall_bound / total_measured
                        if total_measured > 0 else 0.0),
        "skipped_traced": skipped_traced,
    }


def format_report(attr: Dict[str, Any]) -> str:
    """Human-readable roofline table (README sample / CLI dumps)."""
    lines = [
        "engine-path roofline attribution "
        f"(measured {attr['measured_us_total']:.1f} us, "
        f"utilization {100.0 * attr['utilization']:.1f}%)",
        f"{'op':<10} {'tier':<10} {'sig':<12} {'calls':>6} "
        f"{'mean_us':>10} {'matrix%':>8} {'fringe%':>8} {'util%':>7} "
        f"{'fmt':<8} {'waste%':>7}",
    ]
    for row in attr["rows"]:
        waste = row.get("padding_waste")
        lines.append(
            f"{row['op']:<10} {row['tier']:<10} {row['sig']:<12} "
            f"{row['calls']:>6} {row['mean_us']:>10.1f} "
            f"{100.0 * row['paths']['matrix']['share']:>7.1f}% "
            f"{100.0 * row['paths']['fringe']['share']:>7.1f}% "
            f"{100.0 * row['utilization']:>6.1f}% "
            f"{row.get('matrix_format') or '-':<8} "
            + (f"{100.0 * waste:>6.1f}%" if waste is not None
               else f"{'-':>7}")
        )
    for path in ("matrix", "fringe"):
        t = attr[f"{path}_path"]
        lines.append(
            f"{path}-path: modeled {t['flops']:.3g} FLOPs / "
            f"{t['bytes']:.3g} B, bound {t['bound_us']:.1f} us, "
            f"attributed {t['attributed_us']:.1f} us "
            f"({100.0 * t['share']:.1f}% of modeled cost)"
        )
    return "\n".join(lines)


def roofline_prometheus(attr: Dict[str, Any]) -> str:
    """Prometheus text samples for the roofline attribution.

    Emitted as gauges computed from the current profiler ring — they
    describe the recent dispatch window, not a monotone total.
    """
    lines = [
        "# TYPE repro_roofline_measured_us gauge",
    ]
    for row in attr["rows"]:
        base = {"op": row["op"], "tier": row["tier"], "sig": row["sig"]}
        lines.append(format_sample(
            "repro_roofline_measured_us", base, row["measured_us"]))
    lines.append("# TYPE repro_roofline_calls gauge")
    for row in attr["rows"]:
        base = {"op": row["op"], "tier": row["tier"], "sig": row["sig"]}
        lines.append(format_sample("repro_roofline_calls", base,
                                   row["calls"]))
    lines.append("# TYPE repro_roofline_utilization gauge")
    for row in attr["rows"]:
        base = {"op": row["op"], "tier": row["tier"], "sig": row["sig"]}
        lines.append(format_sample("repro_roofline_utilization", base,
                                   row["utilization"]))
    waste_rows = [r for r in attr["rows"]
                  if r.get("padding_waste") is not None]
    if waste_rows:
        lines.append("# TYPE repro_roofline_padding_waste gauge")
        for row in waste_rows:
            base = {"op": row["op"], "tier": row["tier"], "sig": row["sig"],
                    "format": row.get("matrix_format") or "general"}
            lines.append(format_sample("repro_roofline_padding_waste", base,
                                       row["padding_waste"]))
    for metric, field in (("repro_roofline_modeled_flops", "flops"),
                          ("repro_roofline_modeled_bytes", "bytes"),
                          ("repro_roofline_bound_us", "bound_us"),
                          ("repro_roofline_attributed_us", "attributed_us")):
        lines.append(f"# TYPE {metric} gauge")
        for row in attr["rows"]:
            for p in PATHS:
                labels = {"op": row["op"], "tier": row["tier"],
                          "sig": row["sig"], "path": p}
                lines.append(format_sample(
                    metric, labels, row["paths"][p][field]))
        for p in PATHS:
            lines.append(format_sample(
                metric, {"op": "_all", "tier": "_all", "sig": "_all",
                         "path": p},
                attr[f"{p}_path"][field]))
    return "\n".join(lines) + "\n"
