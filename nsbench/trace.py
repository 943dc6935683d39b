"""Reduction of a ``torch.profiler`` trace of the measured window.

The harness opens a ``record_function("nsbench.window")`` range around the
window inside the profiled region; everything here is read between that
range's start and end.  Device activity is every kernel, copy and memset
on the card (the GPU-side copies of the harness's own ranges are not
activity).  An idle gap is a stretch of the window with none of them
running, and is named by what the main thread was doing on the host at
its middle: the innermost of the harness's ``nsbench.*`` ranges and the
outermost operator under it.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "nsbench.window"
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float          # length of the traced window
    busy_s: float            # union of device activity inside it
    device_sum_s: float      # sum of device activity durations inside it
    device_ops: List[Tuple[str, float]]   # top device operations, seconds
    idle_gaps: List[Tuple[str, float]]    # idle seconds by host activity

    @property
    def idle_frac(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _events(prof):
    """(name, activity, start_ns, end_ns, thread) of every recorded event,
    its activity reduced to what the reduction needs: ``user_annotation``
    (a host range), ``cpu_op`` (any other host event), ``kernel`` (a
    kernel, copy or memset: any device event that is not a device-side
    copy of a host range) and ``gpu_user_annotation``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        annotation = e.name().startswith("nsbench.") or (
            hasattr(e, "is_user_annotation") and e.is_user_annotation())
        on_host = e.device_type() == DeviceType.CPU
        if on_host:
            act = "user_annotation" if annotation else "cpu_op"
        else:
            act = "gpu_user_annotation" if annotation else "kernel"
        out.append((e.name(), act, start, start + e.duration_ns(),
                    e.start_thread_id()))
    return out


def summarize(prof) -> Optional[TraceSummary]:
    """The window's device time, busy time, top operations and idle gaps;
    None where the trace holds no window range or no device activity."""
    return summarize_events(_events(prof))


def summarize_events(events) -> Optional[TraceSummary]:
    windows = [e for e in events if e[0] == WINDOW
               and e[1] == "user_annotation"]
    if not windows:
        return None
    _, _, w0, w1, main = windows[0]
    dev = sorted((max(s, w0), min(t, w1), name)
                 for name, act, s, t, _ in events
                 if act == "kernel" and t > w0 and s < w1)
    if not dev:
        return None
    by_name: Dict[str, float] = defaultdict(float)
    busy = total = 0.0
    gaps = []
    cur_s, cur_t = w0, w0
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-9
        total += (t - s) * 1e-9
        if s > cur_t:
            busy += (cur_t - cur_s) * 1e-9
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += (cur_t - cur_s) * 1e-9
    if w1 > cur_t:
        gaps.append((cur_t, w1))
    idle = _name_gaps(gaps, [e for e in events if e[4] == main
                             and e[1] in ("cpu_op", "user_annotation")
                             and e[3] > w0 and e[2] < w1])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy,
                        device_sum_s=total, device_ops=top_ops,
                        idle_gaps=idle)


def _name_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds summed by the host activity at each gap's middle."""
    host = sorted(host, key=lambda e: (e[2], -e[3]))
    starts = [e[2] for e in host]
    parent = [-1] * len(host)
    stack: List[int] = []
    for i, (_, _, s, t, _) in enumerate(host):
        while stack and host[stack[-1]][3] <= s:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    total: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0 and host[j][3] <= mid:
            j = parent[j]
        op = span = None
        while j >= 0 and span is None:
            name = host[j][0]
            if name.startswith("nsbench."):
                span = name
            else:
                op = name  # ends as the outermost operator under the span
            j = parent[j]
        label = " > ".join(x for x in (span, op) if x) or "host (no range)"
        total[label] += (g1 - g0) * 1e-9
    return sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
