"""``"kind": "spmm_closed_loop"``: repeated ``sparse.spmm(A, B)`` over a
pool of seeded right-hand sides, with at most ``in_flight`` calls on the
device.  A mix gives ``n_rhs`` (B's columns), ``pool``, ``in_flight``,
``warmup_rounds`` and ``check_outputs`` (the outputs kept, a reservoir
sample over the window's calls drawn from the seed, every entry of each
compared).

``control`` is the TF32 control's reading of the same number, and
``FAULTS`` the faults a run of this kind can have:

- ``stale``: every call after the first returns the previous call's
  output (an answer left unchanged);
- ``half_rows``: the second half of C's rows left at zero (half of the
  work left out);
- ``altered``: one entry of C changed by +1 where ``spmm`` returns it.
"""
import random
import time
from collections import deque
from typing import Dict, List, Tuple

import torch

from nsbench import counts, drive, faults, reference


def rhs_pool(mix: dict, k: int, seed: int,
             device: torch.device) -> List[torch.Tensor]:
    """The mix's pool of right-hand sides, (k, n_rhs) each, standard
    normal from the seed, in one draw on the device."""
    pool = torch.randn((mix["pool"], k, mix["n_rhs"]),
                       generator=drive.generator(device, seed + 1),
                       device=device)
    return list(pool.unbind(0))


def _spmm():
    import repro_torch.sparse as sp

    return sp.spmm


class Load(drive.Load):

    def setup(self) -> None:
        self.prepare()
        self.pool = rhs_pool(self.mix, self.counters["k"], self.seed,
                             self.device)
        self.counters["n_rhs"] = self.mix["n_rhs"]
        for _ in range(self.mix["warmup_rounds"]):
            for b in self.pool:
                _spmm()(self.a, b)
        drive.sync(self.device)

    def window(self, seconds: float) -> Dict[str, float]:
        spmm = _spmm()
        pool, depth = self.pool, self.mix["in_flight"]
        keep = self.mix["check_outputs"]
        pick = random.Random(self.seed)
        self.kept: List[Tuple[int, torch.Tensor]] = []
        inflight: deque = deque()
        cuda = self.device.type == "cuda"
        calls = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            b = calls % len(pool)
            with self.rec.span("dispatch"):
                c = spmm(self.a, pool[b])
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                inflight.append(ev)
                if len(inflight) >= depth:
                    inflight.popleft().synchronize()
            # reservoir sample of the calls' outputs, uniform over all calls
            if calls < keep:
                self.kept.append((b, c))
            else:
                j = pick.randrange(calls + 1)
                if j < keep:
                    self.kept[j] = (b, c)
            calls += 1
        drive.sync(self.device)
        window_s = time.perf_counter() - t0
        self.attempted = calls
        flops = counts.spmm_flops(self.counters["nnz"], self.counters["n_rhs"])
        self.counters.update(calls=calls, window_s=window_s)
        return {"spmm_gflops": counts.gflops(flops, calls, window_s)}

    def check(self, limits: Dict[str, float]) -> Dict[str, float]:
        rows, cols, vals, shape = self.coo
        op = reference.CooOperator(rows, cols, vals, shape, self.device)
        worst = 0.0
        for b in sorted({b for b, _ in self.kept}):
            errs, _ = reference.componentwise_errors(
                op, self.pool[b], [c for bb, c in self.kept if bb == b])
            worst = max([worst, *errs])
            self.failed += sum(e > limits["spmm_err"] for e in errs)
        return {"spmm_err": worst}


def control(bench, cfg: dict, mix: dict, seed: int,
            device: torch.device) -> Dict[str, float]:
    """The TF32 control's ``spmm_err`` over every B of the seed's pool."""
    rows, cols, vals, shape, _ = drive.build_graph(bench, cfg, seed, device)
    op = reference.CooOperator(rows, cols, vals, shape, device)
    worst = 0.0
    for b in rhs_pool(mix, shape[1], seed, device):
        _, ctl = reference.componentwise_errors(op, b, [], tf32_control=True)
        worst = max(worst, ctl)
    return {"spmm_err": worst}


def _fault(kind: str):
    import repro_torch.sparse as sp

    real = sp.spmm
    last = []

    def stale(a, b, **kw):
        if not last:
            last.append(real(a, b, **kw))
        return last[0]

    def half_rows(a, b, **kw):
        c = real(a, b, **kw)
        c[c.shape[0] // 2:] = 0
        return c

    def altered(a, b, **kw):
        c = real(a, b, **kw)
        # out of place, so that autograd's saved outputs stay as they were
        return c + faults.one_hot_like(c)

    return faults.patched(sp, "spmm", {"stale": stale, "half_rows": half_rows,
                                       "altered": altered}[kind])


FAULTS = {k: (lambda k=k: _fault(k)) for k in ("stale", "half_rows",
                                                "altered")}
