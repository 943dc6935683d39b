"""spmm_roofline: the least time one SpMM could take on the chip (A as
CSR, B and C once, or 2·nnz·N at the TF32 rate, whichever is longer) over
the device time of everything the window's calls launched, per call, in
percent.  Read from the profiler's trace of the window."""
from nsbench import counts


def read(run):
    t, c = run.trace, run.counters
    if t is None or not t.device_sum_s or not c.get("calls"):
        return None
    bound = counts.spmm_bound_s(c["m"], c["k"], c["nnz"], c["n_rhs"])
    return 100.0 * bound * c["calls"] / t.device_sum_s
