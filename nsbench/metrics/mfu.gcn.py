"""mfu.gcn: the epoch's model FLOPs (every matmul and SpMM of the forward
and the backward) over the mean epoch time of the window times the chip's
TF32 peak, in percent."""
from nsbench import counts


def read(run):
    c = run.counters
    if not c.get("epochs") or "epoch_flops" not in c:
        return None
    epoch_s = c["window_s"] / c["epochs"]
    return (100.0 * c["epoch_flops"] / epoch_s
            / counts.PEAKS["tf32_flops_per_s"])
