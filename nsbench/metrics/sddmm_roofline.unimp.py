"""sddmm_roofline.unimp: the least time the forwards' SDDMMs could take on
the chip (per layer, one call over its heads: each head's Q and K read
once, the pattern once, each head's values written once at 3.35 TB/s, or
2·H·nnz·C at the TF32 rate, whichever is longer; ``counts_attention``) over the device time of the B4 and B5
kernels in the window, in percent.  The kernels' time is read from the
program's ``sddmm_tiles`` (B4) and ``sddmm_walk`` (B5) stages: a timed
stage's device time times the stages."""
from nsbench import attention_spans


def read(run):
    c = run.counters
    kernels_s = attention_spans.window_device_s(("sddmm_walk",
                                                 "sddmm_tiles"))
    if not kernels_s or not c.get("forwards") or "sddmm_bound_s" not in c:
        return None
    return 100.0 * c["sddmm_bound_s"] * c["forwards"] / kernels_s
