"""oga_fused_roofline: the fused OGA step's least time on the H100
(``roofline.fused_step`` at the configuration's L, R, K) over its mean
device time per launch, % (device trace). None where it never ran."""
from chipbench import roofline, tracing


def read(rec):
    c = rec["config"]
    return tracing.roofline_pct(rec, "oga_step_sortscan_kernel",
                                roofline.fused_step(c["L"], c["R"], c["K"]))
