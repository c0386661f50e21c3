"""proj_roofline: the projection kernel's least time on the H100
(``roofline.projection`` at the configuration's L, R, K) over its mean
device time per launch, % (device trace). None where it never ran."""
from chipbench import roofline, tracing


def read(rec):
    c = rec["config"]
    return tracing.roofline_pct(rec, "proj_sortscan_kernel",
                                roofline.projection(c["L"], c["R"], c["K"]))
