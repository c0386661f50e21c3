"""The kernels' work at the cells' shape, counted from the problem."""
import json
import math
from pathlib import Path

import pytest

from chipbench import roofline

ROOT = Path(__file__).resolve().parents[1]
CFGS = [json.loads(p.read_text()) for p in sorted((ROOT / "chipbench" / "configs").glob("*.json"))]


# per configuration: (L, R, K), the fused step's bytes and operations, the
# projection's bytes and operations, counted by hand
COUNTS = {
    # lanes 614400; rows R K = 6144 of L = 100: a sort 100 x 7, a scan 200
    "ogasched-r1024": ((100, 1024, 6),
                       4 * (2 * 614400 + 102400 + 2 * 6144 + 600 + 100 + 12),
                       16 * 614400 + 6144 * 900,
                       4 * (2 * 614400 + 102400 + 6144 + 600), 6144 * 900),
    # lanes 7680; rows 768 of L = 10: a sort 10 x 4, a scan 20
    "lifecycle-r128": ((10, 128, 6),
                       4 * (2 * 7680 + 1280 + 2 * 768 + 60 + 10 + 12),
                       16 * 7680 + 768 * 60,
                       4 * (2 * 7680 + 1280 + 768 + 60), 768 * 60),
}


@pytest.mark.parametrize("cfg", CFGS, ids=[c["name"] for c in CFGS])
def test_fused_step_counts_at_the_cell(cfg):
    shape, nbytes, ops, _, _ = COUNTS[cfg["name"]]
    assert (cfg["L"], cfg["R"], cfg["K"]) == shape
    b = roofline.fused_step(*shape)
    # y in and out, mask, c and alpha, a, x, beta and kinds, float32
    assert b["bytes"] == nbytes
    # 16 a lane, then per (r, k) row a sort and a scan of L
    assert b["ops"] == ops
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(nbytes / 3.35e12, rel=1e-12)


@pytest.mark.parametrize("cfg", CFGS, ids=[c["name"] for c in CFGS])
def test_projection_counts_at_the_cell(cfg):
    shape, _, _, nbytes, ops = COUNTS[cfg["name"]]
    b = roofline.projection(*shape)
    # proposal and output, mask, residual capacity, a
    assert b["bytes"] == nbytes
    assert b["ops"] == ops
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(b["bytes"] / 3.35e12, rel=1e-12)


def test_operations_bound_a_tiny_row_set():
    """At one wide row the sort outweighs the bytes: the bound says so."""
    b = roofline.projection(4096, 1, 1)
    assert b["ops"] == 4096 * math.ceil(math.log2(4096)) + 2 * 4096
    assert b["bound_s"] == max(b["bytes"] / 3.35e12, b["ops"] / 67e12)


def test_a_share_never_passes_100_for_a_time_at_or_above_the_bound():
    from chipbench import tracing

    b = roofline.fused_step(100, 1024, 6)
    rec = {"trace": {"device_ops": [("repro_torch::oga_step_sortscan_kernel<32, 8>", "kernel",
                                     0.0, 1e6 * b["bound_s"])]}}
    assert tracing.roofline_pct(rec, "oga_step_sortscan_kernel", b) == pytest.approx(100.0)
    assert tracing.roofline_pct(rec, "proj_sortscan_kernel", b) is None
