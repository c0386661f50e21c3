"""The port's roofline (``repro_torch.analysis.roofline``) against the
reference's and against the bounds ``chip_smoke.py`` printed before they
moved into the package.

- ``model_flops`` bit for bit for every (arch x shape) cell;
- ``dryrun_summary`` and ``hbm_traffic`` bit for bit on the same records;
- each ``roofline`` term the reference's times the ratio of the two
  packages' peaks, and ``dominant`` the largest of those terms;
- ``kernel_bound``, ``flash_bound`` and ``flash_bwd_bound`` equal, bit for
  bit, to what the formulas of ``chip_smoke.py`` at commit 92e3792 give at
  every shape of PERF.md's kernel table (``PINNED_*`` below, printed by
  those formulas);
- ``collective_bytes`` against counts worked by hand on two small meshes.
"""
import dataclasses

import pytest

from repro.analysis import roofline as ref_rl
from repro.configs import base as ref_configs
from repro.configs import shapes as ref_shapes
from repro_torch.analysis import roofline as rl
from repro_torch.configs import base as configs
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, ShapeConfig, cells
from repro_torch.train.meshctx import make_mesh

# chip_smoke.py at 92e3792: bound(oga_bytes, proj_ops + 16 N L) (float64
# rate), bound(proj_bytes, proj_ops); the bisect rows with 20 iterations at
# the float32 rate, the projection's on n_need binding rows
PINNED_OGA_SORTSCAN = {
    (96, 257): (0.00017732776119402986, "bytes"),
    (96, 4096): (0.002817642985074627, "bytes"),
    (384, 4): (1.3296716417910448e-05, "bytes"),
    (768, 10): (5.960597014925373e-05, "bytes"),
    (768, 40): (0.0002246686567164179, "bytes"),
    (768, 90): (0.0004997731343283581, "bytes"),
    (1024, 6): (5.0130149253731346e-05, "bytes"),
    (2048, 6): (0.00010026029850746269, "bytes"),
    (6144, 100): (0.00443835223880597, "bytes"),
    (12288, 10): (0.0009536955223880596, "bytes"),
    (16384, 6): (0.0008020823880597015, "bytes"),
    (49152, 10): (0.0038147820895522385, "bytes"),
    (196608, 100): (0.14202727164179105, "bytes"),
    (786432, 100): (0.5681090865671642, "bytes"),
}
PINNED_PROJ_SORTSCAN = {
    (96, 257): (0.00016339200000000002, "operations"),
    (96, 4096): (0.0019313844705882352, "operations"),
    (384, 4): (9.035294117647059e-06, "operations"),
    (768, 10): (3.759761194029851e-05, "bytes"),
    (768, 40): (0.00014763940298507465, "bytes"),
    (768, 90): (0.0003310423880597015, "bytes"),
    (1024, 6): (3.056716417910448e-05, "bytes"),
    (2048, 6): (6.113432835820896e-05, "bytes"),
    (6144, 100): (0.002941783880597015, "bytes"),
    (12288, 10): (0.0006015617910447761, "bytes"),
    (16384, 6): (0.0004890746268656717, "bytes"),
    (49152, 10): (0.0024062471641791046, "bytes"),
    (196608, 100): (0.09413708417910448, "bytes"),
    (786432, 100): (0.3765483367164179, "bytes"),
}
PINNED_OGA_BISECT = {
    (768, 10): (5.960597014925373e-05, "bytes"),
    (1024, 6): (5.0130149253731346e-05, "bytes"),
    (2048, 6): (0.00010026029850746269, "bytes"),
    (6144, 100): (0.00443835223880597, "bytes"),
    (12288, 10): (0.0009536955223880596, "bytes"),
    (16384, 6): (0.0008020823880597015, "bytes"),
    (49152, 10): (0.0038147820895522385, "bytes"),
}
PINNED_PROJ_BISECT = {  # (N, L, n_need)
    (96, 257, 0): (0.0001179510447761194, "bytes"),
    (96, 4096, 50): (0.001878161194029851, "bytes"),
    (768, 10, 300): (3.759761194029851e-05, "bytes"),
    (6144, 100, 5000): (0.002941783880597015, "bytes"),
}
# flash_bound(B, S, H, G, hd, window, 2) and (.., 4, FP32_OPS_PER_S)
PINNED_FLASH = {
    ((1, 4096, 24, 24, 64), 0, "bf16"): (0.05212557175328615, "operations"),
    ((1, 4096, 24, 24, 64), 0, "f32"): (0.7694356785671642, "operations"),
    ((1, 4096, 25, 5, 64), 1024, "bf16"): (0.02375265844287159, "operations"),
    ((1, 4096, 25, 5, 64), 1024, "f32"): (0.3506176, "operations"),
    ((1, 4096, 28, 4, 128), 0, "bf16"): (0.12162633409100101, "operations"),
    ((1, 4096, 28, 4, 128), 0, "f32"): (1.7953499166567164, "operations"),
    ((1, 4096, 48, 8, 128), 0, "bf16"): (0.2085022870131446, "operations"),
    ((1, 4096, 48, 8, 128), 0, "f32"): (3.077742714268657, "operations"),
    ((1, 4096, 64, 8, 112), 0, "bf16"): (0.24325266818200203, "operations"),
    ((1, 4096, 64, 8, 112), 0, "f32"): (3.590699833313433, "operations"),
    ((1, 8192, 32, 16, 128), 0, "bf16"): (0.555938243429727, "operations"),
    ((1, 8192, 32, 16, 128), 0, "f32"): (8.206312279880596, "operations"),
    ((1, 8192, 32, 16, 128), 4096, "bf16"): (0.4169367187542973, "operations"),
    ((1, 8192, 32, 16, 128), 4096, "f32"): (6.154483803701492, "operations"),
    ((2, 128, 4, 2, 64), 0, "bf16"): (0.00011737791044776119, "bytes"),
    ((2, 128, 4, 2, 64), 0, "f32"): (0.00025236250746268657, "operations"),
}
# flash_bwd_bound(..., 2, BF16) / (..., 4, FP32) / (..., 4, FP32, 7 products)
PINNED_FLASH_BWD = {
    ((1, 1024, 32, 32, 80), 0, "bf16"): (0.013584307381193124, "operations"),
    ((1, 1024, 32, 32, 80), 0, "f32"): (0.2005205970149254, "operations"),
    ((1, 1024, 32, 32, 80), 0, "ffma7"): (0.28072883582089553, "operations"),
    ((1, 8192, 32, 16, 128), 0, "bf16"): (1.3898456085743174, "operations"),
    ((1, 8192, 32, 16, 128), 0, "f32"): (20.51578069970149, "operations"),
    ((1, 8192, 32, 16, 128), 0, "ffma7"): (28.72209297958209, "operations"),
    ((1, 8192, 32, 16, 128), 4096, "bf16"): (1.0423417968857431, "operations"),
    ((1, 8192, 32, 16, 128), 4096, "f32"): (15.386209509253732, "operations"),
    ((1, 8192, 32, 16, 128), 4096, "ffma7"): (21.540693312955224, "operations"),
    ((4, 4096, 32, 32, 80), 0, "bf16"): (0.8687595292214357, "operations"),
    ((4, 4096, 32, 32, 80), 0, "f32"): (12.823927976119403, "operations"),
    ((4, 4096, 32, 32, 80), 0, "ffma7"): (17.953499166567163, "operations"),
}
KERNEL_BWD_PRODUCTS = 7  # chip_smoke.py's: the kernels run seven products


def _records():
    """Dry-run records of every status, with terms on every side."""
    ok = {
        "arch": "a", "shape": "train_4k", "status": "ok", "kind": "train",
        "memory": {"argument_size_in_bytes": 3.0e9, "output_size_in_bytes": 2.5e9,
                   "temp_size_in_bytes": 7.25e9},
        "cost": {"flops": 4.2e14, "bytes accessed": 1.0e12},
        "collectives": {"all-gather": {"bytes": 2.0e9, "count": 10},
                        "all-reduce": {"bytes": 5.0e8, "count": 3}},
        "model_flops": 6.0e16,
    }
    small = dict(ok, shape="decode_32k", kind="decode", cost={"flops": 1.0e9},
                 memory={"argument_size_in_bytes": 8.0e10}, collectives={})
    coll = dict(ok, shape="prefill_32k", kind="prefill", cost={"flops": 1.0e12},
                collectives={"reduce-scatter": {"bytes": 9.0e11, "count": 1}})
    out = []
    for r, n in ((ok, 256), (small, 256), (coll, 512), (dict(ok, variant="dots"), 256)):
        r = dict(r)
        r["roofline"] = ref_rl.roofline(r, n)
        out.append((r, n))
    out.append(({"arch": "b", "shape": "long_500k", "status": "skipped", "reason": "dense"}, 256))
    out.append(({"arch": "c", "shape": "train_4k", "status": "error", "reason": "boom"}, 256))
    return out


def test_model_flops_equal_the_reference_for_every_cell():
    names = configs.names()
    assert names == ref_configs.names()
    for cfg, shape, _, _ in cells(names):
        want = ref_rl.model_flops(ref_configs.get(cfg.name), ref_shapes.SHAPES[shape.name])
        assert rl.model_flops(cfg, shape) == want, (cfg.name, shape.name)


def test_dryrun_summary_and_hbm_traffic_equal_the_reference():
    for rec, _ in _records():
        assert rl.dryrun_summary(rec) == ref_rl.dryrun_summary(rec)
        assert rl.hbm_traffic(rec.get("memory", {})) == ref_rl.hbm_traffic(rec.get("memory", {}))


def test_roofline_terms_are_the_reference_scaled_by_the_peaks():
    scale = {"t_compute_s": ref_rl.PEAK_FLOPS / rl.PEAK_FLOPS,
             "t_memory_s": ref_rl.HBM_BW / rl.HBM_BW,
             "t_collective_s": ref_rl.ICI_BW / rl.NVLINK_BW}
    for rec, n in _records():
        if rec["status"] != "ok":
            continue
        got, want = rl.roofline(rec, n), ref_rl.roofline(rec, n)
        for key, s in scale.items():
            assert got[key] == pytest.approx(want[key] * s, rel=1e-12), key
        for key in ("hlo_flops_global", "hbm_traffic_per_device", "collective_bytes_per_device"):
            assert got[key] == want[key]
        terms = {"compute": want["t_compute_s"] * scale["t_compute_s"],
                 "memory": want["t_memory_s"] * scale["t_memory_s"],
                 "collective": want["t_collective_s"] * scale["t_collective_s"]}
        assert got["dominant"] == max(terms, key=terms.get)


def test_peaks_are_the_h100_data_sheet():
    assert (rl.HBM_BW, rl.FP64_FLOPS, rl.FP32_FLOPS, rl.PEAK_FLOPS, rl.NVLINK_BW) == (
        3.35e12, 34e12, 67e12, 989e12, 450e9)
    assert rl.kernel_peaks(None) == {"peak_bytes_s": 3.35e12, "peak_flops_s": 67e12,
                                     "calibrated": False}
    host = rl.kernel_peaks("cpu")
    assert host["calibrated"] and host["peak_bytes_s"] > 0 and host["peak_flops_s"] > 0
    assert rl.kernel_rate("sortscan") == rl.FP64_FLOPS
    assert rl.kernel_rate("bisect") == rl.FP32_FLOPS


@pytest.mark.parametrize("kernel,table", [("oga_step", PINNED_OGA_SORTSCAN),
                                          ("proj", PINNED_PROJ_SORTSCAN)])
def test_sortscan_bounds_equal_the_harness_formulas(kernel, table):
    for (n, l), want in table.items():
        assert rl.kernel_bound(kernel, n, l) == want, (n, l)


def test_bisect_bounds_equal_the_harness_formulas():
    for (n, l), want in PINNED_OGA_BISECT.items():
        assert rl.kernel_bound("oga_step", n, l, method="bisect", iters=20) == want, (n, l)
    for (n, l, need), want in PINNED_PROJ_BISECT.items():
        assert rl.kernel_bound("proj", n, l, method="bisect", iters=20, n_need=need) == want


def test_flash_bounds_equal_the_harness_formulas():
    for (shape, window, dt), want in PINNED_FLASH.items():
        args = (2,) if dt == "bf16" else (4, rl.FP32_FLOPS)
        assert rl.flash_bound(*shape, window, *args) == want, (shape, window, dt)
    for (shape, window, dt), want in PINNED_FLASH_BWD.items():
        args = {"bf16": (2, rl.PEAK_FLOPS), "f32": (4, rl.FP32_FLOPS),
                "ffma7": (4, rl.FP32_FLOPS, KERNEL_BWD_PRODUCTS)}[dt]
        assert rl.flash_bwd_bound(*shape, window, *args) == want, (shape, window, dt)


def test_flash_flops_count_visible_pairs():
    assert rl.flash_pairs(5, 0) == 15
    assert rl.flash_pairs(5, 2) == 1 + 2 + 2 + 2 + 2
    assert rl.flash_flops(2, 5, 3, 16, 0) == 4 * 16 * 3 * 2 * 15
    assert rl.flash_flops(2, 5, 3, 16, 2, rl.BWD_PRODUCTS) == 10 * 16 * 3 * 2 * 9


def test_kernel_roofline_fractions():
    rec = rl.kernel_roofline("oga_step", 768, 10, 6.72)
    cost = rl.kernel_cost_model("oga_step", 768, 10)
    assert rec["model_bytes"] == cost["bytes"] == 4 * 768 * (6 * 10 + 5)
    assert rec["frac_peak_bytes"] == pytest.approx(cost["bytes"] / 6.72e-6 / rl.HBM_BW)
    assert rec["peak_flops_s"] == rl.FP64_FLOPS and not rec["peaks_calibrated"]
    assert rl.kernel_roofline("proj", 768, 10, 6.0, method="bisect")["peak_flops_s"] \
        == rl.FP32_FLOPS
    with pytest.raises(ValueError):
        rl.kernel_cost_model("proj", 8, 8, method="rows")


# ------------------------------------------------------------ collectives --
# One dense layer, float32, every dim small enough to place by hand
TINY = ArchConfig(name="tiny", family="dense", n_layers=1, d_model=8, n_heads=2, n_kv=2,
                  d_ff=16, vocab=32, head_dim=4, param_dtype="float32",
                  compute_dtype="float32")


def test_collectives_by_hand_on_data_2_model_2():
    """(data 2, model 2), 4 x 8 tokens, so 16 a position. Placement
    (auto_pspec: 'model' on the largest dim, then 'data'): embed (32, 8)
    (model, data), 256 B a shard; the four attention matrices (8, 8)
    (model, data), 64 B; gate, up (8, 16) (data, model), 128 B; down
    (16, 8) (model, data), 128 B; unembed (8, 32) (data, model), 256 B;
    the three norms (model), 16 B.

    Train, remat "full" (a block's forward twice): all-gather every
    data-sharded leaf, a block's 3 times and embed / unembed twice:
    2 x 256 + 4 x 3 x 64 + 3 x 3 x 128 + 2 x 256 = 2944 B in 25;
    reduce-scatter each of them once, 2 x its shard: 512 + 4 x 128 +
    3 x 256 + 512 = 2304 B in 9; all-reduce: the norms' gradients (3 x 16
    B), and on 'model' the outputs of the products contracting over it
    (embed 16 x 8 x 4 = 512 once; wq, wk, wv, wo and down 512 twice
    each) and the input gradients of gate, up and unembed (512 each):
    48 + 512 + 5 x 1024 + 3 x 512 = 7216 B in 3 + 1 + 10 + 3 = 17.

    Prefill: one all-gather each (256 + 4 x 64 + 3 x 128 + 256 = 1152 B
    in 9), the forward all-reduces once (512 + 5 x 512 = 3072 B in 6)."""
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    got = rl.collective_bytes(TINY, ShapeConfig("t", 8, 4, "train"), mesh)
    assert got == {"all-gather": {"bytes": 2944, "count": 25},
                   "reduce-scatter": {"bytes": 2304, "count": 9},
                   "all-reduce": {"bytes": 7216, "count": 17}}
    got = rl.collective_bytes(TINY, ShapeConfig("p", 8, 4, "prefill"), mesh)
    assert got == {"all-gather": {"bytes": 1152, "count": 9},
                   "all-reduce": {"bytes": 3072, "count": 6}}


def test_collectives_by_hand_on_data_4():
    """(data 4, model 1): pure FSDP, every leaf on 'data' (its largest
    dim): embed (8, 8) 256 B a shard, norms 8 B, attention (2, 8) 64 B,
    gate / up (8, 4) and down (4, 8) 128 B, unembed (8, 8) 256 B. No
    tensor parallelism, no replicated gradient. Train: all-gather 2 x 256
    + 3 x (8 + 8) + 4 x 3 x 64 + 3 x 3 x 128 + 2 x 8 + 2 x 256 = 3008 B in
    33; reduce-scatter 4 x each shard: 4 x (256 + 8 + 4 x 64 + 8 + 3 x 128
    + 8 + 256) = 4704 B in 12 (one a leaf). Without remat, a block's leaves gather
    twice: 3008 - (2 x 8 + 4 x 64 + 3 x 128) = 2352 B in 33 - 9 = 24."""
    mesh = make_mesh((4, 1), ("data", "model"), ["cpu"] * 4)
    shape = ShapeConfig("t", 8, 4, "train")
    assert rl.collective_bytes(TINY, shape, mesh) == {
        "all-gather": {"bytes": 3008, "count": 33},
        "reduce-scatter": {"bytes": 4704, "count": 12}}
    no_remat = dataclasses.replace(TINY, remat=False)
    assert rl.collective_bytes(no_remat, shape, mesh)["all-gather"] == {"bytes": 2352,
                                                                        "count": 24}


def test_collectives_of_every_production_cell_are_well_formed():
    """Every applicable cell of the ten configs on the single-pod mesh:
    non-negative integer bytes, a count beside every kind."""
    mesh = make_mesh((16, 16), ("data", "model"), ["meta"] * 256)
    for cfg, shape, ok, _ in cells(configs.names()):
        if not ok:
            continue
        got = rl.collective_bytes(cfg, shape, mesh)
        assert set(got) <= {"all-gather", "reduce-scatter", "all-reduce"}, got
        for ent in got.values():
            assert ent["bytes"] >= 0 and ent["count"] >= 1, (cfg.name, shape.name, got)
        assert ("reduce-scatter" in got) == (shape.kind == "train"), (cfg.name, shape.name)
    assert SHAPES["train_4k"].kind == "train"
