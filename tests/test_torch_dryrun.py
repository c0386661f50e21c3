"""``repro_torch.launch.dryrun`` against the reference and against counts
worked from the configs' dimensions.

- Every applicable (arch x shape) cell on both production meshes (256 and
  512 positions): argument bytes per position equal to the reference's,
  computed in a JAX subprocess with 512 host devices from
  ``jax.eval_shape`` of its specs, its ``param_pspecs``, ``batch_pspecs``
  and ``cache_pspecs`` and ``NamedSharding.shard_shape`` (nothing
  compiled). Skipped cells carry the reference's ``applicable`` reason.
- The reduced config of every family: the meta run's FLOPs equal a count
  of the model's products written here from the config (prefill and a
  train step), and its temporaries lie within TEMP_RTOL above a count of
  the tensors live at the peak.
- ``LiveBytes`` on hand cases of views and frees: exact.
- The CLI: ``--sched`` and one model cell write records under the keys
  ``analysis.report`` and ``sched.job_manager.templates_from_dryrun``
  read, and both read them. The model cell is stablelm-3b's train_4k at
  full width with its depth cut to 2 layers (``--override n_layers=2``),
  which keeps full-width runs of every layer out of this suite.
"""
import dataclasses
import json
import math

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_oracle import run_oracle
from repro_torch.analysis import report
from repro_torch.configs import base as configs
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import PATCH_DIM
from repro_torch.models.moe import capacity
from repro_torch.sched.job_manager import templates_from_dryrun

# the meta run's temporaries above the hand count of the tensors live at
# the peak: the rest are small index and mask tensors and, in the dense
# layers, the K and V products before and after the rotation
TEMP_RTOL = 0.2

ORACLE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding
from repro.configs import base as configs
from repro.configs.shapes import SHAPES, applicable
from repro.optim import AdamWConfig
from repro.train import sharding as shd
from repro.train import train_step as ts
from repro.models import model as M

def nbytes(tree, specs, mesh):
    leaves = jax.tree_util.tree_leaves(tree)
    pspecs = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return sum(int(np.prod(NamedSharding(mesh, p).shard_shape(s.shape))) * s.dtype.itemsize
               for s, p in zip(leaves, pspecs))

devs = np.array(jax.devices())
meshes = {"16x16": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
          "2x16x16": Mesh(devs[:512].reshape(2, 16, 16), ("pod", "data", "model"))}
opt = AdamWConfig(state_dtype="bfloat16")
out = {}
for arch in configs.names():
    cfg = configs.get(arch)
    pshapes = M.param_shapes(cfg)
    oshapes = ts.opt_specs(cfg, opt)
    for name, shape in SHAPES.items():
        ok, reason = applicable(cfg, shape)
        for mname, mesh in meshes.items():
            key = f"{arch}/{name}/{mname}"
            if not ok:
                out[key] = {"status": "skipped", "reason": reason}
                continue
            pspecs = shd.param_pspecs(pshapes, mesh)
            specs = ts.input_specs(cfg, shape)
            parts = {"params": nbytes(pshapes, pspecs, mesh)}
            if shape.kind == "train":
                parts["opt_state"] = (nbytes(oshapes["m"], pspecs, mesh)
                                      + nbytes(oshapes["v"], pspecs, mesh)
                                      + nbytes(oshapes["step"], jax.sharding.PartitionSpec(), mesh))
            if shape.kind in ("train", "prefill"):
                parts["inputs"] = nbytes(specs["batch"],
                                         shd.batch_pspecs(specs["batch"], mesh, pure_dp=cfg.pure_dp),
                                         mesh)
            else:
                tok = shd.batch_pspecs({"t": specs["tokens"]}, mesh)["t"]
                parts["inputs"] = (nbytes(specs["cache"], shd.cache_pspecs(specs["cache"], mesh), mesh)
                                   + nbytes(specs["tokens"], tok, mesh)
                                   + nbytes(specs["pos"], jax.sharding.PartitionSpec(), mesh))
            out[key] = {"status": "ok", "parts": parts}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "ref.json"
    run_oracle(ORACLE, 512, path)
    with open(path) as f:
        return json.load(f)


MESHES = {"16x16": False, "2x16x16": True}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_argument_bytes_equal_the_reference_on_every_cell(reference, mesh_name):
    multi = MESHES[mesh_name]
    mesh = make_production_mesh(multi, devices=["meta"] * (512 if multi else 256))
    n_ok = 0
    for arch in configs.names():
        cfg = configs.get(arch)
        for name, shape in SHAPES.items():
            want = reference[f"{arch}/{name}/{mesh_name}"]
            if want["status"] == "skipped":
                rec = dryrun.run_cell(arch, name, multi, mesh=mesh)
                assert rec["status"] == "skipped" and rec["reason"] == want["reason"]
                assert rec["mesh"] == mesh_name and rec["n_devices"] == mesh.devices.size
                continue
            assert dryrun.argument_parts(cfg, shape, mesh) == want["parts"], (arch, name)
            n_ok += 1
    assert n_ok == 32  # 40 cells less the eight full-attention long_500k ones


# ------------------------------------------------------------- hand counts --
def _windows(cfg):
    if cfg.window is None:
        return [0] * cfg.n_layers
    if cfg.window_pattern == 0:
        return [cfg.window] * cfg.n_layers
    return [0 if i % cfg.window_pattern == cfg.window_pattern - 1 else cfg.window
            for i in range(cfg.n_layers)]


def _pairs(S, w):
    return sum(min(q + 1, w) if w > 0 else q + 1 for q in range(S))


def hand_flops(cfg, B, S, kind):
    """FLOPs of the products of a prefill (last-token logits) or a train
    step. Train: a block's products run forward and twice in the backward
    pass, attention's forward at 4 hd a visible pair and its gradient at
    10 hd, the loss head three times, the vlm's patch projection twice
    (its input needs no gradient). Remat "full" runs the block forward
    again in the backward pass, attention included, up to the last tensor
    the backward needs: torch's checkpoint stops there, so the block's
    last product (the MLP's or the shared expert's down projection, or
    the SSM's out_proj) is not run again; a routed MoE layer's combine
    keeps its expert outputs, so all of it runs."""
    T, d = B * S, cfg.d_model
    block, attn, last = 0, 0, 0
    for w in _windows(cfg):
        if cfg.has_attn:
            hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
            block += 2 * T * d * (hq + 2 * hkv) + 2 * T * hq * d
            attn += 4 * cfg.hd * cfg.n_heads * B * _pairs(S, w)
        if cfg.has_ssm:
            di, n, h, p, q = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_chunk)
            nc = S // q
            block += 2 * T * d * (2 * di + 2 * n + h) + 2 * T * di * d
            # C B^T, (L * scores) x, (x decay)^T B, C h^T
            block += 2 * B * nc * q * q * n + 2 * B * nc * h * q * q * p \
                + 2 * B * nc * h * p * q * n + 2 * B * nc * h * q * n * p
            last = 2 * T * di * d
        if cfg.n_experts:
            E, k, f = cfg.n_experts, cfg.top_k, cfg.d_expert
            C = capacity(T, k, E, cfg.capacity_factor)
            block += 2 * T * d * E + 6 * E * C * d * f + 6 * T * d * f * cfg.n_shared_experts
            last = 2 * T * f * cfg.n_shared_experts * d
        elif cfg.d_ff:
            block += 6 * T * d * cfg.d_ff
            last = 2 * T * cfg.d_ff * d
    patches = 2 * B * cfg.n_patches * PATCH_DIM * d if cfg.family == "vlm" else 0
    if kind == "prefill":
        return block + attn + 2 * B * d * cfg.vocab + patches
    text = S - cfg.n_patches
    total = 3 * block + attn + attn * 10 // 4 + 3 * 2 * B * text * d * cfg.vocab + 2 * patches
    if cfg.remat and cfg.remat_policy == "full":
        total += block - cfg.n_layers * last + attn
    return total


def hand_prefill_temp(cfg, B, S):
    """float32 bytes live at a prefill's peak, in the first layer whose
    caches exist: the embedded input, the stacked caches, and that
    layer's working set. Attention: its normed input, output, the
    residual sum and the MLP's normed input (4 T d), this layer's K and V
    (2 T G hd), and the MLP's three (T, d_ff) tensors or the MoE layer's
    dispatch buffer and expert outputs (2 E C d) and two (E, C, f)
    intermediates. SSM (peak at the end of the SSD): two copies of
    in_proj's output, the convolved (T, di + 2 n), and nine of the SSD's
    (B, S, H, P)-sized tensors (the reduced configs' chunk, head dim and
    state are all 16, so the decays and states are that size too)."""
    T, d, L = B * S, cfg.d_model, cfg.n_layers
    total = T * d                                     # embedded input
    if cfg.has_attn:
        total += 2 * L * T * cfg.n_kv * cfg.hd        # stacked K and V
    if cfg.has_ssm:
        di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
        total += L * B * h * p * n + L * B * (cfg.conv_kernel - 1) * (di + 2 * n)
        ssd = 2 * T * (2 * di + 2 * n + h) + T * (di + 2 * n) + 9 * T * di
        total += T * d + T * d + ssd                  # x after layer 0, its norm
        if cfg.family == "hybrid":
            total += 2 * T * d + 2 * T * cfg.n_kv * cfg.hd
        return 4 * total
    total += 4 * T * d + 2 * T * cfg.n_kv * cfg.hd
    if cfg.n_experts:
        E, k, f = cfg.n_experts, cfg.top_k, cfg.d_expert
        C = capacity(T, k, E, cfg.capacity_factor)
        total += 2 * E * C * d + 2 * E * C * f
    else:
        total += 3 * T * cfg.d_ff
    return 4 * total


FAMILIES = ["stablelm-3b", "gemma2-27b", "dbrx-132b", "kimi-k2-1t-a32b", "mamba2-780m",
            "hymba-1.5b", "qwen2-vl-7b", "musicgen-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_run_flops_and_temporaries_of_the_reduced_configs(arch):
    cfg = configs.reduced(configs.get(arch))
    B, S = 2, 64
    pre = dryrun.meta_run(cfg, ShapeConfig("p", S, B, "prefill"))
    assert pre["flops"] == hand_flops(cfg, B, S, "prefill")
    hand = hand_prefill_temp(cfg, B, S)
    assert hand <= pre["temp_size_in_bytes"] <= (1 + TEMP_RTOL) * hand, \
        (pre["temp_size_in_bytes"], hand)
    train = dryrun.meta_run(cfg, ShapeConfig("t", S, B, "train"))
    assert train["flops"] == hand_flops(cfg, B, S, "train")
    no_remat = dataclasses.replace(cfg, remat=False)
    assert dryrun.meta_run(no_remat, ShapeConfig("t", S, B, "train"))["flops"] \
        == hand_flops(no_remat, B, S, "train")
    assert train["temp_size_in_bytes"] > pre["temp_size_in_bytes"]
    assert train["bytes_accessed"] > pre["bytes_accessed"] > 0


# --------------------------------------------------------------- LiveBytes --
def test_live_bytes_counts_flops_as_flop_counter_mode():
    """The tracker's one-pass FLOP count equals FlopCounterMode's over the
    same train step (a reduced MoE config: mm, bmm and both flash ops)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import model as M
    from repro_torch.train import train_step as ts

    cfg = configs.reduced(configs.get("kimi-k2-1t-a32b"))
    params = M.param_shapes(cfg)
    batch = ts.input_specs(cfg, ShapeConfig("t", 64, 2, "train"))["batch"]
    with FlopCounterMode(display=False) as counter:
        ts.value_and_grad(params, cfg, batch)
    with dryrun.LiveBytes() as live:
        ts.value_and_grad(params, cfg, batch)
    assert live.flops == counter.get_total_flops() > 0


def test_live_bytes_counts_views_once_and_frees_with_the_last_tensor():
    base = torch.empty(1000, device="meta")                  # made before: not counted
    with dryrun.LiveBytes() as live:
        a = torch.empty(256, device="meta")                  # 1024
        b = a.view(16, 16)                                    # a view: 0
        c = a * 2                                             # 1024
        base.add_(1.0)                                        # in place on an argument: 0
        v = base[:10]                                         # a view of an argument: 0
        assert (live.current, live.peak) == (2048, 2048)
        del a
        assert live.current == 2048                          # b still holds a's storage
        del b
        assert live.current == 1024
        d = torch.empty(512, dtype=torch.float64, device="meta")   # 4096
        assert (live.current, live.peak) == (5120, 5120)
        del c, d, v
        assert live.current == 0
        e = torch.empty(100, dtype=torch.bfloat16, device="meta")  # 200
        assert (live.current, live.peak) == (200, 5120)
        del e
    # bytes read and written by the operations that are not views: mul
    # reads 1024 and writes 1024, add_ reads and writes base's 4000
    assert live.bytes_accessed == 2048 + 8000


def test_live_bytes_sees_autograd_free_saved_tensors():
    x = torch.empty(1024, device="meta", requires_grad=True)
    with dryrun.LiveBytes() as live:
        y = x.exp()            # saved for the backward pass (4096)
        z = y.sum()            # 4
        del y
        assert live.current == 4096 + 4                      # autograd holds y
        (g,) = torch.autograd.grad(z, x)                     # dy = 4096, dx = 4096
        del z
        assert live.current == 4096                          # only g is left
    assert live.peak >= 4096 + 4 + 4096
    assert g.shape == x.shape


# --------------------------------------------------------------------- CLI --
def test_cli_records_feed_the_report_and_the_job_manager(tmp_path, capsys):
    out = tmp_path / "art"
    dryrun.main(["--sched", "--out", str(out)])
    dryrun.main(["--arch", "stablelm-3b", "--shape", "train_4k", "--override", "n_layers=2",
                 "--out", str(out)])
    dryrun.main(["--arch", "qwen2-72b", "--shape", "long_500k", "--out", str(out)])
    sched = json.loads((out / "ogasched-distributed__L100_R131072_K6__16x16.json").read_text())
    lm = json.loads((out / "stablelm-3b__train_4k__16x16.json").read_text())
    skipped = json.loads((out / "qwen2-72b__long_500k__16x16.json").read_text())
    keys = {"arch", "shape", "mesh", "n_devices", "kind", "status", "memory", "cost",
            "collectives", "roofline"}
    assert keys <= set(sched) and keys | {"model_flops", "n_params", "n_active_params"} <= set(lm)
    for rec in (sched, lm):
        assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                      "temp_size_in_bytes"}
        assert rec["memory"]["argument_size_in_bytes"] == sum(rec["argument_parts"].values())
        assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s", "t_collective_s",
                                        "dominant", "hlo_flops_global",
                                        "hbm_traffic_per_device",
                                        "collective_bytes_per_device"}
    assert skipped["status"] == "skipped" and "full-attention" in skipped["reason"]
    # the per-position §3.2 shard: R / 256 = 512 instances
    assert sched["argument_parts"] == dryrun.sched_parts(256)
    assert sched["argument_parts"]["y"] == 4 * 100 * 512 * 6
    table = report.table([lm, sched, skipped], 256)
    assert "stablelm-3b / train_4k" in table and "SKIP" in table
    assert "ogasched-distributed / L100_R131072_K6" in table
    tpls = templates_from_dryrun({"stablelm-3b": lm, "ogasched": sched})
    mem = lm["memory"]
    assert tpls[0].arch == "stablelm-3b" and tpls[0].hbm_gb == min(
        (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9, 64.0)
    assert tpls[1].hbm_gb == pytest.approx(
        (sched["memory"]["argument_size_in_bytes"] + sched["memory"]["temp_size_in_bytes"]) / 1e9)


def test_sched_parts_divide_the_instances():
    assert sum(dryrun.sched_parts(4).values()) == (
        4 * (100 * 32768 + 100 * 6 + 2 * 32768 * 6 + 6) + 4 * 6   # spec shard
        + 4 * 100 * 32768 * 6 + 4 * 100 + 4)                      # y, x, eta
    with pytest.raises(ValueError):
        dryrun.sched_parts(3)
    assert math.prod((2, 16, 16)) == dryrun.run_sched_cell(True)["n_devices"]
