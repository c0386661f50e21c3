"""Whole runs of both cells at a tiny size on the CPU (the program's plain
versions against the reference), the run's guards, and the same harness on
the card where there is one."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from chipbench import harness, run

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["ogasched-r1024.fig5", "lifecycle-r128.heavy"]
# the CPU tests' size: every key a width the cell keeps, the cluster cut
TINY = {"config": {"L": 10, "R": 64, "segment_slots": 6}, "traffic": {"work_mean": 300.0}}
SEED = 2**33 + 5


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_on_the_cpu(cell):
    out = harness.run_cell(cell, SEED, 0.3, False, device="cpu", overrides=TINY)
    res = out["result"]
    assert list(res)[-1] == "checks" and set(res) >= {"correct", "attempted", "failed",
                                                      "metrics", "device"}
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    # a CPU run writes no device metric
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    limits = harness.cell(cell)["cell"]["limits"]
    assert set(res["checks"]) == set(limits)
    for name, c in res["checks"].items():
        assert 0 <= c["value"] <= c["limit"] == limits[name]
    assert out["info"]["slots"] == res["attempted"] and out["info"]["units"] >= 1


def test_seeded_runs_draw_the_same_inputs():
    a = harness.run_cell(CELLS[0], SEED, 0.05, False, device="cpu", overrides=TINY)
    b = harness.run_cell(CELLS[0], SEED, 0.05, False, device="cpu", overrides=TINY)
    assert a["rows"][0] == b["rows"][0]


def test_forbidden_modules_compare_whole_top_level_names():
    allowed = ["repro_torch", "repro_torch.core.ogasched", "reprox", "jaxtyping", "torch"]
    assert run.forbidden_modules(allowed) == []
    found = ["repro", "repro.core.ogasched", "jax.numpy", "jaxlib", "flax.linen"]
    assert run.forbidden_modules(allowed + found) == sorted(found)


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", CELLS[0], "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_the_command_refuses_a_host_without_the_card_or_the_program(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _cli(ROOT, env)
    assert out.returncode != 0 and out.stdout == ""
    # a checkout holding only BENCHMARK.json and the benchmark's paths
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".autotune", ".triton"))
    out = _cli(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' kernels are CUDA only")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_on_the_card(cell, cuda):
    out = harness.run_cell(cell, SEED, 0.5, True, device=cuda, overrides=TINY)
    res = out["result"]
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and "breakdown" in res
    assert "oga_fused_roofline" in res["metrics"]
