"""The plain reference: isolated from JAX, the JAX package and the program,
and right against independent oracles."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chipbench.reference import oga
from chipbench.traffic import synth

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "chipbench" / "reference"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "repro_torch"}
CPU = torch.device("cpu")
CFG = {"L": 8, "R": 24, "K": 6, "density": 0.5, "contention": 10.0,
       "alpha_range": [1.0, 1.5], "beta_range": [0.3, 0.5], "utility": "mixed"}


def test_reference_loads_nothing_of_jax_or_the_program():
    """Every module that importing the reference loads, compared by its
    whole top-level name (``repro_torch`` begins with ``repro``)."""
    code = ("import json, sys; import chipbench.reference.oga, chipbench.reference.lifecycle;"
            " print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    loaded = {m.split(".")[0] for m in json.loads(out.stdout)}
    assert not loaded & FORBIDDEN
    assert "chipbench" in loaded and "torch" in loaded


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_and_the_reference(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "torch", "chipbench"}
    assert all(n.startswith("chipbench.reference") for n in names if n.startswith("chipbench"))


def _exact_np(z, a, c):
    """Water level of one row in float64 by its breakpoints."""
    box = np.clip(z, 0.0, a)
    if box.sum() <= c:
        return box
    g = lambda tau: np.clip(z - tau, 0.0, a).sum()
    pts = np.sort(np.unique(np.concatenate([z, z - a, [0.0]])))
    pts = pts[pts >= 0]
    vals = np.array([g(p) for p in pts])
    i = int(np.nonzero(vals <= c)[0][0])
    lo, hi = pts[i - 1], pts[i]
    tau = lo + (g(lo) - c) * (hi - lo) / (g(lo) - g(hi))
    return np.clip(z - tau, 0.0, a)


def test_projection_against_the_float64_breakpoint_oracle():
    spec = synth.make_spec(5, CFG, CPU)
    cl = oga.Cluster(spec)
    z = 20.0 * torch.randn((8, 24, 6), generator=torch.Generator().manual_seed(1))
    y = oga.project(cl, z)
    m, a, c = spec.mask.numpy(), spec.a.numpy(), spec.c.numpy()
    for r in range(24):
        ports = np.nonzero(m[:, r])[0]
        for k in range(6):
            want = _exact_np(z[ports, r, k].double().numpy(), a[ports, k].astype(np.float64),
                             float(c[r, k]))
            assert np.abs(y[ports, r, k].double().numpy() - want).max() <= 2e-5 * max(
                1.0, np.abs(want).max())
    assert (y * (1 - spec.mask[..., None]) == 0).all()
    # the bisection's level lies within a few float32 ulps of the exact one
    assert (y.sum(0) <= spec.c * (1 + 1e-6) + 1e-5).all()


def test_reward_and_gradient_against_autograd_in_float64():
    spec = synth.make_spec(6, CFG, CPU)
    cl = oga.Cluster(spec, torch.float64)
    y = (torch.rand((8, 24, 6), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
         * spec.a[:, None, :].double() * spec.mask[..., None].double()).requires_grad_()
    x = (torch.arange(8) % 3 != 0).double()
    q = oga.reward(cl, x, y)
    (auto,) = torch.autograd.grad(q, y)
    assert torch.allclose(oga.gradient(cl, x, y.detach()), auto, rtol=1e-10, atol=1e-10)


def test_a_tie_in_kstar_offers_both_updates():
    """Two resources with equal beta_k sum_r y at an arriving port: the
    update under either choice is a sound answer."""
    spec = synth.make_spec(7, {**CFG, "beta_range": [0.4, 0.4]}, CPU)
    cl = oga.Cluster(spec)
    y = torch.zeros((8, 24, 6))
    y[0, :, 1] = y[0, :, 2] = 0.5 * spec.mask[0]
    x = torch.zeros(8)
    x[0] = 1.0
    assert oga.tied_ports(cl, x, y) == [(0, 2)]
    ups = list(oga.next_decisions(cl, x, y, torch.tensor(25.0)))
    assert len(ups) == 2 and not torch.equal(ups[0], ups[1])
    for u in ups:
        assert oga.decision_gap(cl, x, y, torch.tensor(25.0), u) == 0.0


def test_learning_rate_rounds_each_slot():
    eta, want = torch.tensor(25.0), {}
    for t in range(301):
        if t in (0, 7, 300):
            want[t] = eta
        eta = eta * torch.tensor(0.9999)
    got = oga.learning_rates(25.0, 0.9999, [300, 0, 7])
    assert set(got) == set(want) and all(torch.equal(got[t], want[t]) for t in want)
