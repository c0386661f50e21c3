"""The benchmark's inputs: a pinned draw, and the properties every draw has."""
import hashlib

import pytest
import torch

from chipbench.traffic import synth

CFG = {"L": 12, "R": 40, "K": 6, "density": 0.25, "contention": 10.0,
       "alpha_range": [1.0, 1.5], "beta_range": [0.3, 0.5], "utility": "mixed"}
TRAFFIC = {"rho": 0.7, "diurnal": True, "burst_prob": 0.02, "work_mean": 614400.0,
           "work_tail": 2.1}
SEED = 2**40 + 7
CPU = torch.device("cpu")
# SHA-256 of the draw below on the CPU generator: any change to the
# generator, its order of draws or its seeding shows here
PINNED = "8b0a05591a40de94e620aab853549ff5c710c9a617d37b212d111e2e71c3bc6b"


def _draw(seed):
    spec = synth.make_spec(seed, CFG, CPU)
    arrivals = synth.make_arrivals(seed, TRAFFIC, 64, CFG["L"], CPU)
    works = synth.make_works(seed, TRAFFIC, 64, CFG["L"], CPU)
    y0 = synth.make_y0(seed, spec, CPU)
    return spec, arrivals, works, y0


def _digest(seed):
    spec, arrivals, works, y0 = _draw(seed)
    h = hashlib.sha256()
    for t in [getattr(spec, f) for f in synth.Spec.FIELDS] + [arrivals, works, y0]:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_pinned_draw():
    assert _digest(SEED) == PINNED


def test_same_seed_same_draw_other_seed_other_draw():
    assert _digest(SEED) == _digest(SEED)
    assert _digest(SEED) != _digest(SEED + 1)


def test_components_draw_from_their_own_streams():
    a = synth.make_arrivals(SEED, TRAFFIC, 64, CFG["L"], CPU)
    b = synth.make_arrivals(SEED, {**TRAFFIC, "work_mean": 1.0}, 64, CFG["L"], CPU)
    assert torch.equal(a, b)


def test_cluster_properties():
    spec, arrivals, works, y0 = _draw(SEED)
    assert spec.mask.any(1).all() and spec.mask.any(0).all()
    assert (spec.c >= 1.0).all() and (spec.a >= 0.25).all()
    assert ((spec.alpha >= 1.0) & (spec.alpha <= 1.5)).all()
    assert spec.kinds.tolist() == [0, 1, 2, 3, 0, 1]
    assert set(arrivals.unique().tolist()) <= {0.0, 1.0}
    assert (works > 0).all()


def test_start_is_feasible_by_construction():
    spec, _, _, y0 = _draw(SEED)
    assert (y0 >= 0).all() and (y0 <= spec.a[:, None, :]).all()
    assert (y0 * (1 - spec.mask[..., None]) == 0).all()
    assert (y0.sum(0) <= spec.c).all()


def test_rates_follow_the_parameters():
    big = {**TRAFFIC, "diurnal": False, "burst_prob": 0.0}
    x = synth.make_arrivals(3, big, 4000, 50, CPU)
    assert float(x.mean()) == pytest.approx(0.7, abs=0.01)
    w = synth.make_works(3, TRAFFIC, 4000, 50, CPU)
    assert float(w.double().median()) == pytest.approx(
        614400.0 * 1.1 / 2.1 * 2 ** (1 / 2.1), rel=0.03)
