"""The port's §3.4 multi-arrival and §3.5 gang-scheduling extensions
(``repro_torch.core.extensions``) and ``reward.decompose`` against the
reference, on the same numpy-seeded inputs.

Tolerances: the expansions and ``gang_repair`` exactly (copies, compares
and masks); ``gang_reward`` and ``decompose`` within 1e-6 relative (the
port sums gain and penalty apart); gang steps with equal kept-port masks
and y within 1e-4 (the fused update, float32 rounding in another order);
``ogasched.run`` on an expanded spec at tests/test_torch_ogasched.py's
tolerance (per-slot 1e-4 of the largest reward, the mean 1e-5). The
ports of tests/test_extensions.py keep their own assertions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import chip_smoke
from repro.core import extensions as jext
from repro.core import graph as jgraph
from repro.core import ogasched as jog
from repro.core import reward as jreward
from repro.sched import trace as jtrace
from repro_torch import convert
from repro_torch.core import extensions, graph, ogasched, reward
from repro_torch.sched import trace

CPU = "cpu"


def _spec_pair(**cfg):
    jspec = jtrace.build_spec(jtrace.TraceConfig(**cfg))
    return jspec, convert.spec_from_reference(jspec, CPU)


def _same_spec(got, want):
    for f in got.FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f


def _close_rewards(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0, err_msg=what)
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-5, err_msg=what)


# ------------------------------------------------------------- §3.4 --------
@pytest.mark.parametrize("J", [1, 3])
def test_expand_multi_arrival_bit_for_bit(J):
    cfg = dict(T=50, L=4, R=8, K=3, seed=1)
    jspec, tspec = _spec_pair(**cfg)
    arr = jtrace.build_arrivals(jtrace.TraceConfig(**cfg), multi=True)
    jes, jx = jext.expand_multi_arrival(jspec, arr, J)
    tes, tx = extensions.expand_multi_arrival(tspec, torch.from_numpy(np.array(arr)), J)
    _same_spec(tes, jes)
    assert tx.dtype == torch.float32 and np.array_equal(tx.numpy(), np.asarray(jx))


def test_multi_arrival_j1_equals_base():
    """The reference's test: J = 1 of an indicator trace is the base
    problem. On the port the expansion copies the data, so the rewards are
    equal bit for bit."""
    cfg = trace.TraceConfig(T=100, L=6, R=12, K=4, seed=0)
    spec, arr = trace.make(cfg, device=CPU)
    espec, x_exp = extensions.expand_multi_arrival(spec, arr.to(torch.int32), J=1)
    assert torch.equal(x_exp, arr)
    r_base, y_base = ogasched.run(spec, arr, eta0=10.0, device=CPU)
    r_exp, y_exp = ogasched.run(espec, x_exp, eta0=10.0, device=CPU)
    assert torch.equal(r_base, r_exp) and torch.equal(y_base, y_exp)


def test_multi_arrival_counts_expand_correctly():
    cfg = trace.TraceConfig(T=50, L=4, R=8, K=3, seed=1)
    spec = trace.build_spec(cfg, CPU)
    arr = trace.build_arrivals(cfg, multi=True, device=CPU)
    J = int(arr.max())
    espec, x_exp = extensions.expand_multi_arrival(spec, arr, J=J)
    assert espec.L == spec.L * J
    t, l = 11, 2
    cnt = int(arr[t, l])
    row = x_exp[t].reshape(spec.L, J)[l].numpy()
    assert row.sum() == min(cnt, J)
    assert np.all(row[: min(cnt, J)] == 1)


def test_multi_arrival_run_feasible_and_learns():
    cfg = trace.TraceConfig(T=300, L=5, R=10, K=4, seed=2)
    spec = trace.build_spec(cfg, CPU)
    arr = trace.build_arrivals(cfg, multi=True, device=CPU)
    espec, x_exp = extensions.expand_multi_arrival(spec, arr, J=int(arr.max()))
    rewards, y_final = ogasched.run(espec, x_exp, eta0=15.0, device=CPU)
    assert bool(graph.feasible(espec, y_final))
    r = rewards.numpy()
    assert r[-50:].mean() > r[:50].mean()


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_run_on_expanded_spec_matches_reference(backend):
    cfg = dict(T=60, L=4, R=8, K=3, seed=1)
    jspec, tspec = _spec_pair(**cfg)
    arr = jtrace.build_arrivals(jtrace.TraceConfig(**cfg), multi=True)
    J = int(jnp.max(arr))
    jes, jx = jext.expand_multi_arrival(jspec, arr, J)
    tes, tx = extensions.expand_multi_arrival(tspec, torch.from_numpy(np.array(arr)), J)
    jr, jy = jog.run(jes, jx, eta0=5.0, decay=0.999, backend=backend)
    tr, ty = ogasched.run(tes, tx, eta0=5.0, decay=0.999, backend=backend, device=CPU)
    _close_rewards(tr.numpy(), jr, f"expanded/{backend}")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)


# ------------------------------------------------------------- §3.5 --------
def _gang_setup(seed=0):
    """The reference test's setup: L 4, R 10, K 3, Q 3, port 0 with 2 tasks."""
    cfg = dict(T=40, L=4, R=10, K=3, seed=seed)
    jspec, tspec = _spec_pair(**cfg)
    rng = np.random.default_rng(seed)
    task_req = rng.uniform(0.5, 3.0, (4, 3, 3))
    task_req[0, 2] = 0.0
    m_min = np.asarray([2.0, 2.0, 1.0, 3.0], np.float32)
    jes, jpot, jvalid = jext.expand_gang(jspec, task_req)
    tes, tpot, tvalid = extensions.expand_gang(tspec, task_req)
    return (jspec, jes, jpot, jvalid, tspec, tes, tpot, tvalid, m_min)


def test_expand_gang_bit_for_bit():
    _, jes, jpot, jvalid, _, tes, tpot, tvalid, _ = _gang_setup()
    _same_spec(tes, jes)
    assert np.array_equal(tpot.numpy(), np.asarray(jpot))
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    with pytest.raises(ValueError, match="task_requests"):
        extensions.expand_gang(convert.spec_from_reference(jes, CPU), np.ones((2, 3, 3)))


def _random_y(jes, seed):
    return np.array(jgraph.random_feasible_decision(jes, jax.random.PRNGKey(seed)))


def test_gang_repair_exact():
    _, jes, jpot, _, _, tes, tpot, _, m_min = _gang_setup()
    y = _random_y(jes, 0)
    y[9:12] *= np.asarray([1.0, 0.0, 0.0], np.float32)[:, None, None]
    y[0:3] *= np.asarray([1.0, 0.0, 1.0], np.float32)[:, None, None]
    want = jext.gang_repair(jes, jnp.asarray(y), jpot, jnp.asarray(m_min), 4)
    got = extensions.gang_repair(tes, torch.from_numpy(y), tpot, torch.from_numpy(m_min), 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    kept = extensions.kept_ports(torch.from_numpy(y), tpot, torch.from_numpy(m_min), 4).numpy()
    want_kept = (y.sum((1, 2)).reshape(4, 3) > 1e-6).sum(1) >= m_min
    assert np.array_equal(kept > 0, want_kept) and 0 < want_kept.sum() < 4


def test_gang_repair_enforces_all_or_nothing():
    """The reference's test on the port."""
    _, jes, _, _, _, tes, tpot, _, m_min = _gang_setup()
    y = torch.from_numpy(_random_y(jes, 0))
    y[9:12] = y[9:12] * torch.tensor([1.0, 0.0, 0.0])[:, None, None]
    y2 = extensions.gang_repair(tes, y, tpot, torch.from_numpy(m_min), 4)
    n_sched = (y2.sum((1, 2)).reshape(4, 3) > 1e-6).sum(1).numpy()
    for l in range(4):
        assert n_sched[l] == 0 or n_sched[l] >= m_min[l]


def test_gang_reward_and_decompose_match():
    jspec, jes, jpot, _, tspec, tes, tpot, _, _ = _gang_setup(seed=1)
    x = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    y = _random_y(jes, 2)
    want = float(jext.gang_reward(jes, jnp.asarray(x), jnp.asarray(y), jpot, 4))
    got = float(extensions.gang_reward(tes, torch.from_numpy(x), torch.from_numpy(y), tpot, 4))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    y0 = _random_y(jspec, 3)
    jg, jp = jreward.decompose(jspec, jnp.asarray(x), jnp.asarray(y0))
    tg, tp = reward.decompose(tspec, torch.from_numpy(x), torch.from_numpy(y0))
    np.testing.assert_allclose([float(tg), float(tp)], [float(jg), float(jp)], rtol=1e-6)
    total = float(reward.total_reward(tspec, torch.from_numpy(x), torch.from_numpy(y0)))
    np.testing.assert_allclose(float(tg) - float(tp), total, rtol=1e-6)


def test_gang_steps_match_reference():
    """5 gang steps from y = 0 with all ports arriving: equal kept-port
    masks every step, q within 1e-6 relative, y within 1e-4."""
    _, jes, jpot, _, _, tes, tpot, _, m_min = _gang_setup(seed=3)
    x = np.ones(4, np.float32)
    jy = jnp.zeros((jes.L, jes.R, jes.K))
    ty = torch.zeros((tes.L, tes.R, tes.K))
    jm, tm = jnp.asarray(m_min), torch.from_numpy(m_min)
    for _ in range(5):
        jy, jq = jext.gang_oga_step(jes, jnp.asarray(x), jy, jnp.asarray(5.0), jpot, jm, 4)
        ty, tq = extensions.gang_oga_step(tes, torch.from_numpy(x), ty, torch.tensor(5.0),
                                          tpot, tm, 4)
        want_kept = (np.asarray(jnp.sum(jy, axis=(1, 2))).reshape(4, 3) > 1e-6).sum(1) >= m_min
        assert extensions.kept_ports(ty, tpot, tm, 4).numpy().astype(bool).tolist() == \
            want_kept.tolist()
        np.testing.assert_allclose(float(tq), float(jq), rtol=1e-6)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)


def test_gang_oga_steps_stay_feasible():
    """The reference's test on the port."""
    _, _, _, _, _, tes, tpot, _, m_min = _gang_setup(seed=3)
    y = torch.zeros((tes.L, tes.R, tes.K))
    for _ in range(5):
        y, q = extensions.gang_oga_step(tes, torch.ones(4), y, torch.tensor(5.0), tpot,
                                        torch.from_numpy(m_min), 4)
        assert bool(graph.feasible(tes, y))
    assert np.isfinite(float(q))


# ------------------------------------------------------ chip_smoke pins ----
def test_gang_phase_holds_the_pins_on_the_cpu():
    """chip_smoke.py's §3.5 runner on the CPU (the plain path): feasible
    and All-or-Nothing every slot, every kept-port mask the reference's,
    Σ q_t within REWARD_RTOL of the pin."""
    got = chip_smoke.gang_run(torch, CPU)
    T = chip_smoke.EXT_GANG_T
    assert got["feasible_slots"] == got["all_or_nothing_slots"] == T
    errs = chip_smoke.gang_errors(got, chip_smoke.EXTENSIONS_REFERENCE["gang"])
    assert errs["gang_first_kept_diff"] is None
    assert errs["gang_sum_q"] <= chip_smoke.REWARD_RTOL
    assert got["shape"] == [128 * 6, 10 * chip_smoke.EXT_GANG_Q]


def test_multi_arrival_phase_holds_the_pins_on_the_cpu():
    """chip_smoke.py's §3.4 runner on the CPU (the plain path) over the
    pinned first EXT_MULTI_PREFIX slots: J equal, no slot parts from the
    reference's by more than TRAJ_TOL, the average within REWARD_RTOL.
    (The whole run's average, ~1 minute here, is held on the card.)"""
    slots = chip_smoke.EXT_MULTI_PREFIX
    got = chip_smoke.multi_arrival_run(torch, CPU, slots=slots)
    assert got["feasible"] and got["shape"] == [128 * 6, 10 * got["J"]]
    ref = chip_smoke.EXTENSIONS_REFERENCE
    errs = chip_smoke.multi_errors(got, chip_smoke.EXTENSIONS_REFERENCE["multi"])
    assert errs["multi_J_equal"] and errs["multi_first_parted_slot"] is None
    assert errs["multi_prefix_avg_reward"] <= chip_smoke.REWARD_RTOL
