"""The port's device trace synthesis (``repro_torch.sched.trace_device``)
case by case against ``tests/test_trace_device.py``, run on the CPU:
statistical parity with the host numpy path (whose bits are the
reference's), per-(seed, stream) independence, chunk invariance, batching
and refusals.

The hash is Threefry-2x32-20: its words equal JAX's own ``threefry_2x32``
bit for bit and Random123's known answers. Parity bars are the
reference's own (its device traces against its host traces): arrival
rate abs 0.03; burst coverage rel 0.25, lag correlations abs 0.1; Lomax
mean and quantiles rel 0.1; capacities rel 0.25, requests rel 0.1; fault
streams mean abs 0.03, faulted share abs 0.05, depth abs 0.2. Chunked
against whole generation: bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.sched import sweep, trace, trace_device

SEEDS = (0, 1, 2)
CPU = "cpu"


def _device_batch(cfgs, with_works=False):
    return trace.make_batch(cfgs, with_works=with_works, trace_backend="device", device=CPU)[:3]


def _host(fn, cfg):
    return fn(cfg, device=CPU).numpy()


# --------------------------------------------------------------- the hash --
def test_threefry_matches_known_answers_and_jax():
    M = 0xFFFFFFFF
    kat = [((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
           ((M, M, M, M), (0x1CB996FC, 0xBB002BE7)),
           ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]
    for (k0, k1, c0, c1), want in kat:
        x0, x1 = trace_device.threefry2x32(torch.tensor(k0), k1, torch.tensor(c0), c1)
        assert (int(x0), int(x1)) == want
    import jax.numpy as jnp

    count = np.arange(64, dtype=np.uint32)
    for key in ((5, 2), (2 ** 32 - 1, 3), (123456789, 0)):
        want = np.asarray(jprng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                              jnp.asarray(count)))
        x0, x1 = trace_device.threefry2x32(torch.tensor(key[0]), key[1],
                                           torch.arange(32), torch.arange(32, 64))
        np.testing.assert_array_equal(np.r_[x0.numpy(), x1.numpy()], want.astype(np.int64))


def test_integer_draws_depend_only_on_seed_stream_and_index():
    """A configuration's bits are the same whatever else is in the batch,
    and a longer draw extends a shorter one."""
    seeds = torch.tensor([0, 7, 2 ** 32 - 1])
    whole = trace_device.stream_bits(seeds, "arrivals", (5, 40))
    alone = trace_device.stream_bits(seeds[1:2], "arrivals", (5, 40))
    for w, a in zip(whole, alone):
        assert torch.equal(w[1:2], a)
    longer = trace_device.stream_bits(seeds, "arrivals", (5, 60))
    assert torch.equal(longer[0], whole[0])
    assert torch.equal(longer[1][:, :40], whole[1])
    assert int(whole[1].min()) >= 0 and int(whole[1].max()) < 2 ** 32


# ------------------------------------------------------- statistical parity --
def test_arrival_rate_parity():
    for seed in SEEDS:
        cfg = trace.TraceConfig(T=3000, L=8, R=8, K=4, seed=seed, rho=0.6)
        host = float(_host(trace.build_arrivals, cfg).mean())
        dev = float(_device_batch([cfg])[1][0].mean())
        assert dev == pytest.approx(host, abs=0.03), (seed, host, dev)


def test_burst_window_statistics_parity():
    """With rho = 0 and no diurnal floor, arrivals exist only inside burst
    windows: coverage and the lag-5 / lag-40 conditional arrival rates
    expose the window structure, and must match the host process."""

    def stats(arr):
        arr = np.asarray(arr, bool)
        lags = [(arr[:-k] & arr[k:]).mean() / max(arr.mean(), 1e-9)
                for k in (5, 2 * trace.BURST_LEN)]
        return arr.mean(), lags[0], lags[1]

    for seed in SEEDS:
        cfg = trace.TraceConfig(T=4000, L=8, R=8, K=4, seed=seed, rho=0.0, diurnal=False,
                                burst_prob=0.01)
        h_cover, h_near, h_far = stats(_host(trace.build_arrivals, cfg))
        d_cover, d_near, d_far = stats(_device_batch([cfg])[1][0].numpy())
        assert d_cover == pytest.approx(h_cover, rel=0.25), seed
        assert d_near == pytest.approx(h_near, abs=0.1)
        assert d_near > 0.5
        assert d_far == pytest.approx(h_far, abs=0.1)
        assert d_far < 0.35


def test_works_lomax_parity():
    host_all, dev_all = [], []
    for seed in SEEDS:
        cfg = trace.TraceConfig(T=4000, L=10, R=8, K=4, seed=seed)
        host_all.append(_host(trace.build_works, cfg).ravel())
        dev_all.append(_device_batch([cfg], with_works=True)[2][0].numpy().ravel())
    host, dev = np.concatenate(host_all), np.concatenate(dev_all)
    assert dev.min() > 0
    assert dev.mean() == pytest.approx(host.mean(), rel=0.1)
    for q in (50, 90, 99):
        assert np.percentile(dev, q) == pytest.approx(np.percentile(host, q), rel=0.1), q
    assert dev.max() > 4 * cfg.work_mean


def test_spec_distribution_parity():
    cfgs = [trace.TraceConfig(T=8, L=10, R=64, K=6, seed=s, utility="log") for s in range(6)]
    spec_d = _device_batch(cfgs)[0]
    host = [trace.build_spec(c, CPU) for c in cfgs]
    c_h = np.mean([s.c.numpy() for s in host], axis=(0, 1))
    np.testing.assert_allclose(spec_d.c.numpy().mean(axis=(0, 1)), c_h, rtol=0.25)
    a_h = np.mean([s.a.numpy() for s in host], axis=(0, 1))
    np.testing.assert_allclose(spec_d.a.numpy().mean(axis=(0, 1)), a_h, rtol=0.1)
    alpha = spec_d.alpha.numpy()
    assert alpha.min() >= cfgs[0].alpha_range[0]
    assert alpha.max() <= cfgs[0].alpha_range[1]
    for g, cfg in enumerate(cfgs):
        np.testing.assert_array_equal(spec_d.kinds[g].numpy(), trace.spec_kinds(cfg))
        np.testing.assert_allclose(spec_d.beta[g].numpy(), trace.spec_beta(cfg), rtol=1e-6)
    assert spec_d.mask.dtype == spec_d.a.dtype == torch.float32
    assert spec_d.kinds.dtype == torch.int32


def test_mask_density_and_coverage():
    cfgs = [trace.TraceConfig(T=8, L=12, R=16, K=4, seed=s, density=0.08) for s in range(8)]
    m = _device_batch(cfgs)[0].mask.numpy()
    assert set(np.unique(m)) <= {0.0, 1.0}
    assert m.any(axis=2).all(), "uncovered port row"
    assert m.any(axis=1).all(), "uncovered instance column"
    dense = [dataclasses.replace(c, density=0.6) for c in cfgs]
    md = _device_batch(dense)[0].mask.numpy()
    assert 0.4 < md.mean() < 0.8
    assert m.mean() < md.mean()


# ----------------------------------------------------- stream independence --
def test_stream_bits_independent_across_seed_stream_pairs():
    """Every (seed, stream) pair owns its randomness, including the old
    seed-offset collision (seed s arrivals == seed s+1 spec)."""
    draws = {}
    for seed in (0, 1, 2, 3):
        for stream in trace.STREAMS:
            (bits,) = trace_device.stream_bits(torch.tensor([seed]), stream, (64,))
            draws[(seed, stream)] = bits.numpy()
    keys = list(draws)
    for i, k1 in enumerate(keys):
        for k2 in keys[i + 1:]:
            assert not np.array_equal(draws[k1], draws[k2]), (k1, k2)
    assert list(trace_device.STREAM_INDEX) == list(trace.STREAMS)


def test_components_resample_independently():
    cfg = trace.TraceConfig(T=200, L=6, R=8, K=4, seed=5)
    _, arr1, _ = _device_batch([cfg])
    _, arr2, works = _device_batch([cfg], with_works=True)
    assert torch.equal(arr1, arr2)
    assert works is not None


# ----------------------------------------------------------- batching/API --
def test_device_batch_deterministic_and_seed_sensitive():
    cfgs = [trace.TraceConfig(T=50, L=6, R=8, K=4, seed=s) for s in (3, 4)]
    b1 = _device_batch(cfgs, with_works=True)
    b2 = _device_batch(cfgs, with_works=True)
    for f in b1[0].FIELDS:
        assert torch.equal(getattr(b1[0], f), getattr(b2[0], f))
    assert torch.equal(b1[1], b2[1]) and torch.equal(b1[2], b2[2])
    assert not torch.equal(b1[1][0], b1[1][1])


def test_device_batch_equals_chunked_generation():
    """Generating a grid whole equals generating it chunk by chunk, bit
    for bit: the invariant the stream's chunking rests on."""
    fc = trace.FaultConfig(fail_rate=0.05, drain_period=10, drain_len=3, shock_rate=0.05)
    cfgs = [trace.TraceConfig(T=40, L=5, R=8, K=4, seed=s, faults=fc) for s in range(5)]
    full = trace_device.make_batch(cfgs, with_works=True, with_faults=True, device=CPU)
    for start in (0, 2, 4):
        part = trace_device.make_batch(cfgs[start:start + 2], with_works=True,
                                       with_faults=True, device=CPU)
        for f in full[0].FIELDS:
            assert torch.equal(getattr(full[0], f)[start:start + 2], getattr(part[0], f))
        for lf, lp in zip(full[1:], part[1:]):
            assert torch.equal(lf[start:start + 2], lp)


def test_device_batch_shapes_and_works_gating():
    cfgs = [trace.TraceConfig(T=30, L=4, R=8, K=4, seed=s) for s in range(3)]
    spec, arr, works = _device_batch(cfgs)
    assert works is None
    assert arr.shape == (3, 30, 4)
    assert spec.c.shape == (3, 8, 4)
    assert spec.mask.shape == (3, 4, 8)
    assert _device_batch(cfgs, with_works=True)[2].shape == (3, 30, 4)


def test_device_batch_rejects_mixed_statics():
    cfgs = [trace.TraceConfig(T=30, L=4, R=8, K=4, seed=0)]
    with pytest.raises(ValueError):
        trace_device.make_batch(cfgs + [dataclasses.replace(cfgs[0], density=0.9)], device=CPU)
    with pytest.raises(ValueError):
        trace_device.make_batch(cfgs + [dataclasses.replace(cfgs[0], T=31)], device=CPU)
    with pytest.raises(ValueError):
        trace_device.make_batch([], device=CPU)
    mixed = cfgs + [dataclasses.replace(cfgs[0], seed=1, rho=0.3, contention=20.0,
                                        utility="log")]
    spec, arr, _, _ = trace_device.make_batch(mixed, device=CPU)
    assert arr.shape == (2, 30, 4)
    assert not torch.equal(spec.kinds[0], spec.kinds[1])


def test_device_batch_rejects_out_of_range_seeds():
    base = trace.TraceConfig(T=10, L=4, R=8, K=4)
    for seed in (2 ** 32 + 5, -1):
        with pytest.raises(ValueError, match="2\\*\\*32"):
            trace_device.make_batch([dataclasses.replace(base, seed=seed)], device=CPU)


def test_make_batch_rejects_unknown_backend():
    cfgs = [trace.TraceConfig(T=10, L=4, R=8, K=4)]
    with pytest.raises(ValueError):
        trace.make_batch(cfgs, trace_backend="gpu", device=CPU)
    assert trace.TRACE_BACKENDS == ("host", "device")
    assert sweep.TRACE_BACKENDS == ("auto", "host", "device")


# ------------------------------------------------------ fault stream parity --
@pytest.mark.parametrize("regime", ["failures", "drains", "shocks"])
def test_fault_stream_statistical_parity(regime):
    fc = {
        "failures": trace.FaultConfig(fail_rate=0.03, fail_frac=0.3, repair_mean=30.0),
        "drains": trace.FaultConfig(drain_period=100, drain_len=25, drain_frac=0.5),
        "shocks": trace.FaultConfig(shock_rate=0.02, shock_depth=0.5),
    }[regime]
    host_stats, dev_stats = [], []
    for seed in SEEDS:
        cfg = trace.TraceConfig(T=4000, L=4, R=8, K=6, seed=seed, faults=fc)
        h = _host(trace.build_faults, cfg)
        d = trace.make_batch([cfg], with_faults=True, trace_backend="device",
                             device=CPU)[3][0].numpy()
        assert d.shape == h.shape == (4000, 6)
        assert (d >= 0.0).all() and (d <= 1.0).all()
        host_stats.append((h.mean(), h.min(), (h < 1.0).mean()))
        dev_stats.append((d.mean(), d.min(), (d < 1.0).mean()))
    hm, hmin, hfrac = np.mean(host_stats, axis=0)
    dm, dmin, dfrac = np.mean(dev_stats, axis=0)
    assert dm == pytest.approx(hm, abs=0.03)
    assert dfrac == pytest.approx(hfrac, abs=0.05)
    assert dmin == pytest.approx(hmin, abs=0.2)


def test_fault_stream_gating_and_family_independence():
    base = trace.TraceConfig(T=200, L=4, R=8, K=4, seed=0)
    assert trace_device.make_batch([base], device=CPU)[3] is None
    ones = trace_device.make_batch([base], with_faults=True, device=CPU)[3]
    assert torch.equal(ones[0], torch.ones((200, 4)))
    drains = trace.FaultConfig(drain_period=50, drain_len=10)
    both = dataclasses.replace(drains, shock_rate=0.05, shock_depth=0.0)
    f_dr = trace_device.make_batch([dataclasses.replace(base, faults=drains)],
                                   with_faults=True, device=CPU)[3][0]
    f_both = trace_device.make_batch([dataclasses.replace(base, faults=both)],
                                     with_faults=True, device=CPU)[3][0]
    unshocked = f_both > 0.0
    assert torch.equal(f_both[unshocked], f_dr[unshocked])
    assert bool((~unshocked).any())
