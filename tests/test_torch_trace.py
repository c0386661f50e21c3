"""The port's host trace path against the reference's, bit for bit.

``repro_torch.sched.trace`` keeps its own copy of the templates and seeded
numpy streams; these tests hold its specs, arrivals and job sizes equal
to ``repro.sched.trace``'s and to the digests pinned in test_trace.py.
"""
import hashlib

import jax
import numpy as np
import pytest

from repro.sched import trace as jtrace
from repro_torch.sched import trace as ttrace

CONFIGS = {
    "base": dict(T=64, L=4, R=8, K=4, seed=0),
    "log-contended": dict(T=100, L=6, R=16, K=4, seed=3, rho=0.4,
                          contention=14.0, utility="log"),
    "sparse-bursty": dict(T=80, L=10, R=12, K=6, seed=7, density=0.12,
                          burst_prob=0.1),
}

# The digests of tests/test_trace.py BITWISE_GOLD for the same configs:
# (spec leaves, arrivals, works).
GOLD = {
    "base": ("a1598eded4d084de", "5588a7ba1e9cfefa", "c84d4e0c37c0fecb"),
    "log-contended": ("243899e490c19c65", "8f3f7e9425ce9b7e", "ce4e662280c0ffdf"),
    "sparse-bursty": ("7622c7bec11bfe33", "32656ddf729af2cc", "b5e86e9a26fc7683"),
}

# the reference spec's pytree leaf order
_LEAVES = ("mask", "a", "c", "alpha", "beta", "kinds")


def _sha16(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _np_spec(spec):
    return [np.asarray(getattr(spec, f)) for f in _LEAVES]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_trace_equals_reference_bitwise(name):
    kw = CONFIGS[name]
    jcfg, tcfg = jtrace.TraceConfig(**kw), ttrace.TraceConfig(**kw)
    jspec = jtrace.build_spec(jcfg)
    tspec = ttrace.build_spec(tcfg, device="cpu")
    for want, got in zip(_np_spec(jspec), _np_spec(tspec)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for jf, tf in ((jtrace.build_arrivals, ttrace.build_arrivals),
                   (jtrace.build_works, ttrace.build_works)):
        want = np.asarray(jf(jcfg))
        got = tf(tcfg, device="cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jtrace.build_arrivals(jcfg, multi=True))
    got = ttrace.build_arrivals(tcfg, multi=True, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_trace_matches_pinned_digests(name):
    cfg = ttrace.TraceConfig(**CONFIGS[name])
    spec, arr = ttrace.make(cfg, device="cpu")
    works = ttrace.build_works(cfg, device="cpu")
    got = (_sha16(*_np_spec(spec)), _sha16(arr.numpy()), _sha16(works.numpy()))
    assert got == GOLD[name]


def test_make_batch_host_stacking_equals_reference():
    cfgs = [dict(T=30, L=4, R=8, K=4, seed=s, contention=c)
            for s, c in ((0, 10.0), (5, 3.0), (9, 14.0))]
    jspec, jarr, jworks, _ = jtrace.make_batch(
        [jtrace.TraceConfig(**kw) for kw in cfgs], with_works=True,
        trace_backend="host")
    tspec, tarr, tworks, tfaults = ttrace.make_batch(
        [ttrace.TraceConfig(**kw) for kw in cfgs], with_works=True, device="cpu")
    for want, got in zip(_np_spec(jspec), _np_spec(tspec)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tarr.numpy(), np.asarray(jarr))
    np.testing.assert_array_equal(tworks.numpy(), np.asarray(jworks))
    assert tfaults is None
    # and config by config equal to make()
    for g, kw in enumerate(cfgs):
        spec, arr = ttrace.make(ttrace.TraceConfig(**kw), device="cpu")
        np.testing.assert_array_equal(arr.numpy(), tarr[g].numpy())
        for want, got in zip(_np_spec(spec), _np_spec(tspec[g])):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ttrace.make_batch([ttrace.TraceConfig(T=3), ttrace.TraceConfig(T=4)],
                          device="cpu")
    assert jax.tree.leaves(jspec)[0].shape[0] == len(cfgs)
