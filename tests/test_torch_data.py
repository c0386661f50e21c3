"""The port's synthetic token pipeline (``repro_torch.data.pipeline``) on the
CPU against the JAX package's: ``batch_at`` draws with the same
``np.random.default_rng((seed, step))`` zipf calls, so its tokens and
labels equal the reference's bit for bit for every (seed, step, host
count, host index); and twins of the determinism, host-sharding and
prefetch tests of ``tests/test_substrate.py``.
"""
import time

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("seed,step,n_hosts,host_index", [
    (0, 0, 1, 0), (3, 5, 1, 0), (1, 2, 4, 0), (1, 2, 4, 3), (7, 1000, 2, 1), (2**20, 9, 8, 5),
])
def test_batch_at_equals_reference(seed, step, n_hosts, host_index):
    kw = dict(vocab=100, global_batch=8, seq_len=16, seed=seed, n_hosts=n_hosts,
              host_index=host_index)
    want = jpipe.batch_at(jpipe.DataConfig(**kw), step)
    got = tpipe.batch_at(tpipe.DataConfig(**kw), step, "cpu")
    for name in ("tokens", "labels"):
        assert got[name].dtype == torch.int64 and got[name].device.type == "cpu"
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(), got["labels"][:, :-1].numpy())


def test_batch_at_clips_to_the_vocab():
    b = tpipe.batch_at(tpipe.DataConfig(vocab=5, global_batch=4, seq_len=64, seed=0), 0, "cpu")
    assert int(b["tokens"].max()) == 4 and int(b["tokens"].min()) >= 1


def test_data_deterministic_across_restarts():
    cfg = tpipe.DataConfig(vocab=100, global_batch=8, seq_len=16, seed=3)
    assert torch.equal(tpipe.batch_at(cfg, 5, "cpu")["tokens"],
                       tpipe.batch_at(cfg, 5, "cpu")["tokens"])


def test_data_host_sharding_partitions_global_batch():
    full = tpipe.batch_at(tpipe.DataConfig(vocab=100, global_batch=8, seq_len=16, seed=1), 2,
                          "cpu")
    shards = [tpipe.batch_at(tpipe.DataConfig(vocab=100, global_batch=8, seq_len=16, seed=1,
                                              n_hosts=4, host_index=h), 2, "cpu")
              for h in range(4)]
    assert torch.equal(torch.cat([s["tokens"] for s in shards]), full["tokens"])


def test_prefetcher_yields_stream():
    cfg = tpipe.DataConfig(vocab=50, global_batch=4, seq_len=8, seed=0)
    pf = tpipe.Prefetcher(cfg, start_step=0, device="cpu")
    try:
        batches = [next(pf) for _ in range(3)]
    finally:
        pf.close()
    assert not pf._t.is_alive()
    for step, b in enumerate(batches):
        assert torch.equal(b["tokens"], tpipe.batch_at(cfg, step, "cpu")["tokens"])


def test_prefetcher_does_not_skip_steps_when_the_consumer_is_slow():
    """A batch waits for room in the queue: reading late still gives
    steps start, start + 1, ... in order."""
    cfg = tpipe.DataConfig(vocab=50, global_batch=2, seq_len=4, seed=1)
    pf = tpipe.Prefetcher(cfg, start_step=7, depth=1, device="cpu")
    try:
        first = next(pf)
        time.sleep(0.5)  # several of the worker's put timeouts
        second = next(pf)
    finally:
        pf.close()
    assert torch.equal(first["tokens"], tpipe.batch_at(cfg, 7, "cpu")["tokens"])
    assert torch.equal(second["tokens"], tpipe.batch_at(cfg, 8, "cpu")["tokens"])


def test_stream_starts_at_its_step():
    cfg = tpipe.DataConfig(vocab=50, global_batch=2, seq_len=4, seed=2)
    it = tpipe.stream(cfg, start_step=3, device="cpu")
    for step in (3, 4):
        assert torch.equal(next(it)["labels"], tpipe.batch_at(cfg, step, "cpu")["labels"])
