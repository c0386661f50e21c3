"""The readers of the program's span metrics, on span aggregates recorded
on the CPU under a torch profiler: each gives the self time of its spans
a slot, and None where the program recorded none of them or has no span
module (an older program)."""
import sys

import pytest
import torch.profiler as tp

from chipbench import harness

SLOTS = 5
READERS = {
    "reward_host_ms": ("repro_torch.reward",),
    "pack_host_ms": ("repro_torch.ops.oga_update", "repro_torch.ops.project"),
    "bookkeeping_host_ms": tuple(f"repro_torch.lifecycle.{n}" for n in (
        "step", "evict", "enqueue", "admit", "allocate", "serve", "depart", "update",
        "record")),
    "launch_host_ms": ("repro_torch.launch",),
    "segment_setup_ms": ("repro_torch.lifecycle.setup",),
}


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


@pytest.fixture
def spans():
    from repro_torch import spans

    spans.reset()
    yield spans
    spans.reset()


@pytest.fixture
def recorded(spans):
    """Aggregates of a slot loop and a faulted lifecycle segment."""
    import torch

    from repro_torch.core import ogasched
    from repro_torch.sched import lifecycle
    from repro_torch.sched import trace as tt

    cfg = tt.TraceConfig(T=SLOTS, L=3, R=4, K=2, seed=5, work_mean=3.0)
    spec, arrivals, works = tt.make_lifecycle(cfg, device="cpu")
    faults = torch.ones(SLOTS, spec.K)
    faults[1:3] = 0.4
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        ogasched.run(spec, arrivals, 0.05, 0.999, device="cpu")
        lifecycle.run(spec, arrivals, works, faults=faults, device="cpu")
    return spans.snapshot()


@pytest.mark.parametrize("name", list(READERS))
def test_a_reader_gives_its_spans_self_time_a_slot(name, recorded):
    assert all(n in recorded for n in READERS[name])
    want = 1e-6 * sum(recorded[n][2] for n in READERS[name]) / SLOTS
    assert _reader(name).read({"slots": SLOTS}) == pytest.approx(want, rel=1e-12)


def test_the_readers_share_out_the_top_span(spans):
    """The five readers and the lifecycle's top span's own self time sum
    to that span's total: every span of a segment is counted once."""
    from repro_torch.sched import lifecycle
    from repro_torch.sched import trace as tt

    cfg = tt.TraceConfig(T=SLOTS, L=3, R=4, K=2, seed=6, work_mean=3.0)
    spec, arrivals, works = tt.make_lifecycle(cfg, device="cpu")
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        lifecycle.run(spec, arrivals, works, device="cpu")
    _, total_ns, self_ns = spans.snapshot()["repro_torch.lifecycle.segment"]
    read = sum(_reader(n).read({"slots": SLOTS}) for n in READERS)
    assert read + 1e-6 * self_ns / SLOTS == pytest.approx(1e-6 * total_ns / SLOTS, rel=1e-9)


@pytest.mark.parametrize("name", list(READERS))
def test_a_reader_without_its_spans_gives_none(name, spans):
    assert _reader(name).read({"slots": SLOTS}) is None


@pytest.mark.parametrize("name", list(READERS))
def test_a_reader_without_the_span_module_gives_none(name, recorded, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert _reader(name).read({"slots": SLOTS}) is None
