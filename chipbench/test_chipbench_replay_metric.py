"""The reader of ``slot_replay_pct`` on span aggregates recorded on the CPU
under a torch profiler: the replay spans' count over the slots in %, and
None where the program recorded none or has no span module (an older
program)."""
import sys

import pytest
import torch.profiler as tp

from chipbench import harness

SLOTS = 8


def _reader():
    return harness.load_module(harness.HERE / "metrics" / "slot_replay_pct.py")


@pytest.fixture
def spans():
    from repro_torch import spans

    spans.reset()
    yield spans
    spans.reset()


def _record(spans, replays):
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        for t in range(SLOTS):
            with spans.span("repro_torch.oga_step"):
                if t >= SLOTS - replays:
                    with spans.span(_reader().REPLAY_SPAN):
                        pass


@pytest.mark.parametrize("replays", [SLOTS, SLOTS - 2, 1])
def test_the_reader_gives_the_replayed_share_of_the_slots(spans, replays):
    _record(spans, replays)
    assert _reader().read({"slots": SLOTS}) == pytest.approx(100.0 * replays / SLOTS,
                                                             rel=1e-12)


def test_the_program_names_the_span_the_reader_counts():
    from repro_torch.core import slot_graph

    assert slot_graph.REPLAY_SPAN == _reader().REPLAY_SPAN


def test_without_replays_the_reader_gives_none(spans):
    """The eager slot loop on the CPU replays nothing."""
    from repro_torch.core import ogasched
    from repro_torch.sched import trace as tt

    spec, arrivals = tt.make(tt.TraceConfig(T=SLOTS, L=3, R=4, K=2, seed=5), device="cpu")
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        ogasched.run(spec, arrivals, 0.05, 0.999, device="cpu")
    assert "repro_torch.oga_step" in spans.snapshot()
    assert _reader().read({"slots": SLOTS}) is None


def test_without_the_span_module_the_reader_gives_none(spans, monkeypatch):
    _record(spans, SLOTS)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert _reader().read({"slots": SLOTS}) is None
