"""The port's spans (``repro_torch.spans``) on the CPU: recorded only under
a torch profiler, self times from a per-thread stack, the counts the slot
loop and the lifecycle give, outputs unchanged by recording, and each span
in the profiler's Chrome trace as a ``user_annotation`` event."""
import json
import threading
import time

import pytest
import torch
import torch.profiler as tp

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import spans
from repro_torch.core import ogasched
from repro_torch.sched import lifecycle
from repro_torch.sched import trace as tt

T = 6
SLOT_SPANS = {"repro_torch.oga_step", "repro_torch.reward", "repro_torch.ops.oga_update",
              "repro_torch.launch"}
LIFECYCLE_SPANS = {"repro_torch.lifecycle.segment", "repro_torch.lifecycle.setup",
                   "repro_torch.lifecycle.step", "repro_torch.lifecycle.record",
                   "repro_torch.lifecycle.enqueue", "repro_torch.lifecycle.admit",
                   "repro_torch.lifecycle.allocate", "repro_torch.lifecycle.serve",
                   "repro_torch.lifecycle.depart", "repro_torch.lifecycle.update",
                   "repro_torch.reward", "repro_torch.ops.project",
                   "repro_torch.ops.oga_update", "repro_torch.launch"}


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.reset()
    yield
    spans.reset()


def _profiler():
    return tp.profile(activities=[tp.ProfilerActivity.CPU])


def _slot_run():
    spec, arrivals = tt.make(tt.TraceConfig(T=T, L=3, R=4, K=2, seed=3), device="cpu")
    return ogasched.run(spec, arrivals, 0.05, 0.999, backend="fused", device="cpu")


def _lifecycle_run(faults=False):
    cfg = tt.TraceConfig(T=T, L=3, R=4, K=2, seed=4, work_mean=3.0)
    spec, arrivals, works = tt.make_lifecycle(cfg, device="cpu")
    f = None
    if faults:
        f = torch.ones(T, spec.K)
        f[2:4] = 0.3
    return lifecycle.run(spec, arrivals, works, "ogasched", faults=f, device="cpu")


def test_nothing_records_outside_a_profiler():
    assert spans.span("repro_torch.x") is spans.span("repro_torch.y")
    with spans.span("repro_torch.x"):
        pass
    _slot_run()
    _lifecycle_run()
    assert spans.snapshot() == {}


def test_self_time_is_the_total_less_the_children():
    with _profiler():
        with spans.span("repro_torch.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with spans.span("repro_torch.inner"):
                    time.sleep(0.001)
                    with spans.span("repro_torch.leaf"):
                        time.sleep(0.001)
    snap = spans.snapshot()
    assert {n: c for n, (c, _, _) in snap.items()} == {
        "repro_torch.outer": 1, "repro_torch.inner": 2, "repro_torch.leaf": 2}
    for count, total, self_ns in snap.values():
        assert 0 < self_ns <= total
    outer, inner, leaf = (snap[f"repro_torch.{n}"] for n in ("outer", "inner", "leaf"))
    assert inner[1] <= outer[1] and leaf[1] <= inner[1]
    assert outer[2] == outer[1] - inner[1]
    assert inner[2] == inner[1] - leaf[1]
    assert leaf[2] == leaf[1]
    # the self times share out the outermost span's total
    assert sum(s for _, _, s in snap.values()) == outer[1]


def test_a_span_on_another_thread_does_not_nest_under_this_one():
    def work():
        with spans.span("repro_torch.other"):
            time.sleep(0.003)

    with _profiler():
        with spans.span("repro_torch.main"):
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
    snap = spans.snapshot()
    main, other = snap["repro_torch.main"], snap["repro_torch.other"]
    assert other[0] == 1 and other[1] == other[2]
    assert main[1] == main[2] and main[1] >= other[1]


def test_the_slot_loop_records_one_step_and_one_launch_a_slot():
    with _profiler():
        _slot_run()
    snap = spans.snapshot()
    assert set(snap) == SLOT_SPANS
    counts = {n: c for n, (c, _, _) in snap.items()}
    assert counts == {n: T for n in SLOT_SPANS}
    top = snap["repro_torch.oga_step"]
    assert sum(s for _, _, s in snap.values()) == top[1]


@pytest.mark.parametrize("faults", [False, True], ids=["no_faults", "faults"])
def test_the_lifecycle_records_its_phases(faults):
    with _profiler():
        _lifecycle_run(faults)
    snap = spans.snapshot()
    want = LIFECYCLE_SPANS | ({"repro_torch.lifecycle.evict"} if faults else set())
    assert set(snap) == want
    counts = {n: c for n, (c, _, _) in snap.items()}
    assert counts["repro_torch.lifecycle.segment"] == 1
    assert counts["repro_torch.lifecycle.setup"] == 1
    assert counts["repro_torch.lifecycle.step"] == T
    assert counts["repro_torch.lifecycle.record"] == T
    assert counts["repro_torch.launch"] == 2 * T
    # the admission's reward and the service rates
    assert counts["repro_torch.reward"] == 2 * T
    if faults:
        assert counts["repro_torch.lifecycle.evict"] == T
    top = snap["repro_torch.lifecycle.segment"]
    assert sum(s for _, _, s in snap.values()) == top[1]


def test_outputs_are_bit_for_bit_the_same_under_the_profiler():
    plain_slot, plain_lc = _slot_run(), _lifecycle_run(faults=True)
    with _profiler():
        traced_slot, traced_lc = _slot_run(), _lifecycle_run(faults=True)
    for a, b in zip(plain_slot, traced_slot):
        assert torch.equal(a, b)
    for f in lifecycle.LifecycleTrace.FIELDS:
        assert torch.equal(getattr(plain_lc, f), getattr(traced_lc, f)), f


def test_every_span_is_a_user_annotation_of_the_chrome_trace(tmp_path):
    with _profiler() as prof:
        _slot_run()
        _lifecycle_run(faults=True)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            annotated[e["name"]] = annotated.get(e["name"], 0) + 1
    snap = spans.snapshot()
    assert all(n.startswith("repro_torch.") for n in snap)
    assert {n: annotated.get(n) for n in snap} == {n: c for n, (c, _, _) in snap.items()}
