"""The slot's CUDA-graph replay (``repro_torch.core.slot_graph``) on the CPU:
its key and engage rule as pure functions, the capture and re-capture rule
of ``run`` over a stand-in graph, no capture off the card, and
``ogasched.oga_step`` on the CPU against the eager slot and the reference.
The graphs themselves run in ``tests/test_torch_cuda.py``.

Tolerances: none against the eager slot (the same function); against the
reference's slot, 1e-5 of the largest |y| and |q| (float32 sums in another
order, as ``tests/test_torch_ogasched.py`` holds a whole run).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core import ogasched as jog
from repro.sched import trace as jtrace
from repro_torch import convert, spans
from repro_torch.core import ogasched, slot_graph
from repro_torch.kernels import ops

CFG = dict(T=12, L=5, R=8, K=4, seed=3, contention=10.0)
DECAY = 0.999


@pytest.fixture(autouse=True)
def fresh_graphs():
    slot_graph.reset()
    yield
    slot_graph.reset()


def _problem():
    jspec, jarr = jtrace.make(jtrace.TraceConfig(**CFG))
    return jspec, jarr, convert.spec_from_reference(jspec, "cpu"), \
        convert.tensor_from_numpy(jarr, "cpu")


@pytest.fixture
def slot():
    """A spec, its operands, and the state and arrivals of its second slot
    (y(2) in the fused update's layout)."""
    _, _, spec, arr = _problem()
    operands = ops.pack_spec_operands(spec)
    state = ogasched.init_state(spec, 5.0)
    state, _ = ogasched.oga_step(spec, state, arr[0], DECAY, "fused", operands)
    return spec, operands, state, arr


def _key(spec, operands, state, x, decay=DECAY, backend="fused"):
    return slot_graph.key(spec, state.y, x, state.eta, decay, backend, operands)


# ------------------------------------------------------------------- key --
def test_the_key_is_a_function_of_what_the_graph_reads(slot):
    spec, operands, state, arr = slot
    k = _key(spec, operands, state, arr[1])
    assert k is not None and k[0] == state.y.device
    assert k == _key(spec, operands, state, arr[1])
    # the inputs are copied in: other values in the same layout, same key
    same_layout = dataclasses.replace(state, y=state.y * 2.0, eta=state.eta + 1.0)
    assert _key(spec, operands, same_layout, arr[2]) == k
    assert _key(spec, operands, state, arr[1], backend="auto") == k


@pytest.mark.parametrize("change", [
    "new_operands", "new_spec_field", "new_decay", "decay_type", "y_layout", "x_dtype",
    "eta_dtype", "spec_shape"])
def test_the_key_changes_with_what_the_graph_reads(change, slot):
    spec, operands, state, arr = slot
    x, decay = arr[1], DECAY
    k = _key(spec, operands, state, x)
    if change == "new_operands":
        operands = ops.pack_spec_operands(spec)
    elif change == "new_spec_field":
        spec = dataclasses.replace(spec, c=spec.c.clone())
    elif change == "new_decay":
        decay = 0.998
    elif change == "decay_type":
        decay = torch.tensor(DECAY)
    elif change == "y_layout":
        state = dataclasses.replace(state, y=state.y.contiguous())
    elif change == "x_dtype":
        x = x.to(torch.int32)
    elif change == "eta_dtype":
        state = dataclasses.replace(state, eta=state.eta.double())
    else:
        # one instance fewer
        spec = dataclasses.replace(spec, mask=spec.mask[:, :-1].contiguous(),
                                   c=spec.c[:-1].contiguous(), alpha=spec.alpha[:-1].contiguous())
        state = dataclasses.replace(state, y=state.y[:, :-1].contiguous())
        operands = ops.pack_spec_operands(spec)
    assert _key(spec, operands, state, x, decay) not in (None, k)


@pytest.mark.parametrize("case", [
    "reference", "no_operands", "y_requires_grad", "spec_requires_grad",
    "operand_requires_grad", "x_on_another_device", "x_not_dense", "eta_not_a_tensor",
    "decay_not_a_number"])
def test_no_key_where_no_graph_may_run_the_slot(case, slot):
    spec, operands, state, arr = slot
    x, decay, backend = arr[1], DECAY, "fused"
    if case == "reference":
        backend = "reference"
    elif case == "no_operands":
        operands = None
    elif case == "y_requires_grad":
        state = dataclasses.replace(state, y=state.y.clone().requires_grad_())
    elif case == "spec_requires_grad":
        spec = dataclasses.replace(spec, alpha=spec.alpha.clone().requires_grad_())
    elif case == "operand_requires_grad":
        operands = (operands[0].clone().requires_grad_(), *operands[1:])
    elif case == "x_on_another_device":
        x = x.to("meta")
    elif case == "x_not_dense":
        x = arr[1, :1].expand(CFG["L"])
    elif case == "eta_not_a_tensor":
        state = dataclasses.replace(state, eta=5.0)
    else:
        decay = "0.999"
    assert _key(spec, operands, state, x, decay, backend) is None


# ----------------------------------------------------------------- action --
def test_the_engage_rule():
    a, b = ("a",), ("b",)
    assert slot_graph.action(None, None, None) == "eager"
    assert slot_graph.action(a, a, None) == "eager"
    assert slot_graph.action(None, None, a) == "eager"       # a first call
    assert slot_graph.action(None, a, a) == "capture"        # a key that repeats
    assert slot_graph.action(a, a, a) == "replay"
    assert slot_graph.action(a, b, a) == "replay"            # the graph's key, whatever came before
    assert slot_graph.action(a, a, b) == "eager"             # a new key runs eagerly first
    assert slot_graph.action(a, b, b) == "capture"           # and is captured once it repeats


class _StandInGraph:
    """Records the captures and replays ``run`` asks for and runs the slot
    eagerly in their place."""

    made = []

    def __init__(self, k, slot, spec, y, x, eta, decay, backend, operands):
        self.key, self.slot = k, slot
        self.args = (spec, decay, backend, operands)
        self.replays = 0
        _StandInGraph.made.append(self)

    def replay(self, y, x, eta):
        self.replays += 1
        spec, decay, backend, operands = self.args
        return self.slot(spec, y, x, eta, decay, backend, operands)


@pytest.fixture
def on_a_card(monkeypatch):
    """``run`` as on a card: keys name CUDA device 0, graphs are stand-ins."""
    real_key = slot_graph.key

    def key(*args):
        k = real_key(*args)
        return None if k is None else (torch.device("cuda", 0),) + k[1:]

    _StandInGraph.made = []
    monkeypatch.setattr(slot_graph, "key", key)
    monkeypatch.setattr(slot_graph, "SlotGraph", _StandInGraph)
    return _StandInGraph.made


def _steps(spec, operands, arr, decays):
    """oga_step over the slots, slot t with ``decays[t]``; the rewards."""
    state = ogasched.init_state(spec, 5.0)
    rewards = []
    for t, decay in enumerate(decays):
        state, q = ogasched.oga_step(spec, state, arr[t], decay, "fused", operands)
        rewards.append(q)
    return torch.stack(rewards)


def test_one_cluster_captures_on_its_first_repeat(on_a_card):
    _, _, spec, arr = _problem()
    operands = ops.pack_spec_operands(spec)
    got = _steps(spec, operands, arr, [DECAY] * CFG["T"])
    # slot 0 sees the zero start's contiguous y, slot 1 the update's layout
    # first, slot 2 repeats it
    assert slot_graph.counts == {"eager": 2, "captures": 1, "replays": CFG["T"] - 2}
    assert len(on_a_card) == 1 and on_a_card[0].replays == CFG["T"] - 2
    assert list(slot_graph._graphs) == [torch.device("cuda", 0)]
    slot_graph.reset()
    want = ogasched.run(spec, arr, 5.0, DECAY, backend="fused", device="cpu")[0]
    assert torch.equal(got, want)


def test_alternating_keys_never_capture(on_a_card):
    _, _, spec, arr = _problem()
    operands = ops.pack_spec_operands(spec)
    _steps(spec, operands, arr, [DECAY, 0.998] * (CFG["T"] // 2))
    assert slot_graph.counts == {"eager": CFG["T"]}
    assert on_a_card == []


def test_a_new_key_recaptures_once_it_repeats(on_a_card):
    _, _, spec, arr = _problem()
    operands = ops.pack_spec_operands(spec)
    # A A A (captured) | B (eager) | A (replays A) | B B (B captured, A freed) | A A
    decays = [DECAY] * 3 + [0.998, DECAY, 0.998, 0.998, DECAY, DECAY]
    _steps(spec, operands, arr, decays)
    assert slot_graph.counts == {"eager": 5, "captures": 3, "replays": 4}
    assert [g.replays for g in on_a_card] == [2, 1, 1]
    assert [g.key[1] for g in on_a_card] == [(float, DECAY), (float, 0.998), (float, DECAY)]
    # one graph a device: the last one captured
    assert list(slot_graph._graphs.values()) == [on_a_card[-1]]


def test_a_graph_goes_with_the_first_tensor_it_reads_that_is_freed():
    dev = torch.device("cuda", 0)
    graph, other = _StandInGraph(*[None] * 9), _StandInGraph(*[None] * 9)
    a, b = torch.zeros(3), torch.zeros(2)
    slot_graph._graphs[dev] = graph
    slot_graph._free_with(graph, dev, (a, b))
    del a
    assert slot_graph._graphs == {}
    # a graph that was replaced leaves its successor in place
    slot_graph._graphs[dev] = other
    del b
    assert slot_graph._graphs == {dev: other}


# ------------------------------------------------------------ on the CPU --
@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_no_capture_on_the_cpu(backend):
    _, _, spec, arr = _problem()
    ogasched.run(spec, arr, 5.0, DECAY, backend=backend, device="cpu")
    assert slot_graph.counts == {"eager": CFG["T"]}
    assert slot_graph._graphs == {}


def test_no_capture_under_grad():
    _, _, spec, arr = _problem()
    operands = ops.pack_spec_operands(spec)
    state = ogasched.init_state(spec, 5.0)
    state = dataclasses.replace(state, eta=state.eta.clone().requires_grad_())
    for t in range(3):
        state, _ = ogasched.oga_step(spec, state, arr[t], DECAY, "fused", operands)
    assert slot_graph.counts == {"eager": 3}


def test_oga_step_on_the_cpu_is_the_eager_slot_and_the_reference():
    jspec, jarr, spec, arr = _problem()
    operands = ops.pack_spec_operands(spec)
    state = ogasched.init_state(spec, 5.0)
    jstate = jog.init_state(jspec, 5.0)
    y, eta = state.y, state.eta
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.reset()
        for t in range(CFG["T"]):
            state, q = ogasched.oga_step(spec, state, arr[t], DECAY, "fused", operands)
            y, q_eager, eta = ogasched._slot(spec, y, arr[t], eta, DECAY, "fused", operands)
            assert torch.equal(state.y, y) and torch.equal(q, q_eager)
            assert torch.equal(state.eta, eta) and state.t == t + 1
            jstate, jq = jog.oga_step(jspec, jstate, jnp.asarray(jarr[t]), DECAY, "fused",
                                      None)
            jy = np.asarray(jstate.y)
            np.testing.assert_allclose(state.y.numpy(), jy, rtol=0,
                                       atol=1e-5 * max(np.abs(jy).max(), 1.0))
            np.testing.assert_allclose(float(q), float(jq), rtol=1e-5, atol=1e-5)
        snap = spans.snapshot()
    spans.reset()
    assert snap[ogasched.STEP_SPAN][0] == CFG["T"]
    assert slot_graph.REPLAY_SPAN not in snap
