"""``correct`` has to come out false for the control (the reference in
bfloat16 in the program's place) and for each fault a cell can have,
planted under a tiny run on the CPU: a step that returns its state
unchanged, half of the batch left out with the rest doubled, an answer
altered where it is produced. (A cell of one chip has no exchange between
chips to leave out.)"""
import pytest
import torch

from chipbench import harness

TINY = {"config": {"L": 10, "R": 64, "segment_slots": 6}, "traffic": {"work_mean": 300.0}}
SEED = 91


def _run(cell, **kw):
    return harness.run_cell(cell, SEED, 0.2, False, device="cpu", overrides=TINY, **kw)


@pytest.mark.parametrize("cell", ["ogasched-r1024.fig5", "lifecycle-r128.heavy"])
def test_the_control_is_not_correct(cell):
    out = _run(cell, control=True)
    # the program's run beside it is sound; the control, judged alike, is not
    assert out["result"]["correct"] is True
    control = out["info"]["control"]
    assert control["correct"] is False and control["failed"] >= 1
    judged = harness.judge(control["numbers"], [], harness.cell(cell)["cell"]["limits"])
    assert judged == (False, 0)


def _unchanged_slot(orig):
    return lambda spec, y, x, eta, **kw: y


def _unchanged_batch(orig):
    return lambda spec, y, x, eta, **kw: y


def _half_reward(orig):
    def total_reward(spec, x, y):
        keep = torch.arange(x.shape[-1]) < x.shape[-1] // 2
        return 2.0 * orig(spec, x * keep, y)
    return total_reward


def _altered(orig):
    def fn(*args, **kwargs):
        out = orig(*args, **kwargs).clone(memory_format=torch.contiguous_format)
        out.view(-1)[out.numel() // 2] += 0.5
        return out
    return fn


FAULTS = {
    ("ogasched-r1024.fig5", "unchanged"): ("repro_torch.kernels.ops", "oga_update_spec",
                                           _unchanged_slot),
    ("ogasched-r1024.fig5", "half"): ("repro_torch.core.reward", "total_reward", _half_reward),
    ("ogasched-r1024.fig5", "altered"): ("repro_torch.kernels.ops", "oga_update_spec", _altered),
    ("lifecycle-r128.heavy", "unchanged"): ("repro_torch.kernels.ops", "oga_update_batch",
                                             _unchanged_batch),
    ("lifecycle-r128.heavy", "half"): ("repro_torch.core.reward", "total_reward",
                                        _half_reward),
    ("lifecycle-r128.heavy", "altered"): ("repro_torch.core.projection", "project_spec_rows",
                                           _altered),
}


@pytest.mark.parametrize("cell,fault", list(FAULTS), ids=["-".join(k) for k in FAULTS])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    import importlib

    module, name, make = FAULTS[cell, fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    assert _run(cell)["result"]["correct"] is False
