"""The port's Trainer (``repro_torch.train.trainer``) on the CPU: against the
reference's Trainer from the same initial parameters, and twins of the
restart, compression-convergence and straggler-monitor tests of
``tests/test_substrate.py``.

Tolerance: every loss of an 8-step run within 1e-4 relative of the
reference's (each step's float32 differences, ~1e-6 relative in the
loss and ~1e-6 of the largest gradient, compound through AdamW). The
restart is bit for bit: a resumed run repeats the uninterrupted one
exactly (the reference holds its own to 1e-5 and 1e-6).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import base as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import base as configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.trainer import StragglerMonitor, TrainConfig, Trainer

LOSS_RTOL = 1e-4


def _tiny_cfg():
    return configs.reduced(configs.get("stablelm-3b"), n_layers=2, d_model=32, n_heads=2,
                           n_kv=2, head_dim=16, d_ff=64, vocab=64)


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma2-27b"])
def test_trainer_matches_reference_trainer(arch, tmp_path):
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    tcfg = configs.reduced(configs.get(arch))
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=8)
    dkw = dict(vocab=jcfg.vocab, global_batch=4, seq_len=32, seed=0)
    want = JTrainer(jcfg, JAdamWConfig(**kw), JDataConfig(**dkw),
                    JTrainConfig(steps=8, ckpt_dir=str(tmp_path / "j"), ckpt_every=100)).run()
    # the reference trainer's own initial draw, carried across
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = Trainer(tcfg, AdamWConfig(**kw), DataConfig(**dkw),
                  TrainConfig(steps=8, ckpt_dir=str(tmp_path / "t"), ckpt_every=100),
                  device="cpu").run(params=tp)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, atol=0)
    assert int(got["state"]["opt"]["step"]) == 8


def test_trainer_checkpoint_restart_bit_exact(tmp_path):
    """Kill training at step 5 (after the step-4 checkpoint) and resume:
    the last 3 losses and the params equal the uninterrupted run's."""
    cfg = _tiny_cfg()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    data = DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=16, seed=0)
    ref = Trainer(cfg, opt, data, TrainConfig(steps=8, ckpt_dir=str(tmp_path / "ref"),
                                              ckpt_every=4), device="cpu").run()
    tc = TrainConfig(steps=8, ckpt_dir=str(tmp_path / "ft"), ckpt_every=4)
    with pytest.raises(RuntimeError, match="injected failure"):
        Trainer(cfg, opt, data, tc, device="cpu").run(hooks={"inject_failure": lambda s: s == 5})
    resumed = Trainer(cfg, opt, data, tc, device="cpu").run()
    assert len(resumed["losses"]) == 4  # steps 4..7 from the step-4 checkpoint
    assert resumed["losses"][-3:] == ref["losses"][-3:]
    for a, b in zip(tree_leaves(ref["state"]), tree_leaves(resumed["state"])):
        assert torch.equal(a, b)


def test_trainer_with_compression_converges(tmp_path):
    cfg = _tiny_cfg()
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=40)
    data = DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=16, seed=0)
    tc = TrainConfig(steps=25, ckpt_dir=str(tmp_path / "c"), ckpt_every=100,
                     compress_grads=True)
    out = Trainer(cfg, opt, data, tc, device="cpu").run()
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    assert set(out["state"]) == {"params", "opt", "err"}


def test_trainer_hooks_see_every_step(tmp_path):
    cfg = _tiny_cfg()
    seen = []
    Trainer(cfg, AdamWConfig(warmup_steps=1, total_steps=3),
            DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=8),
            TrainConfig(steps=3, ckpt_dir=str(tmp_path), ckpt_every=100), device="cpu").run(
        hooks={"on_step": lambda step, loss, dt, slow: seen.append((step, loss, slow))})
    assert [s for s, _, _ in seen] == [0, 1, 2]
    assert all(np.isfinite(loss) for _, loss, _ in seen)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(alpha=0.9, k=3.0)
    for i in range(50):
        mon.observe(i, 0.1 + 0.001 * (i % 3))
    assert not mon.flags
    assert mon.observe(50, 1.5)  # 15x the EWMA -> flagged
    assert 50 in mon.flags


def test_straggler_monitor_matches_reference():
    from repro.train.trainer import StragglerMonitor as JMonitor

    rng = np.random.default_rng(0)
    times = np.abs(rng.standard_normal(200)) * 0.01 + 0.1
    times[[40, 90, 91, 150]] *= 5
    a, b = StragglerMonitor(0.8, 2.5), JMonitor(0.8, 2.5)
    assert [a.observe(i, float(t)) for i, t in enumerate(times)] == \
        [b.observe(i, float(t)) for i, t in enumerate(times)]
    assert a.flags == b.flags and a.mean == b.mean and a.var == b.var


def test_training_entry_points_without_device_raise_on_a_cpu_only_host(monkeypatch, tmp_path):
    """No ``device`` means the CUDA card; without one the training entry
    points raise instead of carrying on on the CPU."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train as tlaunch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    data = DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=8)
    calls = [
        lambda: pipeline.batch_at(data, 0),
        lambda: Trainer(cfg, AdamWConfig(), data, TrainConfig(ckpt_dir=str(tmp_path))),
        lambda: tlaunch.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_opt_state_from_reference_steps_like_the_reference():
    """The reference's AdamW state after one step, carried across by
    ``convert.opt_state_from_reference``: unstacked like the port's own
    state, and one more update from it on both packages (the reference's
    gradients, converted) lands on the same parameters and moments within
    1e-6 of each leaf's largest magnitude."""
    from repro.optim import adamw as jadamw
    from repro_torch.ckpt.checkpoint import _flatten_with_names
    from repro_torch.optim import adamw as tadamw

    jcfg = jconfigs.reduced(jconfigs.get("stablelm-3b"))
    tcfg = configs.reduced(configs.get("stablelm-3b"))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt, topt = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jg = jax.grad(JM.loss_fn)(jp, jcfg, batch)
    jp1, jst1 = jadamw.adamw_update(jopt, jg, jadamw.adamw_init(jopt, jp), jp)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tst = convert.opt_state_from_reference(tcfg, to_np(jst1), "cpu")
    tp1 = convert.params_from_reference(tcfg, to_np(jp1), "cpu")
    own = tadamw.adamw_init(topt, tp1)
    assert _flatten_with_names(own)[0] == _flatten_with_names(tst)[0]
    assert tst["step"].dtype == torch.int32 and int(tst["step"]) == 1
    jp2, jst2 = jadamw.adamw_update(jopt, jg, jst1, jp1)
    tp2, tst2 = tadamw.adamw_update(topt, convert.params_from_reference(tcfg, to_np(jg), "cpu"),
                                    tst, tp1)
    for got, want in ((tp2, jp2), (tst2["m"], jst2["m"]), (tst2["v"], jst2["v"])):
        want = convert.params_from_reference(tcfg, to_np(want), "cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
