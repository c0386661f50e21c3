"""The port's training loss and its gradient on the CPU against the JAX
package, at the ten reduced configs (float32, head dim 16): the same
parameters (``convert.params_from_reference``) and the same numpy tokens
through ``repro_torch.models.model.loss_fn`` / ``train_step.value_and_grad``
and ``jax.value_and_grad(repro.models.model.loss_fn)``. Attention's
gradient here is ``ref.flash_attention_bwd_ref`` under
``models.attention.FlashAttention``, the formulas of the backward kernels.
Also remat, the shape trees (``param_shapes``, ``input_specs``,
``opt_specs``) and the training CLI.

Tolerances. The loss within 1e-5 relative. Each gradient leaf within 1e-4
of its largest magnitude of the reference's; where the reference's
float32 gradient is itself further than that from its float64 gradient
(``jax.enable_x64``; reduced hymba-1.5b, whose first layer's SSM and
attention gradients read up to 1.8e-4 from float64 while the port's read
4.1e-5), the port's leaf is held within 1e-4 of the float64 one instead.
Remat off, "full" and "dots" give equal losses and gradients, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import base as jconfigs
from repro.configs import shapes as jshapes
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.ckpt.checkpoint import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import train_step as tts

LOSS_RTOL = 1e-5
GRAD_RTOL_OF_MAX = 1e-4
ARCHS = ("stablelm-3b", "gemma2-27b", "qwen2-72b", "starcoder2-15b", "dbrx-132b",
         "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b", "qwen2-vl-7b", "musicgen-medium")
B, S = 2, 32


def _pair(arch, **overrides):
    jcfg = jconfigs.reduced(jconfigs.get(arch), **overrides)
    tcfg = tconfigs.reduced(tconfigs.get(arch), **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _batches(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    if cfg.family == "vlm":
        pe = rng.standard_normal((B, cfg.n_patches, TM.PATCH_DIM)).astype(np.float32)
        jb["patch_embeds"], tb["patch_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    return jb, tb


def _reference_f64_grads(jcfg, jp, jb):
    """The reference's gradient with parameters and compute in float64."""
    with jax.enable_x64(True):
        cfg64 = dataclasses.replace(jcfg, param_dtype="float64", compute_dtype="float64")
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), jp)
        g = jax.grad(JM.loss_fn)(p64, cfg64, jb)
        return jax.tree_util.tree_map(np.asarray, g)


def _hold_grads(tcfg, got, jgrads, f64=None):
    """Every leaf of the port's gradient within GRAD_RTOL_OF_MAX of the
    reference's; ``f64`` (a thunk) gives the float64 yardstick where the
    reference's float32 leaf is itself off it. Returns the leaves so held."""
    want = convert.params_from_reference(tcfg, jax.tree_util.tree_map(np.asarray, jgrads), "cpu")
    names, got_l = _flatten_with_names(got)
    _, want_l = _flatten_with_names(want)
    assert len(got_l) == len(want_l)
    off, g64 = [], None
    for name, g, w in zip(names, got_l, want_l):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = float(w.abs().max())
        if float((g - w).abs().max()) <= GRAD_RTOL_OF_MAX * scale:
            continue
        if g64 is None:
            g64 = dict(zip(*_flatten_with_names(
                convert.params_from_reference(tcfg, f64(), "cpu"))))
        w64 = g64[name]
        ref_err = float((w.double() - w64).abs().max())
        assert ref_err > GRAD_RTOL_OF_MAX * scale, (name, "reference within its own bar")
        assert float((g.double() - w64).abs().max()) <= GRAD_RTOL_OF_MAX * float(w64.abs().max()), name
        off.append(name)
    return off


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batches(jcfg)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, jcfg, jb)
    tl, tg = tts.value_and_grad(tp, tcfg, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    off = _hold_grads(tcfg, tg, jg, lambda: _reference_f64_grads(jcfg, jp, jb))
    if arch != "hymba-1.5b":
        assert not off, off


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_loss_matches_reference(arch):
    """logits_chunk 8 divides S = 32: four checkpointed chunks."""
    jcfg, tcfg, jp, tp = _pair(arch, logits_chunk=8)
    jb, tb = _batches(jcfg, seed=2)
    want = float(JM.loss_fn(jp, jcfg, jb))
    got = TM.loss_fn(tp, tcfg, tb)
    assert float(got) == pytest.approx(want, rel=LOSS_RTOL)
    # the unchunked loss is the same function
    unchunked = TM.loss_fn(tp, dataclasses.replace(tcfg, logits_chunk=0), tb)
    assert float(got) == pytest.approx(float(unchunked), rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma2-27b"])
def test_chunked_grads_match_reference(arch):
    """gemma2 adds the final softcap inside each chunk."""
    jcfg, tcfg, jp, tp = _pair(arch, logits_chunk=16)
    jb, tb = _batches(jcfg, seed=3)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, jcfg, jb)
    tl, tg = tts.value_and_grad(tp, tcfg, tb)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert not _hold_grads(tcfg, tg, jg)


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma2-27b", "dbrx-132b", "hymba-1.5b"])
def test_remat_changes_no_value(arch):
    tcfg = tconfigs.reduced(tconfigs.get(arch))
    params = TM.init_params(tcfg, 0, "cpu")
    _, tb = _batches(tcfg)
    out = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        loss, grads = tts.value_and_grad(params, cfg, tb)
        out[remat, policy] = (loss, tree_leaves(grads))
    base_loss, base_grads = out[False, "full"]
    for loss, grads in out.values():
        assert torch.equal(loss, base_loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, base_grads))


def test_remat_runs_the_block_again_in_the_backward_pass(monkeypatch):
    """Under "full" remat each layer's forward runs twice in a train step
    (forward, then recompute); without remat once."""
    from repro_torch.models import transformer as ttf

    calls = []
    orig = ttf.block_forward
    monkeypatch.setattr(ttf, "block_forward",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    tcfg = tconfigs.reduced(tconfigs.get("stablelm-3b"))
    params = TM.init_params(tcfg, 0, "cpu")
    _, tb = _batches(tcfg)
    for remat, want in ((True, 2 * tcfg.n_layers), (False, tcfg.n_layers)):
        calls.clear()
        tts.value_and_grad(params, dataclasses.replace(tcfg, remat=remat), tb)
        assert len(calls) == want
    with torch.no_grad():  # serving: never checkpointed
        calls.clear()
        TM.forward(params, tcfg, tb)
        assert len(calls) == tcfg.n_layers
    calls.clear()  # nor in grad mode when nothing requires a gradient
    assert TM.forward(params, tcfg, tb).grad_fn is None
    assert len(calls) == tcfg.n_layers


def _shape_tree(tree):
    names, leaves = _flatten_with_names(tree)
    return {n: (tuple(x.shape), str(x.dtype).replace("torch.", "")) for n, x in zip(names, leaves)}


def _jax_shape_tree(cfg_n_layers, tree, stacked=("['blocks']",)):
    """The reference's ShapeDtypeStruct tree, its stacked block leaves
    unstacked into per-layer names, as the port names them."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = jax.tree_util.keystr(path)
        dt = str(x.dtype)
        pre = next((p for p in stacked if name.startswith(p)), None)
        if pre is not None:
            rest = name[len(pre):]
            for i in range(cfg_n_layers):
                out[f"{pre}[{i}]{rest}"] = (tuple(x.shape[1:]), dt)
        else:
            out[name] = (tuple(x.shape), dt)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference(arch):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    if arch == "kimi-k2-1t-a32b":  # 61 layers of 384 experts: two layers say as much
        tcfg, jcfg = (dataclasses.replace(c, n_layers=2) for c in (tcfg, jcfg))
    got = TM.param_shapes(tcfg)
    assert all(x.device.type == "meta" for x in tree_leaves(got))
    assert _shape_tree(got) == _jax_shape_tree(jcfg.n_layers, JM.param_shapes(jcfg))


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen2-vl-7b", "hymba-1.5b", "mamba2-780m"])
@pytest.mark.parametrize("shape", list(tshapes.SHAPES))
def test_input_specs_match_reference(arch, shape):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    if not tshapes.applicable(tcfg, tshapes.SHAPES[shape])[0]:
        assert not jshapes.applicable(jcfg, jshapes.SHAPES[shape])[0]
        return
    got = tts.input_specs(tcfg, tshapes.SHAPES[shape])
    want = jts.input_specs(jcfg, jshapes.SHAPES[shape])
    assert tts.cache_len_for(tcfg, tshapes.SHAPES[shape]) == jts.cache_len_for(
        jcfg, jshapes.SHAPES[shape])
    g, w = _shape_tree(got), _jax_shape_tree(0, want, stacked=())
    # the port's decode cache carries kpos with the cache, as the reference's
    assert g == w


def test_opt_specs_match_reference():
    tcfg, jcfg = tconfigs.get("stablelm-3b"), jconfigs.get("stablelm-3b")
    got = tts.opt_specs(tcfg, AdamWConfig(state_dtype="float32"))
    want = jts.opt_specs(jcfg, JAdamWConfig(state_dtype="float32"))
    assert _shape_tree(got) == _jax_shape_tree(jcfg.n_layers, want,
                                                stacked=("['m']['blocks']", "['v']['blocks']"))


def test_shapes_cells_match_reference():
    names = sorted(tconfigs.names())
    got = [(c.name, s.name, ok) for c, s, ok, _ in tshapes.cells(names)]
    want = [(c.name, s.name, ok) for c, s, ok, _ in jshapes.cells(names)]
    assert got == want and len(got) == 40


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    out = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "3", "--ckpt-dir",
                        str(tmp_path / "ck")])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    text = capsys.readouterr().out
    assert "step     0  loss" in text and text.strip().splitlines()[-1].startswith("done: loss")
    # the full config is the default, as in the reference's CLI
    args = tlaunch.parser().parse_args([])
    cfg, opt, data, tc = tlaunch.build(args)
    assert cfg == tconfigs.get("stablelm-3b") and not args.smoke
    assert (opt.lr, opt.warmup_steps, opt.total_steps) == (3e-3, 20, 200)
    assert (data.global_batch, data.seq_len, tc.ckpt_every) == (8, 128, 50)
