"""Step factories (train, prefill, serve) and input specs.

Counterpart of ``repro.train.train_step``. The reference's factories return
functions that its launchers jit; the port's return the same functions
run eagerly. The specs are ``meta`` tensors where the reference has
``jax.ShapeDtypeStruct``s: shapes and dtypes, no allocation.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map


def value_and_grad(params, cfg: ArchConfig, batch: dict):
    """(loss, grads) of ``M.loss_fn`` at ``params``: the gradient by
    ``torch.autograd.grad`` over the parameter leaves, as a tree like
    ``params`` (a leaf the loss does not reach gets zeros)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = M.loss_fn(live, cfg, batch)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], live)


def make_train_step(cfg: ArchConfig, opt: AdamWConfig):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    the loss and its gradient, then one AdamW update."""

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, cfg, batch)
        params, opt_state = adamw_update(opt, grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            return M.prefill(params, cfg, batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return M.serve_step(params, cfg, cache, tokens, pos)

    return serve_step


# ----------------------------------------------------------- input specs ---
def cache_len_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """long_500k on windowed configs keeps the ring-buffer window only (the
    sub-quadratic requirement); decode_32k keeps the full cache."""
    if shape.name == "long_500k" and cfg.window:
        return cfg.window
    return shape.seq_len


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for every model input of a cell (no allocation).
    Token ids are int32, as the reference's."""
    B, S = shape.global_batch, shape.seq_len
    dt = M.compute_dtype(cfg)
    if shape.kind in ("train", "prefill"):
        s_text = S - cfg.n_patches
        specs = {"tokens": _spec((B, s_text), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _spec((B, s_text), torch.int32)
        if cfg.family == "vlm":
            specs["patch_embeds"] = _spec((B, cfg.n_patches, M.PATCH_DIM), dt)
        return {"batch": specs}
    # decode: one new token against a cache of seq_len
    cache = tf.init_cache(cfg, B, cache_len_for(cfg, shape), dt, "meta")
    return {"cache": cache, "tokens": _spec((B, 1), torch.int32),
            "pos": _spec((), torch.int32)}


def opt_specs(cfg: ArchConfig, opt: AdamWConfig) -> dict:
    """The optimizer state of ``M.param_shapes(cfg)`` as ``meta`` tensors."""
    return adamw_init(opt, M.param_shapes(cfg))
