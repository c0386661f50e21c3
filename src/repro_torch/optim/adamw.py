"""AdamW with global-norm clipping and a cosine schedule, over the port's
parameter trees (dicts, with ``blocks`` a list of per-layer dicts).

Counterpart of ``repro.optim.adamw``. The moments' dtype follows
``state_dtype`` (None: each leaf's own dtype). The update of a leaf runs in
float32 and is cast back, as the reference's ``upd_block`` does. The
reference maps that update over the stacked layer axis (``lax.map``) so
float32 temporaries stay one layer in size; the port's blocks are a list
already, so it updates leaf by leaf and its temporaries are one leaf in
size. Plain torch: the reference's update is jnp outside any kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    state_dtype: Optional[str] = None  # None = follow param dtype


def tree_map(fn, *trees):
    """``fn`` over the leaves of one or more trees of the same structure
    (dicts and lists; any other object is a leaf)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, dict entries in sorted key order (JAX's
    flattening order, so sums over leaves add in the reference's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), float32: linear
    warm-up over ``warmup_steps``, then a cosine down to ``min_lr_ratio``
    of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(cfg: AdamWConfig, params: Any) -> dict:
    """Zero moments ``m`` and ``v`` shaped like ``params`` (in
    ``state_dtype``, or each leaf's dtype) on the leaves' devices, and
    ``step`` an int32 0 on the first leaf's device."""
    def zeros(p):
        dt = getattr(torch, cfg.state_dtype) if cfg.state_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads: Any, opt_state: dict,
                 params: Any) -> tuple[Any, dict]:
    """One AdamW step: gradients clipped to global norm ``clip_norm``,
    bias-corrected moments, decoupled weight decay, the learning rate of
    ``schedule`` at the new step. Returns (new params, new state); nothing
    is updated in place."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2t = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        p32 = p.to(torch.float32)
        g32 = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g32)
        delta = (m32 / b1t) / (torch.sqrt(v32 / b2t) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return tree_pick(out, 0), {"m": tree_pick(out, 1), "v": tree_pick(out, 2), "step": step}


def tree_pick(tree, i: int):
    """Entry i of every tuple leaf of a tree of dicts and lists (the
    i-th output of a ``tree_map`` whose function returns a tuple)."""
    if isinstance(tree, dict):
        return {k: tree_pick(x, i) for k, x in tree.items()}
    if isinstance(tree, list):
        return [tree_pick(x, i) for x in tree]
    return tree[i]
