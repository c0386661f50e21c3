"""GPipe-style pipeline parallelism over a mesh axis.

Counterpart of ``repro.models.pipeline``. Stages live on the mesh's
'model' axis (stage s holds layers [s L/S, (s + 1) L/S) and runs on the
s-th device along it); microbatches stream through in GPipe's tick order:
at tick t, stage s works on microbatch m = t - s. An activation moves from
stage to stage with ``.to`` (the reference's ppermute), and the last
stage's outputs are the result (its masked psum). The backward pass is
autograd's, through the same blocks (and, on the card, through
``models.attention.FlashAttention``'s backward kernels).

The reference runs every stage at every tick inside one shard_map, so at
the (S - 1) bubble ticks of each stage it computes garbage on a clipped
input and masks it: neither its output nor its gradient reads those
values. One process has no lockstep to keep, so the port runs only the
active (tick, stage, microbatch) triples, ``schedule``'s, and skips the
bubbles.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.train.meshctx import Mesh


def schedule(n_stages: int, n_micro: int) -> list[tuple[int, int, int]]:
    """The active (tick, stage, microbatch) triples in tick order, stages
    in order within a tick: stage s works on microbatch t - s at tick t
    when 0 <= t - s < n_micro, over n_micro + n_stages - 1 ticks."""
    return [(t, s, t - s) for t in range(n_micro + n_stages - 1)
            for s in range(n_stages) if 0 <= t - s < n_micro]


def _to(p, dev):
    if isinstance(p, dict):
        return {k: _to(v, dev) for k, v in p.items()}
    return p.to(dev)


def pipeline_forward(blocks: list[dict], cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor, mesh: Mesh, n_micro: int) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), on x's device, through ``cfg.n_layers``
    layers split into ``mesh.shape["model"]`` stages with ``n_micro``
    microbatches. Every microbatch takes ``positions[:B / n_micro]``, as
    in the reference. The blocks run without remat (GPipe keeps each
    microbatch's activations). Raises ``ValueError`` when the layers do
    not divide over the stages or the batch over the microbatches."""
    n_stages = mesh.shape["model"]
    B = x.shape[0]
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not divide into {n_stages} stages")
    if B % n_micro:
        raise ValueError(f"batch {B} does not divide into {n_micro} microbatches")
    per = cfg.n_layers // n_stages
    windows = tf.layer_windows(cfg)
    devs = [mesh.device(model=s) for s in range(n_stages)]
    stages = [[(_to(blocks[i], devs[s]), windows[i]) for i in range(s * per, (s + 1) * per)]
              for s in range(n_stages)]
    pos = [positions[:B // n_micro].to(d) for d in devs]
    acts = list(x.split(B // n_micro))
    for _, s, m in schedule(n_stages, n_micro):
        h = acts[m].to(devs[s])  # the ppermute from stage s - 1
        for p, w in stages[s]:
            h, _ = tf.block_forward(p, cfg, h, pos[s], w)
        acts[m] = h
    return torch.cat([a.to(x.device) for a in acts])
