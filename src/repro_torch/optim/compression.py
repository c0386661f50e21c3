"""Gradient compression for the data-parallel all-reduce: int8 codes with
per-tensor scales and error feedback.

Counterpart of ``repro.optim.compression``. ``compress`` adds the carried
residual to each gradient, quantises the sum to int8 (scale = max |.| /
127, round half to even, clipped to +-127) and carries the new residual,
so the accumulated decompressed gradient tracks the true sum;
``decompress`` turns the codes back into float32 gradients. Trees are the
port's (dicts and lists of tensors); a compressed leaf is a (codes,
scale) tuple.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map, tree_pick


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2


def init_state(grads_like: Any) -> Any:
    """Zero float32 residuals shaped like ``grads_like``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_like)


def compress(grads: Any, err_state: Any):
    """-> (tree of (int8 codes, float32 scale) pairs, new error state)."""

    def one(g, e):
        corrected = g.to(torch.float32) + e
        scale = torch.clamp_min(torch.max(torch.abs(corrected)), 1e-12) / 127.0
        q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
        return (q, scale), corrected - q.to(torch.float32) * scale

    pairs = tree_map(one, grads, err_state)
    return tree_pick(pairs, 0), tree_pick(pairs, 1)


def decompress(q_tree: Any, dtype=torch.float32) -> Any:
    """codes * scale of every pair, in ``dtype``."""
    if _is_pair(q_tree):
        q, scale = q_tree
        return (q.to(torch.float32) * scale).to(dtype)
    if isinstance(q_tree, dict):
        return {k: decompress(x, dtype) for k, x in q_tree.items()}
    return [decompress(x, dtype) for x in q_tree]


def compressed_bytes(q_tree: Any) -> int:
    """Wire bytes of the compressed gradients: a byte a code and 4 a scale
    (against 4 a float32 gradient element)."""
    if _is_pair(q_tree):
        return int(q_tree[0].numel()) + 4
    children = q_tree.values() if isinstance(q_tree, dict) else q_tree
    return sum(compressed_bytes(x) for x in children)
