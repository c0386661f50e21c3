"""Regret against the offline stationary optimum (paper §2.3, Thm. 1).

Counterpart of ``repro.core.regret`` (the non-streamed part). Because q is
linear in x, sum_t q(x(t), y) = sum_l N_l g_l(y_l) with N_l = sum_t x_l(t),
so the offline comparator y* is one weighted concave program, solved by
projected (super)gradient ascent. On the card its projection is the CUDA
sortscan kernel (``kernels.sortscan.proj_sortscan``); the reference solves
the same exact projection with its jnp sweep.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import reward
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


def offline_optimum(spec: ClusterSpec, arrivals, iters: int = 4000,
                    device: DeviceLike = None) -> torch.Tensor:
    """y* = argsup_{y in Y} sum_t q(x(t), y) via projected gradient ascent."""
    dev = resolve_device(device)
    spec = spec.to(dev)
    arrivals = torch.as_tensor(arrivals, device=dev)
    L, R, K = spec.L, spec.R, spec.K
    counts = arrivals.to(spec.a.dtype).sum(0)                    # (L,) N_l
    # The step schedule below assumes unit-arrival gradients; normalise the
    # weights to max 1 (the argmax is invariant to the scale).
    weights = counts / torch.clamp_min(counts.max(), 1.0)
    a_rows, mask_rows, _ = ops.pack_spec_operands(spec)
    c_rows = spec.c.reshape(-1).contiguous()
    y = torch.zeros((L, R, K), dtype=spec.a.dtype, device=dev)
    d = reward.diameter_bound(spec)
    g0 = reward.grad_norm_bound(spec)
    for i in range(iters):
        g = reward.reward_grad(spec, weights, y)
        eta = d / (g0 * math.sqrt(1.0 + i))
        z_rows = ops.pack_rows(y + eta * g)
        y = ops.unpack_rows(ops.proj_sortscan(z_rows, a_rows, mask_rows, c_rows), L, R, K)
    return y


def stationary_reward(spec: ClusterSpec, arrivals, y) -> torch.Tensor:
    """sum_t q(x(t), y) for a fixed y (linearity in x)."""
    counts = arrivals.to(spec.a.dtype).sum(0)
    return reward.total_reward(spec, counts, y)


def regret(spec: ClusterSpec, arrivals, online_rewards, y_star) -> torch.Tensor:
    """R_T = Q(x, y*) - Q(x, {y(t)})."""
    return stationary_reward(spec, arrivals, y_star) - online_rewards.sum()


def regret_curve(spec: ClusterSpec, arrivals, online_rewards, y_star) -> torch.Tensor:
    """Cumulative regret after each slot against the fixed comparator y*."""
    per_slot_star = reward.total_reward(spec, arrivals, y_star)   # (T,)
    return torch.cumsum(per_slot_star - online_rewards, 0)


def h_g(spec: ClusterSpec) -> torch.Tensor:
    """H_G (eq. 49): the bipartite-graph scale factor of the regret bound."""
    return reward.diameter_bound(spec) * reward.grad_norm_bound(spec)


def regret_bound(spec: ClusterSpec, T: int) -> torch.Tensor:
    """Thm. 1: R_T <= H_G sqrt(T)."""
    return h_g(spec) * math.sqrt(float(T))
