"""OGASCHED (paper Alg. 1): online gradient ascent + fast projection.

Counterpart of ``repro.core.ogasched``. The reference's ``lax.scan`` over
slots is a Python loop here; per-slot rewards go into a preallocated (T,)
tensor on the device, so the loop makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import spans
from repro_torch.core import reward, slot_graph
from repro_torch.core.graph import ClusterSpec, zeros_like_decision
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

STEP_SPAN = "repro_torch.oga_step"


@dataclasses.dataclass(frozen=True)
class OGAState:
    y: torch.Tensor     # (L, R, K) current decision
    eta: torch.Tensor   # scalar learning rate
    t: int              # step counter


def init_state(spec: ClusterSpec, eta0: float) -> OGAState:
    """Slot mode starts from y(1) = 0 (a random feasible start arrives with
    the lifecycle slice; ``run`` takes an explicit ``y0``)."""
    y = zeros_like_decision(spec)
    # a Python number is filled in on the device: copying it from the host
    # would make the host wait for the card
    eta = (eta0.to(dtype=spec.a.dtype, device=spec.device) if isinstance(eta0, torch.Tensor)
           else torch.full((), eta0, dtype=spec.a.dtype, device=spec.device))
    return OGAState(y=y, eta=eta, t=0)


def oga_step(spec, state: OGAState, x, decay, backend: str = "reference",
             operands=None):
    """One slot: observe x(t), collect q(x(t), y(t)), ascend, project.
    Returns (next_state, reward_at_t). On the card, with the fused backend
    and ``operands``, a cluster's slots are replayed as one CUDA graph once
    the cluster repeats (``core.slot_graph``), with the eager values bit
    for bit."""
    with spans.span(STEP_SPAN):
        y_next, q_t, eta_next = slot_graph.run(_slot, spec, state.y, x, state.eta, decay,
                                               backend, operands)
        return OGAState(y=y_next, eta=eta_next, t=state.t + 1), q_t


def _slot(spec, y, x, eta, decay, backend, operands):
    """The slot's device work: (y(t+1), q(x(t), y(t)), eta * decay)."""
    q_t = reward.total_reward(spec, x, y)
    y_next = ops.oga_update_spec(spec, y, x, eta, backend=backend, operands=operands)
    return y_next, q_t, eta * decay


def run(spec: ClusterSpec, arrivals, eta0, decay=0.9999,
        y0: Optional[torch.Tensor] = None, return_traj: bool = False,
        backend: str = "auto", device: DeviceLike = None):
    """Run OGASCHED over an arrival trajectory.

    Args:
      arrivals: (T, L) arrival indicators (or counts).
      eta0, decay: initial learning rate and its per-slot decay (Tab. 2).
      backend: "fused" | "reference" | "auto" (ops.oga_update_spec).
      device: where to run; None means the CUDA card (raises without one).
    Returns:
      rewards (T,) per-slot rewards q(x(t), y(t)); y_final (L, R, K); and
      the (T, L, R, K) trajectory of y(t+1) if ``return_traj``.
    """
    dev = resolve_device(device)
    spec = spec.to(dev)
    arrivals = torch.as_tensor(arrivals, device=dev)
    backend = ops.resolve_oga_backend(backend)
    state = init_state(spec, eta0)
    if y0 is not None:
        state = dataclasses.replace(state, y=torch.as_tensor(y0, device=dev))
    operands = ops.pack_spec_operands(spec) if backend == "fused" else None
    T = arrivals.shape[0]
    rewards = torch.empty(T, dtype=spec.a.dtype, device=dev)
    traj = (torch.empty((T,) + tuple(state.y.shape), dtype=spec.a.dtype, device=dev)
            if return_traj else None)
    for t in range(T):
        state, rewards[t] = oga_step(spec, state, arrivals[t], decay, backend, operands)
        if return_traj:
            traj[t] = state.y
    if return_traj:
        return rewards, state.y, traj
    return rewards, state.y


def run_batch(spec: ClusterSpec, arrivals, eta0, decay, device: DeviceLike = None,
              tiling=None):
    """Run OGASCHED over a stacked grid of G configurations, grid-flattened:
    every slot makes ONE fused row update over N = G*R*K rows
    (ops.oga_update_batch), i.e. one kernel launch on the card.

    Args:
      spec: stacked ClusterSpec (every field leading (G,)).
      arrivals: (G, T, L); eta0, decay: scalars or (G,).
      tiling: an ``autotune.KernelConfig`` pinning the kernel's row block
        (default: the autotune cache); it changes speed, never values.
    Returns:
      rewards (G, T) per-slot rewards; y_final (G, L, R, K).
    """
    dev = resolve_device(device)
    spec = spec.to(dev)
    arrivals = torch.as_tensor(arrivals, device=dev)
    G, T, _ = arrivals.shape
    dtype = spec.a.dtype
    y = torch.zeros((G, spec.L, spec.R, spec.K), dtype=dtype, device=dev)
    eta = torch.as_tensor(eta0, dtype=dtype, device=dev).expand(G)
    decay = torch.as_tensor(decay, dtype=dtype, device=dev).expand(G)
    operands = ops.pack_spec_operands_batch(spec)
    rewards = torch.empty((G, T), dtype=dtype, device=dev)
    for t in range(T):
        x_t = arrivals[:, t]
        rewards[:, t] = reward.total_reward(spec, x_t, y)
        y = ops.oga_update_batch(spec, y, x_t, eta, operands=operands, tiling=tiling)
        eta = eta * decay
    return rewards, y


def eta_theoretical(spec: ClusterSpec, T: int) -> torch.Tensor:
    """eq. 50: eta = diam(Y) / (||grad q|| sqrt(T)) with the Thm. 1 bounds."""
    return reward.diameter_bound(spec) / (reward.grad_norm_bound(spec) * math.sqrt(float(T)))
