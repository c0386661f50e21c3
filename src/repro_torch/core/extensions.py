"""Paper §3.4 (multiple arrivals per slot) and §3.5 (gang scheduling).

Counterpart of ``repro.core.extensions``. Both reduce to the native
OGASCHED machinery through *port expansion*: replicated virtual ports
share the original port's channels and caps, and the arrival indicator of
virtual port (l, j) is 1{j <= x_l(t)} (§3.4) or the task-component
decomposition (§3.5). Gang scheduling's All-or-Nothing set is non-convex;
as the paper sketches, a step ascends the convex relaxation, projects, and
repairs: a job type with fewer than m_l scheduled tasks is zeroed.

§3.4 needs no loop of its own: ``ogasched.run(expanded, x_exp)`` runs the
fused kernel over (R*K, L*J) rows. A gang step is one fused update over
(R*K, L*Q) rows (``ops.oga_update_spec``, the same function as the
reference's ``reward_grad`` + ``project``) plus the repair.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import reward
from repro_torch.core.graph import ClusterSpec
from repro_torch.kernels import ops


def expand_multi_arrival(spec: ClusterSpec, arrivals: torch.Tensor, J: int):
    """§3.4: expand to L*J virtual ports; x_{(l,j)}(t) = 1{j <= x_l(t)}.

    Args:
      arrivals: (T, L) integer counts.
      J: max jobs per port per slot (J_l = max_t x_l(t), a uniform bound).
    Returns (expanded spec, x_exp (T, L*J) in the spec's dtype).
    """
    arrivals = torch.as_tensor(arrivals, device=spec.device)
    new_spec = dataclasses.replace(
        spec, mask=spec.mask.repeat_interleave(J, dim=0),   # (L*J, R)
        a=spec.a.repeat_interleave(J, dim=0))               # (L*J, K)
    j_idx = torch.arange(1, J + 1, device=spec.device).repeat(spec.L)   # (L*J,)
    x_rep = arrivals.repeat_interleave(J, dim=1)                        # (T, L*J)
    return new_spec, (j_idx[None, :] <= x_rep).to(spec.a.dtype)


def expand_gang(spec: ClusterSpec, task_requests: np.ndarray):
    """§3.5: expand each port into its task components.

    Args:
      task_requests: (L, Q, K) per-task requests a_l^{q,k} (Q tasks per
        type; zero rows mark absent tasks).
    Returns (expanded spec, port_of_task (L*Q,) int64, task_valid (L*Q,)).
    """
    L, Q, K = task_requests.shape
    if (L, K) != (spec.L, spec.K):
        raise ValueError(f"task_requests of shape {task_requests.shape} for a spec "
                         f"with L={spec.L}, K={spec.K}")
    dev, dtype = spec.device, spec.a.dtype
    a = torch.from_numpy(np.ascontiguousarray(
        np.asarray(task_requests).reshape(L * Q, K))).to(device=dev, dtype=dtype)
    valid = (a.sum(1) > 0).to(dtype)
    mask = spec.mask.repeat_interleave(Q, dim=0) * valid[:, None]
    port_of_task = torch.arange(L, device=dev).repeat_interleave(Q)
    return dataclasses.replace(spec, mask=mask, a=a), port_of_task, valid


def _per_port(t: torch.Tensor, port_of_task: torch.Tensor, L: int) -> torch.Tensor:
    """Sum the task axis (0) of ``t`` into its L job types (segment_sum)."""
    out = t.new_zeros((L,) + tuple(t.shape[1:]))
    return out.index_add_(0, port_of_task, t)


def kept_ports(y: torch.Tensor, port_of_task: torch.Tensor, m_min: torch.Tensor,
               L: int, eps: float = 1e-6) -> torch.Tensor:
    """(L,) 1.0 where a job type has at least m_l scheduled tasks (a task
    is scheduled when it holds any allocation above ``eps``)."""
    scheduled = (y.sum((1, 2)) > eps).to(y.dtype)                      # (L*Q,)
    return (_per_port(scheduled, port_of_task, L) >= m_min).to(y.dtype)


def gang_repair(expanded: ClusterSpec, y: torch.Tensor, port_of_task: torch.Tensor,
                m_min: torch.Tensor, L: int, eps: float = 1e-6) -> torch.Tensor:
    """All-or-Nothing repair: job types with fewer than m_l scheduled tasks
    are zeroed."""
    keep = kept_ports(y, port_of_task, m_min, L, eps)[port_of_task]     # (L*Q,)
    return y * keep[:, None, None]


def gang_reward(expanded: ClusterSpec, x: torch.Tensor, y: torch.Tensor,
                port_of_task: torch.Tensor, L: int) -> torch.Tensor:
    """Gang port reward (§3.5): utilities over the *pooled* task
    allocation, gain and penalty summed apart (``reward.totals``)."""
    pooled = _per_port(y * expanded.mask[:, :, None], port_of_task, L)   # (L, R, K)
    gain, s = reward.port_sums(expanded.kinds, expanded.alpha, pooled)
    total_gain, total_penalty = reward.totals(expanded.beta, x, gain, s)
    return total_gain - total_penalty


def gang_oga_step(expanded: ClusterSpec, x_ports: torch.Tensor, y: torch.Tensor, eta,
                  port_of_task: torch.Tensor, m_min: torch.Tensor, L: int, operands=None):
    """One gang OGA step: supergradient ascent on the relaxation and the
    projection onto the convex part of Y (one fused update over the task
    ports; ``operands`` as in ``ops.oga_update_spec``), then the
    All-or-Nothing repair. Returns (y_next, q_t)."""
    q_t = gang_reward(expanded, x_ports, y, port_of_task, L)
    x_tasks = x_ports[port_of_task]
    y_next = ops.oga_update_spec(expanded, y, x_tasks, eta, operands=operands)
    return gang_repair(expanded, y_next, port_of_task, m_min, L), q_t
