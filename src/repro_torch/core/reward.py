"""Single-slot reward q(x, y) (paper eq. 7-8) and its gradient (eq. 30).

Counterpart of ``repro.core.reward``. Every function also takes a stacked
spec with a leading grid axis (y (G, L, R, K), x (G, L)): the batch axis
that the reference gets from ``vmap`` is written out here.
"""
from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.core import utilities
from repro_torch.core.graph import ClusterSpec

REWARD_SPAN = "repro_torch.reward"


def _gain_terms(spec: ClusterSpec, y: torch.Tensor):
    m = spec.mask[..., None]                                # (.., L, R, 1)
    ym = y * m
    kinds = spec.kinds[..., None, None, :]
    alpha = spec.alpha[..., None, :, :]
    return m, ym, kinds, alpha


def port_sums(kinds: torch.Tensor, alpha: torch.Tensor, ym: torch.Tensor, m=1.0):
    """Per-port gain sum_{r,k} f_r^k(ym) m (.., L) and quota s = sum_r ym
    (.., L, K) of a masked allocation ym (.., L, R, K); kinds (.., K),
    alpha (.., R, K). A sharded step sums both over its shards (the gain is
    separable, the quota is the one collective), so they are returned
    apart from the penalty."""
    gain = (utilities.util_value(kinds[..., None, None, :], alpha[..., None, :, :], ym)
            * m).sum((-2, -1))
    return gain, ym.sum(-2)


def penalty(beta: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Communication penalty max_k beta_k s_{l,k} (.., L) of a quota s."""
    return (beta[..., None, :] * s).amax(-1)


def totals(beta: torch.Tensor, x: torch.Tensor, gain: torch.Tensor, s: torch.Tensor):
    """(sum_l x_l gain_l, sum_l x_l penalty_l): the Fig. 6 split of q."""
    xf = x.to(gain.dtype)
    return (xf * gain).sum(-1), (xf * penalty(beta, s)).sum(-1)


def _service_rates(spec: ClusterSpec, y: torch.Tensor) -> torch.Tensor:
    m, ym, _, _ = _gain_terms(spec, y)
    gain, s = port_sums(spec.kinds, spec.alpha, ym, m)                  # (.., L), (.., L, K)
    return gain - penalty(spec.beta, s)


def service_rates(spec: ClusterSpec, y: torch.Tensor) -> torch.Tensor:
    """Per-port speedup utility minus communication penalty (eq. 7 without
    the arrival multiplier): sum_{r,k} f_r^k(y) - max_k beta_k sum_r y^k."""
    with spans.span(REWARD_SPAN):
        return _service_rates(spec, y)


def port_rewards(spec: ClusterSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """q_l(x, y) for every port (eq. 7). x: (.., L); y: (.., L, R, K)."""
    return x.to(y.dtype) * _service_rates(spec, y)


def total_reward(spec: ClusterSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """q(x, y) = sum_l q_l (eq. 8)."""
    with spans.span(REWARD_SPAN):
        return port_rewards(spec, x, y).sum(-1)


def decompose(spec: ClusterSpec, x: torch.Tensor, y: torch.Tensor):
    """(total gain, total penalty) across ports: the Fig. 6 decomposition,
    q = gain - penalty up to rounding (the two are summed apart)."""
    m, ym, _, _ = _gain_terms(spec, y)
    gain, s = port_sums(spec.kinds, spec.alpha, ym, m)
    return totals(spec.beta, x, gain, s)


def reward_grad(spec: ClusterSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """dq/dy (eq. 30): x_l ((f_r^k)'(y) - beta_k 1{k = k*_l}), masked.

    k*_l = argmax_k beta_k sum_r y (eq. 27); ``torch.argmax`` returns the
    first maximal index, the reference's tie rule.
    """
    m, ym, kinds, alpha = _gain_terms(spec, y)
    g = utilities.util_grad(kinds, alpha, ym)                           # (.., L, R, K)
    s = ym.sum(-2)                                                      # (.., L, K)
    kstar = torch.argmax(spec.beta[..., None, :] * s, dim=-1)           # (.., L)
    # one-hot by comparison: torch.nn.functional.one_hot reads the indices on the host
    is_kstar = (kstar[..., None] == torch.arange(spec.K, device=kstar.device)).to(y.dtype)
    grad = g - spec.beta[..., None, None, :] * is_kstar[..., :, None, :]
    return x.to(y.dtype)[..., :, None, None] * grad * m


def grad_norm_bound(spec: ClusterSpec) -> torch.Tensor:
    """Upper bound of ||grad q|| (eq. 45): sum_l sum_{r in R_l} ((b*)^2 + K (w_r*)^2)."""
    w = utilities.util_grad_at_zero(spec.kinds[..., None, :], spec.alpha)   # (.., R, K)
    w_star = w.amax(-1)                                        # (R,)
    beta_star = spec.beta.amax(-1)[..., None, None]
    per_lr = spec.mask * (beta_star**2 + spec.K * w_star[..., None, :] ** 2)
    return torch.sqrt(per_lr.sum((-2, -1)))


def diameter_bound(spec: ClusterSpec) -> torch.Tensor:
    """diam(Y) upper bound (eq. 48): sqrt(2 sum_k a_bar^k sum_r c_r^k)."""
    a_bar = spec.a.amax(-2)                                    # (K,)
    return torch.sqrt(2.0 * (a_bar * spec.c.sum(-2)).sum(-1))

