"""The plain reference of the scheduler: OGASched (paper Alg. 1) and its job
lifecycle, written from the paper's equations in plain PyTorch.

It imports nothing of the program. It takes the benchmark's inputs (the
cluster, arrivals, job sizes, the start y0) and, where it follows the
program slot by slot, the program's decision y(t) at a checked slot; it
works out everything else again: the reward and its gradient, the learning
rate of slot t, the projection, the queues and the service.

Every function computes in the dtype of the tensors it is given: float32
is the reference, and the same code fed bfloat16 tensors is the control
that a sound comparison has to refuse.

* Utilities (eq. 51): one branch a resource type, selected on the host.
* Reward (eq. 7-8): q = sum_l x_l (sum_{r,k} f(y m) m - max_k beta_k
  sum_r y m).
* Gradient (eq. 30): x_l (f'(y m) - beta_k 1{k = k*_l}) m, k*_l the first
  k maximising beta_k sum_r y m (eq. 27). Where a port's two largest
  beta_k sum_r y m lie within TIE of each other, either k is a
  subgradient of the penalty within the float32 rounding of the sums, so
  ``next_decisions`` offers the update for each choice.
* Projection (eq. 32): per (r, k) the water level tau >= 0 with
  sum_l clip(z - tau, 0, a) m = c when the box clip overshoots c, found by
  bisection on [0, max z]; the row is clip(z - tau, 0, a) m.
"""
from __future__ import annotations

import math

import torch

# bisection halvings of the water level: 2^-32 of a bracket [0, max z] is
# below float32's resolution of the level
BISECT_ITERS = 32
# relative gap between a port's two largest beta_k sum_r y m under which
# float32 sums over a port's instances may order them either way (~1e-7
# in a tree, up to ~1e-5 typical in a sequential order over tens of
# thousands); and the most such ports whose choices are enumerated
TIE = 1e-4
MAX_TIES = 3


def util_value(kind: int, alpha, y):
    """f(y) of utility family ``kind`` (eq. 51), y clamped at 0."""
    y = torch.clamp_min(y, 0.0)
    if kind == 0:
        return alpha * y
    if kind == 1:
        return alpha * torch.log1p(y)
    if kind == 2:
        return 1.0 / alpha - 1.0 / (y + alpha)
    if kind == 3:
        return alpha * (torch.sqrt(y + 1.0) - 1.0)
    if kind == 4:
        return alpha * ((y + 1.0) ** 0.25 - 1.0)
    if kind == 5:
        return alpha * ((y + 1.0) ** 0.75 - 1.0)
    if kind == 6:
        return -alpha * torch.expm1(-y)
    raise ValueError(f"unknown utility family {kind}")


def util_grad(kind: int, alpha, y):
    """f'(y) of utility family ``kind``, y clamped at 0."""
    y = torch.clamp_min(y, 0.0)
    if kind == 0:
        return alpha.expand_as(y)
    if kind == 1:
        return alpha / (1.0 + y)
    if kind == 2:
        return 1.0 / (y + alpha) ** 2
    if kind == 3:
        return alpha / (2.0 * torch.sqrt(y + 1.0))
    if kind == 4:
        return 0.25 * alpha * (y + 1.0) ** -0.75
    if kind == 5:
        return 0.75 * alpha * (y + 1.0) ** -0.25
    if kind == 6:
        return alpha * torch.exp(-y)
    raise ValueError(f"unknown utility family {kind}")


class Cluster:
    """The spec in the reference's dtype, with the kinds read to the host
    once. ``spec`` is any object with mask, a, c, alpha, beta, kinds."""

    def __init__(self, spec, dtype=torch.float32):
        self.mask = spec.mask.to(dtype)
        self.a = spec.a.to(dtype)
        self.c = spec.c.to(dtype)
        self.alpha = spec.alpha.to(dtype)
        self.beta = spec.beta.to(dtype)
        self.kinds = [int(k) for k in spec.kinds.tolist()]
        self.dtype = dtype
        self.L, self.R = self.mask.shape
        self.K = self.a.shape[1]


def gain_and_quota(cl: Cluster, y):
    """Per port: the utility gain sum_{r,k} f(y m) m (L,) and the quota
    s = sum_r y m (L, K), one resource type at a time."""
    m = cl.mask
    gain = torch.zeros(cl.L, dtype=cl.dtype, device=y.device)
    quota = []
    for k, kind in enumerate(cl.kinds):
        ym = y[:, :, k] * m
        gain = gain + (util_value(kind, cl.alpha[None, :, k], ym) * m).sum(1)
        quota.append(ym.sum(1))
    return gain, torch.stack(quota, 1)


def service_rates(cl: Cluster, y):
    """sum_{r,k} f(y m) m - max_k beta_k sum_r y m per port (eq. 7 without
    the arrival)."""
    gain, quota = gain_and_quota(cl, y)
    return gain - (cl.beta[None] * quota).amax(1)


def reward(cl: Cluster, x, y):
    """q(x, y) (eq. 8), a 0-dim tensor."""
    return (x.to(cl.dtype) * service_rates(cl, y)).sum()


def gradient(cl: Cluster, x, y, kstar=None):
    """dq/dy (eq. 30), (L, R, K); ``kstar`` (L,) the first maximiser of
    eq. 27 when None."""
    m = cl.mask
    if kstar is None:
        _, quota = gain_and_quota(cl, y)
        kstar = torch.argmax(cl.beta[None] * quota, 1)                 # (L,)
    xf = x.to(cl.dtype)
    g = torch.empty_like(y)
    for k, kind in enumerate(cl.kinds):
        at_k = (kstar == k).to(cl.dtype)
        gk = util_grad(kind, cl.alpha[None, :, k], y[:, :, k] * m) - cl.beta[k] * at_k[:, None]
        g[:, :, k] = xf[:, None] * gk * m
    return g


def project(cl: Cluster, z, c=None):
    """Euclidean projection of z (L, R, K) onto {0 <= y <= a, y = 0 off the
    mask, sum_l y <= c} (eq. 32), ``c`` (R, K) the spec's by default."""
    c = cl.c if c is None else c
    m = cl.mask[..., None]
    a = cl.a[:, None, :]
    fill = lambda tau: torch.minimum(torch.clamp_min(z - tau, 0.0), a) * m
    box = fill(0.0)
    need = box.sum(0) > c                                              # (R, K)
    lo = torch.zeros_like(c)
    hi = torch.clamp_min((z * m).amax(0), 0.0)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        over = fill(mid[None]).sum(0) > c
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    tau = torch.where(need, 0.5 * (lo + hi), torch.zeros_like(lo))
    return fill(tau[None])


def learning_rates(eta0: float, decay: float, slots, dtype=torch.float32) -> dict:
    """{t: eta of slot t} for each t of ``slots``: eta0 multiplied by decay
    t times, each product rounded to ``dtype`` as a slot's update rounds
    it; one pass up to the latest slot."""
    want = set(slots)
    eta = torch.tensor(eta0, dtype=dtype)
    d = torch.tensor(decay, dtype=dtype)
    out = {}
    for t in range(max(want, default=-1) + 1):
        if t in want:
            out[t] = eta
        eta = eta * d
    return out


def oga_slot(cl: Cluster, x, y, eta):
    """One slot of Alg. 1 from decision y(t): (q(x(t), y(t)), y(t+1) =
    Pi_Y(y + eta grad q))."""
    q = reward(cl, x, y)
    return q, project(cl, y + eta.to(y.device, cl.dtype) * gradient(cl, x, y))


def tied_ports(cl: Cluster, x, y) -> list:
    """(port, second k) of every arriving port whose two largest
    beta_k sum_r y m are positive and within TIE of each other."""
    _, quota = gain_and_quota(cl, y)
    top = torch.topk(cl.beta[None] * quota, 2, dim=1)
    v1, v2 = top.values[:, 0].float(), top.values[:, 1].float()
    tied = (x > 0) & (v1 > 0) & ((v1 - v2) <= TIE * v1)
    return [(int(p), int(top.indices[p, 1])) for p in torch.nonzero(tied).flatten()]


def next_decisions(cl: Cluster, x, y, eta):
    """Every y(t+1) that a sound slot may reach from y(t): the update with
    the first maximiser of eq. 27, then, for up to MAX_TIES tied ports
    (``tied_ports``), with each combination of their other choice; past
    MAX_TIES only the first."""
    _, quota = gain_and_quota(cl, y)
    first = torch.argmax(cl.beta[None] * quota, 1)
    ties = tied_ports(cl, x, y)
    if len(ties) > MAX_TIES:
        ties = []
    eta = eta.to(y.device, cl.dtype)
    for choice in range(1 << len(ties)):
        kstar = first.clone()
        for i, (port, k) in enumerate(ties):
            if choice >> i & 1:
                kstar[port] = k
        yield project(cl, y + eta * gradient(cl, x, y, kstar))


def decision_gap(cl: Cluster, x, y, eta, y_next) -> float:
    """max |y_next - u| / max |u| for the sound update u nearest y_next
    (``next_decisions``)."""
    y_next = y_next.float()
    best = math.inf
    for u in next_decisions(cl, x, y, eta):
        u = u.float()
        best = min(best, float((y_next - u).abs().max() / u.abs().max().clamp_min(1e-30)))
    return best
