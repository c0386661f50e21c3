"""The paper's scheduling heuristics (§4): DRF, FAIRNESS, BINPACKING and
SPREADING; and the size/speedup-aware optimal policies heSRPT and
MULTICLASS.

Counterpart of ``repro.core.baselines``. Semantics as in the reference: a
multi-server job of port l requests w_l workers, each taking up to a_l^k
through one channel; the budgeted heuristics honour the total demand
w_l a_l^k and differ in placement:

  DRF         ports in ascending dominant-share order, natural node order.
  BINPACKING  natural port order, nodes in descending utilization.
  SPREADING   natural port order, nodes in ascending utilization.
  FAIRNESS    proportional share a_l^k / sum_{l'} a_{l'}^k of each c_r^k,
              capped per channel (no budget).
  HESRPT      heSRPT's closed-form shares (arXiv:1903.09346) as priority
              weights of a fluid program, solved per slot by projected
              supergradient steps.
  MULTICLASS  the unweighted fluid program (arXiv:2404.00346).

The two optimal policies project through ``projection.project_spec_rows``:
every one of their MULTICLASS_ITERS steps a slot is one launch of the CUDA
sortscan kernel on the card. They, and FAIRNESS, take a stacked spec
(leading G) as one batch; the budgeted heuristics place ports one after
another, one configuration at a time.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import projection, reward
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

_BIG = 1e30


def _rank_order(v: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort: ties keep index order, as the reference's
    sort-free ranking does."""
    return torch.argsort(v, stable=True)


def fairness_step(spec: ClusterSpec, x: torch.Tensor, w=None) -> torch.Tensor:
    """FAIRNESS: per (r,k), arrived port l gets share
    a_l^k / sum_{l' in L_r, arrived} a_{l'}^k of c_r^k, capped by a_l^k.
    Takes a stacked spec (leading G) with x (G, L)."""
    m = spec.mask * x[..., :, None]                    # (.., L, R) active channels
    wgt = m[..., None] * spec.a[..., :, None, :]       # (.., L, R, K)
    tot = wgt.sum(-3, keepdim=True)                    # (.., 1, R, K)
    share = torch.where(tot > 0, wgt / torch.clamp_min(tot, 1e-9), 0.0)
    y = share * spec.c[..., None, :, :]
    return torch.minimum(y, spec.a[..., :, None, :]) * m[..., None]


def _budgeted_fill(spec: ClusterSpec, x, w, port_order, node_score_sign: float):
    """Sequential-over-ports placement. Each port visits its connected nodes
    in preference order, taking min(a_l^k, rem_r^k) until its per-resource
    budget w_l a_l^k is used up (vectorised via a sorted cumsum).

    The port index stays on the device: each step selects its port's rows
    with ``index_select``, so the loop makes no host sync.
    """
    L, R, K = spec.L, spec.R, spec.K
    a, c, mask = spec.a, spec.c, spec.mask
    dev = a.device
    tie = 1e-6 * torch.arange(R, dtype=a.dtype, device=dev)
    node_ids = torch.arange(R, device=dev)
    c_floor = torch.clamp_min(c, 1e-9)
    y = torch.zeros((L, R, K), dtype=a.dtype, device=dev)
    rem = c
    for i in range(L):
        l = port_order[i:i + 1]                         # (1,) device index
        a_l = a.index_select(0, l)                      # (1, K)
        mask_l = mask.index_select(0, l)[0]             # (R,)
        active = x.index_select(0, l)                   # (1,)
        # rem starts at c and only shrinks (take is clipped to rem), so
        # c - rem >= 0 by loop invariant  # lint: disable=unvalidated-capacity-mask
        util = ((c - rem) / c_floor).mean(1)            # (R,)
        # preference: score descending, natural index order as tiebreak
        pref = node_score_sign * util - tie
        pref = torch.where(mask_l > 0, pref, -_BIG)
        order = torch.argsort(-pref, stable=True)
        take = torch.minimum(a_l, rem[order]) * mask_l[order][:, None]
        cum = torch.cumsum(take, 0)                     # (R, K)
        budget = w.index_select(0, l)[:, None] * a_l    # (1, K)
        allowed = torch.minimum(torch.clamp_min(budget - (cum - take), 0.0), take)
        allowed = allowed * active
        # invert the permutation with an exact scatter
        inv = torch.empty_like(order).index_put_((order,), node_ids)
        got = allowed[inv]                              # node index order (R, K)
        y.index_add_(0, l, got[None])
        rem = rem - got
    return y


# Requested-parallelism fractions (of the reachable channel count), the
# reference's calibrated values.
_W_FRAC = {"drf": 0.97, "binpacking": 0.95, "spreading": 0.95}


def _default_w(spec: ClusterSpec, name: str) -> torch.Tensor:
    return torch.ceil(_W_FRAC[name] * spec.degree_l())


def drf_step(spec: ClusterSpec, x: torch.Tensor, w=None) -> torch.Tensor:
    """DRF: ascending dominant share s_l = max_k a_l^k / sum_{r in R_l} c_r^k."""
    w = _default_w(spec, "drf") if w is None else w
    cap_l = (spec.mask[:, :, None] * spec.c[None, :, :]).sum(1)  # (L, K) reachable cap
    s = (spec.a / torch.clamp_min(cap_l, 1e-9)).amax(1)         # (L,)
    s = torch.where(x > 0, s, _BIG)                              # arrived ports first
    return _budgeted_fill(spec, x, w, _rank_order(s), node_score_sign=0.0)


def _arrived_first(spec: ClusterSpec, x: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(spec.L, dtype=torch.float32, device=x.device)
    return _rank_order(torch.where(x > 0, idx, _BIG))


def binpacking_step(spec: ClusterSpec, x: torch.Tensor, w=None) -> torch.Tensor:
    """BINPACKING / MostAllocated: favour high-utilization instances."""
    w = _default_w(spec, "binpacking") if w is None else w
    return _budgeted_fill(spec, x, w, _arrived_first(spec, x), node_score_sign=+1.0)


def spreading_step(spec: ClusterSpec, x: torch.Tensor, w=None) -> torch.Tensor:
    """SPREADING / LeastAllocated: favour low-utilization instances."""
    w = _default_w(spec, "spreading") if w is None else w
    return _budgeted_fill(spec, x, w, _arrived_first(spec, x), node_score_sign=-1.0)


# Default power-law speedup exponent p of heSRPT's closed form: the seed
# "poly" utility family is the shifted power law at p = 1/2.
HESRPT_P = 0.5

# Projected-supergradient steps of the per-slot fluid solve of
# multiclass_step and hesrpt_step (diminishing steps D / (G sqrt(1 + i))).
MULTICLASS_ITERS = 24


def hesrpt_shares(sizes: torch.Tensor, active: torch.Tensor, p: float = HESRPT_P) -> torch.Tensor:
    """(.., L) scale-free heSRPT capacity shares theta, summing to 1 over
    the active jobs (arXiv:1903.09346 Thm. 1): the n active jobs ranked
    descending by size (ties to the lower index) and q = 1 / (1 - p), the
    job of rank i gets (i / n)^q - ((i - 1) / n)^q. The smallest job gets
    the largest share; inactive entries 0."""
    q = 1.0 / (1.0 - float(p))
    f32 = torch.promote_types(sizes.dtype, torch.float32)
    act = active > 0
    actf = act.to(f32)
    n = actf.sum(-1, keepdim=True)
    idx = torch.arange(sizes.shape[-1], device=sizes.device)
    bigger = ((sizes[..., None, :] > sizes[..., :, None])
              | ((sizes[..., None, :] == sizes[..., :, None]) & (idx[None, :] < idx[:, None])))
    r = (bigger.to(f32) * actf[..., None, :]).sum(-1) + 1.0      # (.., L) rank
    # the ratio form keeps the bases in [0, 1], so a large q cannot overflow
    nn = torch.clamp_min(n, 1.0)
    theta = (r / nn) ** q - ((r - 1.0) / nn) ** q
    return torch.where(act, theta, 0.0)


def _fluid_solve(spec: ClusterSpec, weights: torch.Tensor, iters: int) -> torch.Tensor:
    """argmax_{y in Y} sum_l weights_l rate_l(y_l) by ``iters`` projected
    supergradient steps from 0 with steps D / (G sqrt(1 + i)); every
    projection one ``projection.project_spec_rows``. A stacked spec solves
    its configurations together."""
    d = reward.diameter_bound(spec)
    g0 = reward.grad_norm_bound(spec)
    y = torch.zeros(tuple(spec.mask.shape[:-2]) + (spec.L, spec.R, spec.K),
                    dtype=spec.a.dtype, device=spec.device)
    operands = ops.pack_spec_operands(spec)
    for i in range(iters):
        g = reward.reward_grad(spec, weights, y)
        eta = d / (g0 * math.sqrt(1.0 + i))
        y = projection.project_spec_rows(spec, y + eta[..., None, None, None] * g,
                                         operands=operands)
    return y


def hesrpt_step(spec: ClusterSpec, x: torch.Tensor, w=None, *, sizes: torch.Tensor,
                pool: Optional[torch.Tensor] = None, p: float = HESRPT_P,
                iters: int = MULTICLASS_ITERS) -> torch.Tensor:
    """HESRPT: the jobs marked by ``x`` ranked by their known remaining works
    ``sizes`` (.., L); ``pool`` widens the ranking population. The
    closed-form shares become the priority weights of the fluid program
    (this model's rate subtracts the communication penalty, so a raw
    theta * c share can drive a rate negative), scaled to max 1 so the step
    sizes keep their meaning; the program is solved as ``_fluid_solve``."""
    alloc = x > 0
    theta = hesrpt_shares(sizes, alloc if pool is None else (pool > 0) | alloc, p)
    wgt = theta * alloc.to(theta.dtype)
    wgt = (wgt / torch.clamp_min(wgt.amax(-1, keepdim=True), 1e-9)).to(spec.a.dtype)
    return _fluid_solve(spec, wgt, iters)


def multiclass_step(spec: ClusterSpec, x: torch.Tensor, w=None, *,
                    iters: int = MULTICLASS_ITERS) -> torch.Tensor:
    """MULTICLASS: the multi-class fluid allocation argmax_{y in Y} q(x, y),
    each port a class, solved as ``_fluid_solve`` with weights x:
    size-agnostic, speedup-aware."""
    return _fluid_solve(spec, x, iters)


_STEP_FNS = {
    "drf": drf_step,
    "fairness": fairness_step,
    "binpacking": binpacking_step,
    "spreading": spreading_step,
    "hesrpt": hesrpt_step,
    "multiclass": multiclass_step,
}

# The paper's heuristic pool (§4).
BASELINES = ("drf", "fairness", "binpacking", "spreading")
# The size/speedup-aware optimal policies.
OPTIMAL_BASELINES = ("hesrpt", "multiclass")
ALL_BASELINES = BASELINES + OPTIMAL_BASELINES
# Policies whose step consumes known job sizes; runners thread works.
SIZE_AWARE = ("hesrpt",)
# Policies whose step takes a stacked spec (leading G) as one batch.
BATCHED = ("fairness",) + OPTIMAL_BASELINES


def step_fn(name: str):
    """Per-slot policy ``(spec, x, w[, sizes=]) -> y`` by name."""
    return _STEP_FNS[name]


def default_parallelism(spec: ClusterSpec, name: str) -> Optional[torch.Tensor]:
    """Calibrated requested parallelism w_l of a budgeted heuristic (None for
    FAIRNESS, which has no budget)."""
    return _default_w(spec, name) if name in _W_FRAC else None


def run(spec: ClusterSpec, arrivals, name: str, w: Optional[torch.Tensor] = None,
        device: DeviceLike = None, works=None) -> torch.Tensor:
    """Run a baseline over (T, L) arrivals; returns (T,) rewards on the
    device. Size-aware baselines (SIZE_AWARE) also need ``works`` (T, L),
    the jobs' sizes revealed on arrival."""
    step = step_fn(name)
    dev = resolve_device(device)
    spec = spec.to(dev)
    arrivals = torch.as_tensor(arrivals, device=dev)
    if name in SIZE_AWARE:
        if works is None:
            raise ValueError(f"baseline {name!r} is size-aware: pass works=(T, L) job sizes")
        works = torch.as_tensor(works, device=dev)
    if w is None:
        w = default_parallelism(spec, name)
    T = arrivals.shape[-2]
    rewards = torch.empty(tuple(arrivals.shape[:-2]) + (T,), dtype=spec.a.dtype, device=dev)
    for t in range(T):
        x = arrivals[..., t, :]
        y = step(spec, x, w, sizes=works[..., t, :]) if name in SIZE_AWARE else step(spec, x, w)
        rewards[..., t] = reward.total_reward(spec, x, y)
    return rewards


def run_batch(specs: ClusterSpec, arrivals, name: str, device: DeviceLike = None,
              works=None) -> torch.Tensor:
    """Run a baseline over a stacked grid (every field and ``arrivals``, and
    ``works`` for a size-aware one, leading (G,)); returns (G, T). The
    BATCHED policies run the grid as one batch; the budgeted heuristics
    place ports one after another, so their grid is a loop over
    configurations."""
    if name in BATCHED:
        return run(specs, arrivals, name, device=device, works=works)
    return torch.stack([
        run(specs[g], arrivals[g], name, device=device)
        for g in range(arrivals.shape[0])
    ])
