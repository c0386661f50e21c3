"""The paper's scheduling heuristics (§4): DRF, FAIRNESS, BINPACKING and
SPREADING.

Counterpart of ``repro.core.baselines`` (the four heuristics; the
size-aware heSRPT and multi-class policies come with a later slice).
Semantics as in the reference: a multi-server job of port l requests w_l
workers, each taking up to a_l^k through one channel; the budgeted
heuristics honour the total demand w_l a_l^k and differ in placement:

  DRF         ports in ascending dominant-share order, natural node order.
  BINPACKING  natural port order, nodes in descending utilization.
  SPREADING   natural port order, nodes in ascending utilization.
  FAIRNESS    proportional share a_l^k / sum_{l'} a_{l'}^k of each c_r^k,
              capped per channel (no budget).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import reward
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device

_BIG = 1e30


def _rank_order(v: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort: ties keep index order, as the reference's
    sort-free ranking does."""
    return torch.argsort(v, stable=True)


def fairness_step(spec: ClusterSpec, x: torch.Tensor, w=None) -> torch.Tensor:
    """FAIRNESS: per (r,k), arrived port l gets share
    a_l^k / sum_{l' in L_r, arrived} a_{l'}^k of c_r^k, capped by a_l^k."""
    m = spec.mask * x[:, None]                         # (L, R) active channels
    wgt = m[:, :, None] * spec.a[:, None, :]           # (L, R, K)
    tot = wgt.sum(0, keepdim=True)                     # (1, R, K)
    share = torch.where(tot > 0, wgt / torch.clamp_min(tot, 1e-9), 0.0)
    y = share * spec.c[None, :, :]
    return torch.minimum(y, spec.a[:, None, :]) * m[:, :, None]


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


_STEP_FNS = {
    "drf": drf_step,
    "fairness": fairness_step,
    "binpacking": binpacking_step,
    "spreading": spreading_step,
}

# The paper's heuristic pool (§4).
BASELINES = ("drf", "fairness", "binpacking", "spreading")
# The reference's size-aware optimal policies; not ported yet (ROADMAP
# Queue 1, item 7).
OPTIMAL_BASELINES = ("hesrpt", "multiclass")
# Policies whose step consumes known job sizes.
SIZE_AWARE = ("hesrpt",)


def step_fn(name: str):
    """Per-slot heuristic ``(spec, x, w) -> y`` by name."""
    if name in OPTIMAL_BASELINES:
        raise NotImplementedError(
            f"baseline {name!r} is not ported yet (ROADMAP Queue 1, item 7)"
        )
    return _STEP_FNS[name]


def default_parallelism(spec: ClusterSpec, name: str) -> Optional[torch.Tensor]:
    """Calibrated requested parallelism w_l of a budgeted heuristic (None for
    FAIRNESS, which has no budget)."""
    return _default_w(spec, name) if name in _W_FRAC else None


def run(spec: ClusterSpec, arrivals, name: str, w: Optional[torch.Tensor] = None,
        device: DeviceLike = None) -> torch.Tensor:
    """Run a baseline over (T, L) arrivals; returns (T,) rewards on the device."""
    step = step_fn(name)
    dev = resolve_device(device)
    spec = spec.to(dev)
    arrivals = torch.as_tensor(arrivals, device=dev)
    if w is None:
        w = default_parallelism(spec, name)
    T = arrivals.shape[0]
    rewards = torch.empty(T, dtype=spec.a.dtype, device=dev)
    for t in range(T):
        x = arrivals[t]
        rewards[t] = reward.total_reward(spec, x, step(spec, x, w))
    return rewards


def run_batch(specs: ClusterSpec, arrivals, name: str,
              device: DeviceLike = None) -> torch.Tensor:
    """Run a baseline over a stacked grid (every field and ``arrivals``
    leading (G,)); returns (G, T). The heuristics place ports one after
    another, so the grid is a loop over configurations."""
    return torch.stack([
        run(specs[g], arrivals[g], name, device=device)
        for g in range(arrivals.shape[0])
    ])
