"""Regret against the offline stationary optimum (paper §2.3, Thm. 1),
and the statistical validation of Theorem 1.

Counterpart of ``repro.core.regret``. Because q is linear in x,
sum_t q(x(t), y) = sum_l N_l g_l(y_l) with N_l = sum_t x_l(t), so the
offline comparator y* is one weighted concave program, solved by projected
(super)gradient ascent. On the card its projection is the CUDA sortscan
kernel (``kernels.sortscan.proj_sortscan``); the reference solves the same
exact projection with its jnp sweep.

Theorem 1 claims R_T <= H_G sqrt(T), a sublinear growth. The validation
half makes that claim statistical:

  * ``make_regret_grid``      — seeds x utility families x arrival regimes
                                as sweep points (eta0 by default eq. 50's
                                theoretical rate per point).
  * ``offline_optimum_batch`` — the comparator of a stacked grid: one
                                projection launch an iteration over all
                                G*R*K rows.
  * ``regret_curves_batch``   — every row's cumulative regret curve (OGA
                                run, oracle, comparator cumsum).
  * ``regret_stream``         — the chunked loop over
                                ``sweep.iter_batches``: only log-sampled
                                curve points reach the host.
  * ``fit_growth_exponent`` / ``bootstrap_exponent`` / ``regret_validation``
                              — the log-log slope of the seed-averaged
                                curve with a bootstrap CI over seeds, per
                                (utility, regime) cell (numpy only: the
                                reference's code, bit for bit).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ogasched, reward
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


def offline_optimum(spec: ClusterSpec, arrivals, iters: int = 4000,
                    device: DeviceLike = None) -> torch.Tensor:
    """y* = argsup_{y in Y} sum_t q(x(t), y) via projected gradient ascent:
    ``offline_optimum_batch`` of a one-config grid."""
    arrivals = torch.as_tensor(arrivals)
    return offline_optimum_batch(ClusterSpec.stack([spec]), arrivals[None], iters,
                                 device=device)[0]


def offline_optimum_batch(spec: ClusterSpec, arrivals, iters: int = 4000,
                          device: DeviceLike = None) -> torch.Tensor:
    """The offline comparator of every configuration of a stacked grid
    (spec leading (G,), arrivals (G, T, L)): (G, L, R, K). Each iteration
    makes ONE projection over all G*R*K rows (one kernel launch on the
    card); rows never mix, so a row is its config's own result."""
    dev = resolve_device(device)
    spec = spec.to(dev)
    arrivals = torch.as_tensor(arrivals, device=dev)
    G = arrivals.shape[0]
    L, R, K = spec.L, spec.R, spec.K
    counts = arrivals.to(spec.a.dtype).sum(-2)                          # (G, L)
    weights = counts / torch.clamp_min(counts.amax(-1, keepdim=True), 1.0)
    a_rows, mask_rows, _ = ops.pack_spec_operands(spec)                 # (G*R*K, L)
    c_rows = spec.c.reshape(-1).contiguous()
    y = torch.zeros((G, L, R, K), dtype=spec.a.dtype, device=dev)
    d = reward.diameter_bound(spec)                                     # (G,)
    g0 = reward.grad_norm_bound(spec)
    for i in range(iters):
        g = reward.reward_grad(spec, weights, y)
        eta = d / (g0 * math.sqrt(1.0 + i))
        z_rows = ops.pack_rows(y + eta[:, None, None, None] * g).reshape(G * R * K, L)
        y_rows = ops.proj_sortscan(z_rows, a_rows, mask_rows, c_rows)
        y = ops.unpack_rows(y_rows.reshape(G, R * K, L), L, R, K)
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


# --------------------------------------------------------------------------
# Statistical regret validation: seeds x utilities x arrival regimes
# --------------------------------------------------------------------------

# TraceConfig overrides per arrival regime: "stationary" is the i.i.d.
# setting Thm. 1's comparator is natural for; "diurnal" modulates the rate;
# "flash" adds flash-crowd bursts, where a stationary comparator is
# hardest to track.
ARRIVAL_REGIMES: dict[str, dict] = {
    "stationary": {"diurnal": False, "burst_prob": 0.0},
    "diurnal": {"diurnal": True, "burst_prob": 0.0},
    "flash": {"diurnal": True, "burst_prob": 0.08},
}


@dataclasses.dataclass(frozen=True)
class RegretLabel:
    """Provenance of one regret-grid row (parallel to the points)."""

    utility: str
    regime: str
    seed: int


def make_regret_grid(
    base=None,
    *,
    utilities: Sequence[str] = ("linear", "log", "reciprocal", "poly",
                                "pow25", "pow75", "expsat"),
    regimes: Sequence[str] = ("stationary", "flash"),
    seeds: Sequence[int] = tuple(range(8)),
    eta0: float | str = "theoretical",
    decay: float = 1.0,
    device: DeviceLike = None,
):
    """(points, labels) of a seeds x utilities x regimes regret grid.

    ``eta0="theoretical"`` gives every point eq. 50's horizon-optimal
    constant rate eta = D / (G sqrt(T)) on its own spec
    (``ogasched.eta_theoretical``, computed on ``device``; None: the CUDA
    card), with ``decay=1.0``: the schedule Thm. 1's proof assumes. Pass a
    float to pin eta0.

    Row order: utility (slowest) x regime x seed (fastest), so a
    ``len(seeds)``-strided reshape groups curves for seed averaging.
    """
    from repro_torch.sched import sweep, trace  # sched layers on core: lazy

    base = trace.TraceConfig() if base is None else base
    points, labels = [], []
    for util in utilities:
        for regime in regimes:
            if regime not in ARRIVAL_REGIMES:
                raise ValueError(f"unknown regime {regime!r}: {tuple(ARRIVAL_REGIMES)}")
            for seed in seeds:
                cfg = dataclasses.replace(base, utility=util, seed=int(seed),
                                          **ARRIVAL_REGIMES[regime])
                if eta0 == "theoretical":
                    e = float(ogasched.eta_theoretical(trace.build_spec(cfg, device), cfg.T))
                else:
                    e = float(eta0)
                points.append(sweep.SweepPoint(cfg=cfg, eta0=e, decay=decay))
                labels.append(RegretLabel(utility=util, regime=regime, seed=int(seed)))
    return points, labels


def regret_curves_batch(spec: ClusterSpec, arrivals, eta0, decay, *,
                        oracle_iters: int = 2000, backend: str = "auto",
                        device: DeviceLike = None) -> torch.Tensor:
    """(G, T) cumulative regret curves of a stacked grid.

    Per row: run OGA (the fused backend flattens the grid into the
    kernel's rows, ``ogasched.run_batch``; "reference" runs config by
    config), solve the comparator (``offline_optimum_batch``) and cumsum
    the per-slot comparator-minus-online gap (``regret_curve``).
    """
    dev = resolve_device(device)
    spec = spec.to(dev)
    arrivals = torch.as_tensor(arrivals, device=dev)
    if ops.resolve_oga_backend(backend) == "fused":
        rewards, _ = ogasched.run_batch(spec, arrivals, eta0, decay, device=dev)
    else:
        rewards = torch.stack([
            ogasched.run(spec[g], arrivals[g], eta0=eta0[g], decay=decay[g],
                         backend=backend, device=dev)[0]
            for g in range(arrivals.shape[0])])
    y_star = offline_optimum_batch(spec, arrivals, iters=oracle_iters, device=dev)
    per_slot_star = (arrivals.to(spec.a.dtype)
                     * reward.service_rates(spec, y_star)[:, None, :]).sum(-1)   # (G, T)
    return torch.cumsum(per_slot_star - rewards, dim=-1)


def sample_ts(T: int, num: int = 64, t_min: int = 8) -> np.ndarray:
    """~``num`` log-spaced 1-based slot counts in [t_min, T], T included
    (so a sampled curve's last entry is R_T)."""
    t_min = min(t_min, T)
    ts = np.unique(np.round(
        np.geomspace(t_min, T, num=min(num, T - t_min + 1))).astype(np.int64))
    if ts[-1] != T:
        ts = np.append(ts, T)
    return ts


def regret_stream(
    points: Sequence,
    *,
    ts: Optional[np.ndarray] = None,
    chunk_size: int = 32,
    oracle_iters: int = 2000,
    backend: str = "auto",
    trace_backend: str = "host",
    prefetch: int = 2,
    device: DeviceLike = None,
) -> dict[str, np.ndarray]:
    """Stream a regret grid chunk by chunk on ``device`` (None: the CUDA
    card); only sampled curve points reach the host.

    The sweep engine's prefetching chunk generator (``sweep.iter_batches``)
    builds traces ``chunk_size`` configs at a time on a background thread
    while the current chunk's curves compute, and each chunk's (g, T)
    curves are reduced to (g, len(ts)) before the next chunk arrives.

    Returns {"ts": (S,), "curves": (G, S), "r_T": (G,), "bound": (G,),
    "h_g": (G,)} in ``points`` order, ``bound`` the Thm. 1 bound on R_T.
    """
    from repro_torch.sched import sweep  # sched layers on core: lazy

    if not points:
        raise ValueError("empty regret grid")
    T = points[0].cfg.T
    if any(p.cfg.T != T for p in points):
        raise ValueError("all regret-grid points must share T")
    ts = sample_ts(T) if ts is None else np.asarray(ts, np.int64)
    if ts.size == 0 or ts[0] < 1 or ts[-1] > T or np.any(np.diff(ts) <= 0):
        raise ValueError(f"ts must be strictly increasing in [1, {T}]")
    dev = resolve_device(device)
    idx = torch.as_tensor(ts - 1, device=dev)  # curve entry t-1 is the regret after slot t
    curves, hgs = [], []
    for sl, batch in sweep.iter_batches(points, chunk_size, mode="slot",
                                        trace_backend=trace_backend, prefetch=prefetch,
                                        device=dev):
        c = regret_curves_batch(batch.spec, batch.arrivals, batch.eta0, batch.decay,
                                oracle_iters=oracle_iters, backend=backend, device=dev)
        g = sl.stop - sl.start
        curves.append(c[:g, idx].cpu().numpy())
        hgs.append(h_g(batch.spec)[:g].cpu().numpy())
    curves_np = np.concatenate(curves)
    hg_np = np.concatenate(hgs)
    return {
        "ts": ts,
        "curves": curves_np,
        "r_T": curves_np[:, -1],
        "h_g": hg_np,
        "bound": hg_np * np.sqrt(float(T)),
    }


def fit_growth_exponent(ts: np.ndarray, curve: np.ndarray, *, t_min: int = 32,
                        min_points: int = 8) -> float:
    """Log-log OLS slope of a cumulative regret curve: R_t ~ t^slope.

    Only entries with t >= t_min (past the transient) and R_t > 1.0 enter
    the fit: the log of a negative or tiny regret means nothing, and OGA
    can beat the stationary comparator outright on nonstationary arrivals.
    With fewer than ``min_points`` usable entries it warns and returns NaN
    (for a sublinearity gate that is benign: a curve too low to fit is not
    growing linearly).
    """
    ts = np.asarray(ts, np.float64)
    curve = np.asarray(curve, np.float64)
    m = (ts >= t_min) & (curve > 1.0)
    if int(m.sum()) < min_points:
        warnings.warn(
            f"fit_growth_exponent: only {int(m.sum())} usable curve points "
            f"(need >= {min_points}) after masking t < {t_min} and "
            "R_t <= 1; returning NaN — regret is too small/negative to "
            "fit a growth exponent",
            stacklevel=2,
        )
        return float("nan")
    slope = np.polyfit(np.log(ts[m]), np.log(curve[m]), 1)[0]
    return float(slope)


def bootstrap_exponent(ts: np.ndarray, curves: np.ndarray, *, n_boot: int = 200,
                       seed: int = 0, t_min: int = 32,
                       min_points: int = 8) -> dict[str, float]:
    """Growth exponent of the seed-averaged curve and a bootstrap CI.

    ``curves`` is (S, num_ts), one sampled curve per seed. The point
    estimate fits the across-seed MEAN curve; the [2.5, 97.5]% CI refits
    means of S seeds resampled with replacement. Returns {"exponent",
    "ci_lo", "ci_hi", "n_seeds"}, NaN where too few points are fittable.
    """
    curves = np.asarray(curves, np.float64)
    if curves.ndim != 2:
        raise ValueError(f"curves must be (seeds, ts), got {curves.shape}")
    S = curves.shape[0]
    fit = partial(fit_growth_exponent, t_min=t_min, min_points=min_points)
    point = fit(ts, curves.mean(axis=0))
    rng = np.random.default_rng(seed)
    with warnings.catch_warnings():
        # the point estimate already warned if the curve is unfittable
        warnings.simplefilter("ignore")
        boots = np.asarray([fit(ts, curves[rng.integers(0, S, size=S)].mean(axis=0))
                            for _ in range(n_boot)])
    ok = np.isfinite(boots)
    lo, hi = (np.percentile(boots[ok], [2.5, 97.5]) if ok.any()
              else (float("nan"), float("nan")))
    return {"exponent": point, "ci_lo": float(lo), "ci_hi": float(hi), "n_seeds": S}


def regret_validation(
    points: Sequence,
    labels: Sequence[RegretLabel],
    *,
    ts: Optional[np.ndarray] = None,
    chunk_size: int = 32,
    oracle_iters: int = 2000,
    backend: str = "auto",
    trace_backend: str = "host",
    n_boot: int = 200,
    t_min: int = 32,
    device: DeviceLike = None,
) -> list[dict]:
    """Theorem-1 validation records, one per (utility, regime) cell.

    Streams the grid (``regret_stream`` on ``device``; None: the CUDA
    card), groups rows by label, and emits {"utility", "regime",
    "n_seeds", "exponent", "ci_lo", "ci_hi", "r_T_mean", "r_T_max",
    "bound", "bound_ok", "sublinear"}: ``bound_ok`` is Thm. 1's literal
    mean R_T <= H_G sqrt(T), ``sublinear`` the fitted exponent below 1 (a
    NaN exponent counts: the curve was too low to fit).
    """
    if len(points) != len(labels):
        raise ValueError("points and labels must be parallel")
    res = regret_stream(points, ts=ts, chunk_size=chunk_size, oracle_iters=oracle_iters,
                        backend=backend, trace_backend=trace_backend, device=device)
    return validation_records(res, labels, n_boot=n_boot, t_min=t_min)


def validation_records(res: dict, labels: Sequence[RegretLabel], *, n_boot: int = 200,
                       t_min: int = 32) -> list[dict]:
    """``regret_validation``'s per-cell records from ``regret_stream``'s
    result: numpy only, so equal curves give equal records."""
    groups: dict[tuple[str, str], list[int]] = {}
    for i, lab in enumerate(labels):
        groups.setdefault((lab.utility, lab.regime), []).append(i)
    out = []
    for (util, regime), rows in groups.items():
        curves = res["curves"][rows]
        boot = bootstrap_exponent(res["ts"], curves, n_boot=n_boot, t_min=t_min)
        r_t = res["r_T"][rows]
        bound = float(res["bound"][rows].mean())
        expo = boot["exponent"]
        out.append({
            "utility": util,
            "regime": regime,
            "n_seeds": boot["n_seeds"],
            "exponent": expo,
            "ci_lo": boot["ci_lo"],
            "ci_hi": boot["ci_hi"],
            "r_T_mean": float(r_t.mean()),
            "r_T_max": float(r_t.max()),
            "bound": bound,
            "bound_ok": bool(float(r_t.mean()) <= bound),
            "sublinear": bool(not np.isfinite(expo) or expo < 1.0),
        })
    return out
