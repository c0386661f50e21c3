"""The benchmark's inputs, drawn on the device from ``--seed``.

A frozen copy of the trace synthesis of the scheduler (paper §4 "Traces":
Alibaba-like machine and job templates, a random bipartite adjacency,
diurnal and bursty Bernoulli arrivals, Lomax job sizes), rewritten in torch
so that every draw is made on the run's device by a ``torch.Generator`` in
a few large calls. The distributions are the program's, not its bits: the
benchmark hands the same tensors to the program and to the reference, so
neither side's generator matters to the other.

Every component draws from a generator of its own, seeded by a hash of
(seed, component), so adding a component never moves the others' draws.
A seed may be any integer that fits 64 bits.

What the generator reads is a cell's traffic parameters
(``workloads/<cell>.json``) and its configuration's sizes
(``configs/<config>.json``): nothing in this file names a cell.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

# capacities per resource type, K = 6: cpu, mem (GB/4), gpu, npu, tpu, fpga
MACHINE_TEMPLATES = (
    (96.0, 90.0, 16.0, 0.0, 0.0, 0.0),
    (128.0, 128.0, 0.0, 16.0, 0.0, 0.0),
    (96.0, 64.0, 0.0, 0.0, 32.0, 0.0),
    (64.0, 48.0, 8.0, 0.0, 0.0, 8.0),
    (192.0, 180.0, 4.0, 4.0, 4.0, 4.0),
    (48.0, 32.0, 2.0, 0.0, 0.0, 0.0),
)
# largest request per resource type of each job type (before contention)
JOB_TEMPLATES = (
    (8.0, 16.0, 4.0, 0.0, 0.0, 0.0),
    (4.0, 8.0, 0.0, 4.0, 0.0, 0.0),
    (16.0, 32.0, 0.0, 0.0, 0.0, 0.0),
    (2.0, 4.0, 0.0, 0.0, 8.0, 0.0),
    (8.0, 8.0, 2.0, 0.0, 0.0, 2.0),
    (4.0, 32.0, 0.0, 0.0, 0.0, 0.0),
    (8.0, 8.0, 1.0, 1.0, 1.0, 0.0),
    (2.0, 2.0, 2.0, 0.0, 0.0, 0.0),
    (32.0, 16.0, 0.0, 0.0, 0.0, 4.0),
    (6.0, 12.0, 8.0, 0.0, 0.0, 0.0),
)
# utility families of eq. 51 by index: linear, log, reciprocal, poly,
# pow25, pow75, expsat; "mixed" cycles over the first four
UTILITIES = ("linear", "log", "reciprocal", "poly", "pow25", "pow75", "expsat")
MIXED_KINDS = 4
# slots a burst keeps a port firing, and its arrival probability
BURST_LEN = 20
BURST_P = 0.95
# period of the diurnal modulation, in slots
DIURNAL_PERIOD = 288.0
COMPONENTS = ("spec", "arrivals", "works", "y0")


@dataclasses.dataclass(frozen=True)
class Spec:
    """The cluster (paper §2.1): mask (L, R) float {0, 1}, a (L, K), c
    (R, K), alpha (R, K), beta (K,) float32 and kinds (K,) int32."""

    mask: torch.Tensor
    a: torch.Tensor
    c: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    kinds: torch.Tensor

    FIELDS = ("mask", "a", "c", "alpha", "beta", "kinds")


def generator(seed: int, component: str, device) -> torch.Generator:
    """The generator of one component on ``device``, seeded by the first 8
    bytes of SHA-256("<seed>:<component>")."""
    digest = hashlib.sha256(f"{int(seed)}:{component}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little"))
    return gen


def _uniform(gen, shape, lo=0.0, hi=1.0, dtype=torch.float32):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def make_spec(seed: int, cfg: dict, device) -> Spec:
    """The cluster of configuration ``cfg`` (L, R, K, density, contention,
    alpha_range, beta_range, utility): instances from the machine templates
    with +-20% jitter, job types cycling over the job templates with +-10%
    jitter scaled by contention, the adjacency Bernoulli(density) between a
    port and an instance that has one of its resources, every port and
    every instance given at least one edge."""
    L, R, K = cfg["L"], cfg["R"], cfg["K"]
    gen = generator(seed, "spec", device)
    dev = gen.device
    mt = torch.tensor(MACHINE_TEMPLATES, device=dev)[:, :K]
    jt = torch.tensor(JOB_TEMPLATES, device=dev)[:, :K]
    t_idx = torch.randint(0, mt.shape[0], (R,), generator=gen, device=dev)
    c = torch.clamp_min(mt[t_idx] * _uniform(gen, (R, K), 0.8, 1.2), 1.0)
    j_idx = torch.arange(L, device=dev) % jt.shape[0]
    a = torch.clamp_min(jt[j_idx] * _uniform(gen, (L, K), 0.9, 1.1), 0.25)
    a = a * (cfg["contention"] / 10.0)
    compat = ((a[:, None, :] > 0) & (c[None, :, :] > 0)).any(-1)
    mask = (_uniform(gen, (L, R)) < cfg["density"]) & compat
    # coverage repair without a host read: a port with no edge gets one to
    # a drawn instance, then an instance with none gets one from a drawn port
    pick_r = torch.randint(0, R, (L,), generator=gen, device=dev)
    ports = torch.arange(L, device=dev)
    mask[ports, pick_r] |= ~mask.any(1)
    pick_l = torch.randint(0, L, (R,), generator=gen, device=dev)
    inst = torch.arange(R, device=dev)
    mask[pick_l, inst] |= ~mask.any(0)
    alpha = _uniform(gen, (R, K), *cfg["alpha_range"])
    beta = torch.linspace(*cfg["beta_range"], K, dtype=torch.float32, device=dev)
    if cfg["utility"] == "mixed":
        kinds = torch.arange(K, device=dev) % MIXED_KINDS
    else:
        kinds = torch.full((K,), UTILITIES.index(cfg["utility"]), device=dev)
    return Spec(mask=mask.to(torch.float32), a=a, c=c, alpha=alpha, beta=beta,
                kinds=kinds.to(torch.int32))


def make_arrivals(seed: int, traffic: dict, T: int, L: int, device) -> torch.Tensor:
    """(T, L) float32 arrival indicators: Bernoulli(rho), modulated by
    0.75 + 0.25 sin(2 pi t / 288 + phase_l) when diurnal, and 0.95 through
    the 20 slots after a burst start (a Bernoulli(burst_prob) per slot and
    port)."""
    gen = generator(seed, "arrivals", device)
    dev = gen.device
    base = torch.full((T, L), float(traffic["rho"]), device=dev)
    if traffic["diurnal"]:
        t = torch.arange(T, device=dev, dtype=torch.float32)[:, None]
        phase = _uniform(gen, (1, L), 0.0, 2.0 * math.pi)
        base = base * (0.75 + 0.25 * torch.sin(2.0 * math.pi * t / DIURNAL_PERIOD + phase))
    starts = (_uniform(gen, (T, L)) < traffic["burst_prob"]).to(torch.int32)
    cum = torch.cumsum(starts, 0)
    before = torch.cat([torch.zeros((BURST_LEN, L), dtype=cum.dtype, device=dev), cum])[:T]
    p = torch.clamp(torch.where(cum - before > 0, BURST_P, base), 0.0, 1.0)
    return (_uniform(gen, (T, L)) < p).to(torch.float32)


def make_works(seed: int, traffic: dict, T: int, L: int, device) -> torch.Tensor:
    """(T, L) float32 Lomax job sizes of mean ``work_mean`` and tail index
    ``work_tail``: scale U^(-1/tail), U uniform on (0, 1], scale = mean
    (tail - 1) / tail, drawn in float64."""
    gen = generator(seed, "works", device)
    tail = float(traffic["work_tail"])
    scale = float(traffic["work_mean"]) * (tail - 1.0) / tail
    u = 1.0 - _uniform(gen, (T, L), dtype=torch.float64)
    return (scale * u.pow(-1.0 / tail)).to(torch.float32)


def make_y0(seed: int, spec: Spec, device) -> torch.Tensor:
    """A feasible start y(1) (L, R, K): uniform shares of each port's caps
    on its edges, each (r, k) column scaled to fit its capacity with one
    part in 2^10 to spare, so rounding in the sum cannot break it."""
    gen = generator(seed, "y0", device)
    L, R = spec.mask.shape
    K = spec.a.shape[1]
    y = _uniform(gen, (L, R, K)) * spec.a[:, None, :] * spec.mask[..., None]
    used = y.sum(0)
    scale = torch.clamp_max(spec.c * (1.0 - 2.0 ** -10) / torch.clamp_min(used, 1e-9), 1.0)
    return y * scale[None]
