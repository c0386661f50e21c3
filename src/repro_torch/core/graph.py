"""Bipartite scheduling graph model (paper §2.1).

G = (L, R, E): ports (job types) x computing instances, K resource types.
Decisions ``y`` are (L, R, K) float32 tensors with an (L, R) adjacency mask;
entries off the mask are structurally zero. Counterpart of
``repro.core.graph``; the spec is a frozen dataclass of tensors in place of
a pytree, and a stacked spec (every field with a leading grid axis G) is
the same class, so ``L``/``R``/``K`` read the trailing axes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import utilities


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Static description of the bipartite scheduling problem.

    Attributes (optionally with a leading grid axis G on every field):
      mask:  (L, R) float {0,1} adjacency; mask[l, r] = 1 iff (l, r) in E.
      a:     (L, K) per-channel request caps a_l^k            (eq. 5).
      c:     (R, K) per-instance capacities c_r^k             (eq. 6).
      alpha: (R, K) utility coefficients of f_r^k             (eq. 51).
      beta:  (K,)   communication-overhead coefficients       (eq. 7).
      kinds: (K,)   int32 utility family per resource type    (eq. 51).
    """

    mask: torch.Tensor
    a: torch.Tensor
    c: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    kinds: torch.Tensor

    FIELDS = ("mask", "a", "c", "alpha", "beta", "kinds")

    @property
    def L(self) -> int:  # noqa: N802
        return self.mask.shape[-2]

    @property
    def R(self) -> int:  # noqa: N802
        return self.mask.shape[-1]

    @property
    def K(self) -> int:  # noqa: N802
        return self.a.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.a.device

    def to(self, device) -> "ClusterSpec":
        """The same spec with every field on ``device``."""
        return ClusterSpec(*(getattr(self, f).to(device) for f in self.FIELDS))

    def __getitem__(self, g) -> "ClusterSpec":
        """Config ``g`` of a stacked spec."""
        return ClusterSpec(*(getattr(self, f)[g] for f in self.FIELDS))

    @staticmethod
    def stack(specs) -> "ClusterSpec":
        """Stack specs of one shape along a new leading grid axis."""
        return ClusterSpec(*(
            torch.stack([getattr(s, f) for s in specs]) for f in ClusterSpec.FIELDS
        ))

    def degree_l(self) -> torch.Tensor:
        """|R_l| per port."""
        return self.mask.sum(-1)

    def validate(self) -> None:
        L, R, K = self.L, self.R, self.K
        lead = tuple(self.mask.shape[:-2])
        shapes = {
            "mask": (L, R), "a": (L, K), "c": (R, K),
            "alpha": (R, K), "beta": (K,), "kinds": (K,),
        }
        for f, want in shapes.items():
            got = tuple(getattr(self, f).shape)
            if got != lead + want:
                raise ValueError(f"spec.{f} has shape {got}, want {lead + want}")


def feasible(spec: ClusterSpec, y: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
    """Check y in Y: (5) channel caps, (6) capacities, adjacency."""
    m = spec.mask[..., None]
    ok_box = torch.all((y >= -tol) & (y <= spec.a[..., :, None, :] + tol))
    ok_mask = torch.all(torch.abs(y * (1.0 - m)) <= tol)
    used = (y * m).sum(-3)  # (R, K)
    ok_cap = torch.all(used <= spec.c + tol)
    return ok_box & ok_mask & ok_cap


def zeros_like_decision(spec: ClusterSpec) -> torch.Tensor:
    lead = tuple(spec.mask.shape[:-2])
    return torch.zeros(lead + (spec.L, spec.R, spec.K), dtype=spec.a.dtype,
                       device=spec.device)


def residual_capacity(spec: ClusterSpec, held: torch.Tensor,
                      capacity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """c - sum_l held_l, floored at 0: the capacity left for new admissions.

    ``held`` (.., L, R, K) is what jobs still in service hold
    (sched.lifecycle); ``capacity`` (.., R, K) replaces the nominal
    ``spec.c`` with a slot's surviving capacity under faults. The floor
    absorbs float error of long runs and held allocations above a freshly
    collapsed capacity before eviction settles.
    """
    c = spec.c if capacity is None else capacity
    used = (held * spec.mask[..., None]).sum(-3)  # (.., R, K)
    # clamp_min is the floor the rule asks for (it knows jnp.maximum only)
    # lint: disable=unvalidated-capacity-mask
    return torch.clamp_min(c - used, 0.0)


def residual_spec(spec: ClusterSpec, held: torch.Tensor,
                  capacity: Optional[torch.Tensor] = None) -> ClusterSpec:
    """The same problem with capacities netted by ``held`` (see
    ``residual_capacity``)."""
    return dataclasses.replace(spec, c=residual_capacity(spec, held, capacity))


Generator = Union[np.random.Generator, torch.Generator]


def random_feasible_decision(spec: ClusterSpec, gen: Generator) -> torch.Tensor:
    """A strictly feasible y(1) in Y for OGA initialisation: uniform draws
    scaled by the caps and the mask, each (r, k) column scaled down to its
    capacity. ``gen`` is a numpy ``Generator`` (draws made on the host in
    float32, so a numpy caller can rebuild them) or a ``torch.Generator`` on
    the spec's device. A stacked spec takes one draw of (L, R, K), shared
    by every configuration."""
    shape = (spec.L, spec.R, spec.K)
    if isinstance(gen, np.random.Generator):
        u = torch.from_numpy(gen.random(shape, dtype=np.float32)).to(spec.device)
    else:
        u = torch.rand(shape, generator=gen, dtype=spec.a.dtype, device=spec.device)
    y = u * spec.a[..., :, None, :] * spec.mask[..., None]
    used = y.sum(-3)                                            # (.., R, K)
    scale = torch.clamp_max(spec.c / torch.clamp_min(used, 1e-9), 1.0)
    return y * scale[..., None, :, :]


def make_random_spec(gen: torch.Generator, L: int = 10, R: int = 128, K: int = 6,
                     density: float = 0.5, contention: float = 10.0,
                     alpha_range: tuple = (1.0, 1.5), beta_range: tuple = (0.3, 0.5),
                     kinds=None, dtype=torch.float32) -> ClusterSpec:
    """Random spec following the paper's default parameterisation (Tab. 2),
    drawn from ``gen`` on its device: the reference's distributions, not its
    bits (the reference draws from JAX keys)."""
    dev = gen.device
    rand = lambda *shape: torch.rand(shape, generator=gen, dtype=dtype, device=dev)
    mask = (rand(L, R) < density).to(dtype)
    # every port needs >= 1 instance: a diagonal-ish band
    mask[torch.arange(L, device=dev), torch.arange(L, device=dev) % R] = 1.0
    # capacities c_r^k in [20, 100]; requests a_l^k in [0.5, 2.0] * contention
    c = 20.0 + 80.0 * rand(R, K)
    a = (0.5 + 1.5 * rand(L, K)) * contention
    alpha = alpha_range[0] + (alpha_range[1] - alpha_range[0]) * rand(R, K)
    beta = torch.linspace(beta_range[0], beta_range[1], K, dtype=dtype, device=dev)
    if kinds is None:
        kinds = [i % utilities.NUM_SEED_KINDS for i in range(K)]
    spec = ClusterSpec(mask=mask, a=a, c=c, alpha=alpha, beta=beta,
                       kinds=torch.as_tensor(kinds, dtype=torch.int32, device=dev))
    spec.validate()
    return spec
