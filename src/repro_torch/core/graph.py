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

import torch


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
