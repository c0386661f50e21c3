"""Assigned input shapes (the per-arch shape set) and their applicability.

Counterpart of ``repro.configs.shapes``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs a sub-quadratic decode state: SSM and hybrid only. Every
# other assigned arch is full attention (gemma2's alternating global layers
# keep it quadratic in memory).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, the reason when skipped)."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, (
            f"{cfg.name} is full-attention; 500k-token dense KV decode is "
            "excluded by the assignment (sub-quadratic archs only)"
        )
    return True, ""


def cells(arch_names: list[str]):
    """Every (arch x shape) cell with its applicability: (cfg, shape, ok,
    reason)."""
    from repro_torch.configs import base

    out = []
    for an in arch_names:
        cfg = base.get(an)
        for sh in SHAPES.values():
            ok, reason = applicable(cfg, sh)
            out.append((cfg, sh, ok, reason))
    return out
