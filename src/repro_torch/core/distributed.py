"""The OGASCHED step with the instances sharded over devices (paper §3.2,
"parallel sub-procedures").

Counterpart of ``repro.core.distributed``, whose ``shard_map`` becomes a
loop over a sequence of devices in one process (as
``sched.sweep.run_grid_sharded`` does for the grid axis). The instances R
are split into ``len(mesh)`` blocks; each device holds y_local (L, R/p, K)
and its block of ``mask``, ``c`` and ``alpha``; ``a``, ``beta`` and
``kinds`` are replicated. The per-(r, k) projection is local to a block.
The only cross-block dependency is the quota s_{l,k} = sum_r y behind the
penalty's argmax k* (eq. 27): the partial quotas are summed once on the
first device and k* is sent back (the reference's one ``psum``). Each
shard then makes one fused launch with that k* (``ops.oga_update_spec(...,
kstar=)``). The gain is separable and is summed the same way; the penalty
is taken from the global quota.

A mesh may name one device several times: four shards on one card run
four launches over a quarter of the rows each.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import reward
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


def _mesh(mesh: Optional[Sequence[DeviceLike]]) -> list[torch.device]:
    """The devices of ``mesh``; None is the CUDA card alone (raises without
    one, as every entry point does)."""
    if mesh is None:
        return [resolve_device(None)]
    devs = [resolve_device(d) for d in mesh]
    if not devs:
        raise ValueError("mesh names no device")
    return devs


def _blocks(R: int, n: int) -> list[slice]:
    if R % n:
        raise ValueError(f"R = {R} instances do not divide over {n} devices")
    b = R // n
    return [slice(i * b, (i + 1) * b) for i in range(n)]


def shard_spec(spec: ClusterSpec, mesh: Optional[Sequence[DeviceLike]] = None
               ) -> list[ClusterSpec]:
    """One spec per device of ``mesh``: the device's block of instances of
    ``mask`` (columns), ``c`` and ``alpha`` (rows), and ``a``, ``beta``
    and ``kinds`` whole. Raises ``ValueError`` when R does not divide by
    the device count."""
    devs = _mesh(mesh)
    return [ClusterSpec(mask=spec.mask[:, blk].to(d), a=spec.a.to(d), c=spec.c[blk].to(d),
                        alpha=spec.alpha[blk].to(d), beta=spec.beta.to(d),
                        kinds=spec.kinds.to(d))
            for blk, d in zip(_blocks(spec.R, len(devs)), devs)]


def shard_y(y: torch.Tensor, mesh: Optional[Sequence[DeviceLike]] = None
            ) -> list[torch.Tensor]:
    """A full decision (L, R, K) split into the mesh's instance blocks."""
    devs = _mesh(mesh)
    return [y[:, blk].to(d) for blk, d in zip(_blocks(y.shape[1], len(devs)), devs)]


def gather_y(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards of a decision back in one (L, R, K) tensor on the first
    shard's device."""
    home = shards[0].device
    return torch.cat([s.to(home) for s in shards], dim=1)


def make_distributed_step(spec: ClusterSpec, mesh: Optional[Sequence[DeviceLike]] = None):
    """The OGA step over instance shards. Returns ``step(y_shards, x, eta)
    -> (y_next_shards, q_t)``: y_shards as ``shard_y`` gives them, x (L,)
    and eta a scalar; q_t sits on the first device. The shards' static
    kernel operands are packed once here."""
    specs = shard_spec(spec, mesh)
    home = specs[0].device
    operands = [ops.pack_spec_operands(s) for s in specs]
    beta = specs[0].beta

    def step(y_shards, x, eta):
        sums = [reward.port_sums(s.kinds, s.alpha, y * s.mask[:, :, None], s.mask[:, :, None])
                for s, y in zip(specs, y_shards)]
        gain = torch.stack([g.to(home) for g, _ in sums]).sum(0)            # (L,)
        quota = torch.stack([q.to(home) for _, q in sums]).sum(0)           # (L, K)
        kstar = torch.argmax(beta[None, :] * quota, dim=1)                  # the one collective
        y_next = [ops.oga_update_spec(s, y, x.to(s.device), eta, operands=op,
                                      kstar=kstar.to(s.device))
                  for s, y, op in zip(specs, y_shards, operands)]
        total_gain, total_penalty = reward.totals(beta, x.to(home), gain, quota)
        return y_next, total_gain - total_penalty

    return step
