"""OGASCHED as a cluster's job manager: the paper's technique granting
devices to competing LM jobs.

Counterpart of ``repro.sched.job_manager``. Ports are LM training or
serving job types, instances are hosts, and the K = 6 resources are
``RES``. OGASCHED's fractional allocation y becomes a power-of-two device
grant per arrived job (``launch.elastic.plan_mesh`` turns a grant into a
mesh shape).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ogasched
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.sched import trace

# resource vector indices for LM jobs
RES = ("chips", "hbm_gb", "ici_links", "host_cpu", "host_dram_gb", "nic_gbps")


@dataclasses.dataclass
class JobTemplate:
    arch: str
    # per-channel (per-instance) max request a_l^k
    chips: float
    hbm_gb: float
    ici: float = 4.0
    cpu: float = 8.0
    dram: float = 32.0
    nic: float = 25.0

    def vector(self) -> np.ndarray:
        return np.array([self.chips, self.hbm_gb, self.ici, self.cpu, self.dram, self.nic])


def templates_from_dryrun(records: dict) -> list[JobTemplate]:
    """Job resource vectors from dry-run records (arch -> record dict):
    the memory demand is the record's per-device argument and temporary
    bytes (capped at 64 GB), the device request 4 a host."""
    out = []
    for arch, rec in records.items():
        mem = rec.get("memory", {})
        hbm = (mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)) / 1e9
        out.append(JobTemplate(arch=arch, chips=4.0, hbm_gb=min(hbm, 64.0)))
    return out


def build_cluster(jobs: list[JobTemplate], n_hosts: int = 128, seed: int = 0,
                  device: DeviceLike = None) -> ClusterSpec:
    """The bipartite spec of ``n_hosts`` hosts. Each host's capacity is a
    nominal vector in ``RES`` order (4 devices, 64 GB of device memory, 16
    interconnect links, 96 CPU cores, 256 GB of host memory, 100 Gb/s of
    network: the reference's stand-in figures, kept because the spec's bits
    depend on them) jittered by +-10%. Draws come from the "cluster" trace
    stream (``trace.stream_rng``), so the spec equals the reference's bit
    for bit."""
    dev = resolve_device(device)
    rng = trace.stream_rng(seed, "cluster")
    L, K = len(jobs), len(RES)
    cap = np.array([4.0, 64.0, 16.0, 96.0, 256.0, 100.0])
    c = cap[None, :] * rng.uniform(0.9, 1.1, (n_hosts, K))
    a = np.stack([j.vector() for j in jobs])
    mask = (rng.uniform(size=(L, n_hosts)) < 0.6).astype(np.float32)
    mask[:, 0] = 1.0  # every job can reach host 0
    alpha = rng.uniform(1.0, 1.5, (n_hosts, K))
    beta = np.linspace(0.3, 0.5, K)
    kinds = np.array([1, 3, 2, 1, 3, 2])  # log/poly/recip mix: concave gains
    f32 = lambda t: torch.from_numpy(np.asarray(t, np.float32)).to(dev)
    return ClusterSpec(mask=f32(mask), a=f32(a), c=f32(c), alpha=f32(alpha), beta=f32(beta),
                       kinds=torch.from_numpy(kinds.astype(np.int32)).to(dev))


def power_of_two_grant(chips: float) -> int:
    """The largest power of two at most ``int(chips)`` (0 for none): a
    grant a data axis can be sliced into."""
    g = int(chips)
    return 1 << max(g.bit_length() - 1, 0) if g > 0 else 0


class JobManager:
    """Runs OGASCHED online over job arrivals; exposes integral device
    grants. Each slot is one fused update (``backend="auto"``) over the
    spec's (R*K, L) rows."""

    def __init__(self, spec: ClusterSpec, jobs: list[JobTemplate], eta0=25.0,
                 decay=0.9999, device: DeviceLike = None):
        dev = resolve_device(device)
        self.spec = spec.to(dev)
        self.jobs = jobs
        self.state = ogasched.init_state(self.spec, eta0)
        self.decay = decay
        self.operands = ops.pack_spec_operands(self.spec)

    def step(self, arrivals) -> dict[str, int]:
        """One slot: the devices granted to each arrived job."""
        x = torch.as_tensor(arrivals, dtype=self.spec.a.dtype, device=self.spec.device)
        self.state, _ = ogasched.oga_step(self.spec, self.state, x, self.decay,
                                          backend="auto", operands=self.operands)
        # devices across hosts, summed on the host in the reference's order
        chips = self.state.y.cpu().numpy()[:, :, 0].sum(axis=1)
        arrived = x.cpu().numpy() > 0
        return {job.arch: power_of_two_grant(float(chips[l]))
                for l, job in enumerate(self.jobs) if arrived[l]}
