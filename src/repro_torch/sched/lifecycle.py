"""Occupancy-aware job lifecycle, with capacity faults.

Counterpart of ``repro.sched.lifecycle``. Jobs arrive with a sampled amount
of work, receive an allocation, hold it while they execute and depart when
their work drains. The reference's ``lax.scan`` is a Python loop here that
writes every slot's events into preallocated (G, T, ...) tensors on the
device and never syncs with the host. Every state tensor leads with a grid
axis G: ``run`` is G = 1, and ``run_batch`` (``sweep.run_grid(mode=
"lifecycle")``) the same ``_step`` over G configurations.

State machine per port (one job in service per port, a FIFO queue behind
it):

    arrival --push--> QUEUED --admit (port idle)--> RUNNING --drain--> DONE
        +--queue full--> DROPPED      RUNNING --evict--> QUEUED (backoff)
                                         +--retry budget spent--> DROPPED

Slot order (``_step``): apply the slot's fault multiplier (c_t = c f_t) and
evict the in-service jobs that no longer fit (``_evict``) -> enqueue
arrivals -> admit the ready queue heads on idle ports -> allocate against
the surviving residual capacity -> collect the admission reward -> serve
every running job at the rate of its held allocation -> depart drained
jobs -> the policy update (OGA ascends on the arrival indicator).

Every allocation is the policy's proposal projected onto the residual
capacity by ``projection.project_spec_rows``: on the card one launch of
the CUDA sortscan kernel over the (G*R*K, L) rows; OGASCHED's update is one
launch of the fused kernel (``ops.oga_update_batch``). heSRPT re-divides
the whole surviving capacity every slot (``baselines.hesrpt_step``, whose
steps project through the same kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import baselines, graph, projection, reward
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

# The heuristics' pool, and every policy the lifecycle runs.
ALGORITHMS = ("ogasched",) + baselines.BASELINES
ALL_ALGORITHMS = ("ogasched",) + baselines.ALL_BASELINES

# Jobs with sampled work below this floor still occupy their port for one
# slot (duration-1 jobs are the slot-mode reduction).
WORK_FLOOR = 1e-6

# Feasibility slack of the eviction rule, absolute + relative: float
# accumulation can never evict a job a real capacity drop would keep.
FEAS_TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How the lifecycle reacts to capacity loss.

    backoff_base:  re-queue delay of a job's first retry, in slots; retry n
                   waits ``min(backoff_base * 2**(n-1), backoff_cap)``.
    backoff_cap:   upper bound of the backoff delay, in slots.
    max_retries:   evictions a job survives; the next one drops it.
    preserve_work: True re-queues the job with its remaining work; False
                   restarts it from its full size, its progress wasted.
    """

    backoff_base: float = 2.0
    backoff_cap: float = 64.0
    max_retries: int = 3
    preserve_work: bool = True


@dataclasses.dataclass(frozen=True)
class LifecycleState:
    """The carry of the slot loop; every tensor leads with the grid axis G.

    held:      (G, L, R, K) resources granted to in-service jobs.
    remaining: (G, L) work left of the in-service job; 0 <=> port idle.
    svc_arr:   (G, L) int32 arrival slot of the in-service job (JCT anchor).
    svc_start: (G, L) int32 admission slot (slowdown anchor).
    svc_work:  (G, L) total work of the in-service job.
    svc_retry: (G, L) int32 evictions the in-service job has survived.
    q_work, q_arr, q_ready, q_retry: (G, L, Q) FIFO of queued sizes,
               arrival slots, earliest-admission slots and eviction counts.
    q_len:     (G, L) int32 queue occupancy.
    dropped:   (G,) int32 arrivals rejected by a full queue, cumulative.
    rdropped:  (G,) int32 evicted jobs dropped, cumulative.
    y:         (G, L, R, K) OGA decision (zeros for the other policies).
    eta:       (G,) OGA learning rate.
    t:         the slot counter (a host int: every configuration shares it).
    """

    held: torch.Tensor
    remaining: torch.Tensor
    svc_arr: torch.Tensor
    svc_start: torch.Tensor
    svc_work: torch.Tensor
    svc_retry: torch.Tensor
    q_work: torch.Tensor
    q_arr: torch.Tensor
    q_ready: torch.Tensor
    q_retry: torch.Tensor
    q_len: torch.Tensor
    dropped: torch.Tensor
    rdropped: torch.Tensor
    y: torch.Tensor
    eta: torch.Tensor
    t: int


@dataclasses.dataclass(frozen=True)
class LifecycleTrace:
    """Per-slot event record; every field leads with (G, T) from
    ``run_batch`` and with (T,) from ``run``.

    rewards (T,), admitted, departed (T, L) bool, jct, svc_slots (T, L)
    (valid where departed), used (T, R, K) the slot's peak occupancy,
    running (T, L) bool, q_depth (T, L) int32, dropped (T,) int32
    cumulative, evicted (T, L) bool, wasted (T,) progress discarded,
    rdropped (T,) int32 cumulative, work_done (T, L) work drained.
    """

    rewards: torch.Tensor
    admitted: torch.Tensor
    departed: torch.Tensor
    jct: torch.Tensor
    svc_slots: torch.Tensor
    used: torch.Tensor
    running: torch.Tensor
    q_depth: torch.Tensor
    dropped: torch.Tensor
    evicted: torch.Tensor
    wasted: torch.Tensor
    rdropped: torch.Tensor
    work_done: torch.Tensor

    FIELDS = ("rewards", "admitted", "departed", "jct", "svc_slots", "used", "running",
              "q_depth", "dropped", "evicted", "wasted", "rdropped", "work_done")

    def __getitem__(self, g) -> "LifecycleTrace":
        """Configuration ``g`` of a grid's trace."""
        return LifecycleTrace(*(getattr(self, f)[g] for f in self.FIELDS))


def _stacked(spec: ClusterSpec) -> bool:
    return spec.mask.dim() == 3


def init_state(spec: ClusterSpec, eta0, queue_depth: int,
               y0: Optional[torch.Tensor] = None) -> LifecycleState:
    """The empty system: no job held or queued, the decision ``y0`` (zeros
    when None). A single spec gives a state of G = 1; a stacked spec one
    of its G; ``y0`` and ``eta0`` per configuration or shared."""
    spec = spec if _stacked(spec) else ClusterSpec.stack([spec])
    G, L, R, K = spec.mask.shape[0], spec.L, spec.R, spec.K
    dev, dtype = spec.device, spec.a.dtype
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    i32 = torch.int32
    y = zeros(G, L, R, K) if y0 is None else torch.as_tensor(y0, dtype=dtype, device=dev)
    return LifecycleState(
        held=zeros(G, L, R, K), remaining=zeros(G, L),
        svc_arr=zeros(G, L, dt=i32), svc_start=zeros(G, L, dt=i32), svc_work=zeros(G, L),
        svc_retry=zeros(G, L, dt=i32),
        q_work=zeros(G, L, queue_depth), q_arr=zeros(G, L, queue_depth, dt=i32),
        q_ready=zeros(G, L, queue_depth, dt=i32), q_retry=zeros(G, L, queue_depth, dt=i32),
        q_len=zeros(G, L, dt=i32), dropped=zeros(G, dt=i32), rdropped=zeros(G, dt=i32),
        y=y.expand(G, L, R, K).clone(),
        eta=torch.as_tensor(eta0, dtype=dtype, device=dev).expand(G).clone(),
        t=0,
    )


def _tail(q_len: torch.Tensor, depth: int, dtype) -> torch.Tensor:
    """One-hot of the queue tail (G, L, Q); a full queue (q_len == Q) gives
    a zero row, as ``jax.nn.one_hot`` does."""
    return (torch.arange(depth, device=q_len.device) == q_len[..., None]).to(dtype)


def _evict(spec: ClusterSpec, state: LifecycleState, c_t: torch.Tensor,
           policy: FaultPolicy, queue_depth: int):
    """Evict the marginal in-service jobs that no longer fit ``c_t``.

    In-service jobs are ranked by ascending remaining work (index
    tiebreak: the SRPT order, pairwise and sort-free) and the longest
    prefix whose cumulative held allocation fits ``c_t`` elementwise,
    within FEAS_TOL, is kept. Evicted jobs re-queue at their port's tail
    with retry count n + 1, ready at t + min(backoff_base 2^n, backoff_cap),
    with their remaining work (``preserve_work``) or their full size; a
    spent retry budget or a full queue drops them. Dropped progress, and
    every restart's, is wasted work. Returns (state', evicted (G, L),
    wasted (G,)).
    """
    L = spec.L
    dtype = spec.a.dtype
    t = state.t
    in_svc = state.remaining > 0
    idx = torch.arange(L, device=in_svc.device)
    rem_key = torch.where(in_svc, state.remaining, torch.inf)
    # (G, L, L): job j at or before job l in the keep order
    before_eq = ((rem_key[..., None, :] < rem_key[..., :, None])
                 | ((rem_key[..., None, :] == rem_key[..., :, None])
                    & (idx[None, :] <= idx[:, None])))
    held_m = state.held * spec.mask[..., None]
    cum = torch.einsum("glj,gjrk->glrk", before_eq.to(dtype), held_m)
    slack = FEAS_TOL * (1.0 + c_t)
    fits = (cum <= (c_t + slack)[:, None]).all(-1).all(-1)
    evict = in_svc & ~fits

    progress = torch.clamp_min(state.svc_work - state.remaining, 0.0)
    n_retry = state.svc_retry + 1
    exhausted = n_retry > policy.max_retries
    can_rq = evict & ~exhausted & (state.q_len < queue_depth)
    delay = torch.clamp_max(
        policy.backoff_base * torch.exp2((n_retry - 1).to(dtype)), policy.backoff_cap,
    ).to(torch.int32)
    w_rq = (torch.clamp_min(state.remaining, WORK_FLOOR) if policy.preserve_work
            else state.svc_work)
    tail_f = _tail(state.q_len, queue_depth, dtype)
    tail_i = tail_f.to(torch.int32)
    rq = can_rq[..., None]
    q_work = torch.where(rq, state.q_work + tail_f * w_rq[..., None], state.q_work)
    q_arr = torch.where(rq, state.q_arr + tail_i * state.svc_arr[..., None], state.q_arr)
    q_ready = torch.where(rq, state.q_ready + tail_i * (t + delay)[..., None], state.q_ready)
    q_retry = torch.where(rq, state.q_retry + tail_i * n_retry[..., None], state.q_retry)
    q_len = state.q_len + can_rq.to(torch.int32)
    rq_drop = evict & ~can_rq
    rdropped = state.rdropped + rq_drop.sum(-1, dtype=torch.int32)
    lost = rq_drop if policy.preserve_work else evict
    wasted = (progress * lost.to(dtype)).sum(-1)
    new = dataclasses.replace(
        state,
        held=torch.where(evict[..., None, None], 0.0, state.held),
        remaining=torch.where(evict, 0.0, state.remaining),
        q_work=q_work, q_arr=q_arr, q_ready=q_ready, q_retry=q_retry, q_len=q_len,
        rdropped=rdropped,
    )
    return new, evict, wasted


def _propose(name: str, spec: ClusterSpec, x: torch.Tensor, w) -> torch.Tensor:
    """A heuristic's proposal for every configuration of a stacked spec:
    one batch for the batched policies, else one configuration at a time."""
    step = baselines.step_fn(name)
    if name in baselines.BATCHED:
        return step(spec, x, w)
    return torch.stack([step(spec[g], x[g], None if w is None else w[g])
                        for g in range(x.shape[0])])


def _step(spec: ClusterSpec, state: LifecycleState, x_t, w_t, f_t, *, algorithm: str,
          decay, rate_floor, backend: str, step_w, operands, fault_policy: FaultPolicy):
    """One slot of the lifecycle over G configurations (``spec`` stacked,
    x_t, w_t (G, L), f_t (G, K) or None). Returns (state', events), the
    events in ``LifecycleTrace`` order."""
    L = spec.L
    dtype = spec.a.dtype
    queue_depth = state.q_work.shape[-1]
    t = state.t
    G = x_t.shape[0]
    i32 = torch.int32
    size_aware = algorithm in baselines.SIZE_AWARE

    # faults: surviving capacity and eviction of the jobs that no longer fit
    # (size-aware mode rebalances everything against c_t below: no eviction)
    no_evict = torch.zeros((G, L), dtype=torch.bool, device=x_t.device)
    no_waste = torch.zeros((G,), dtype=dtype, device=x_t.device)
    if f_t is None:
        c_t, evict, wasted = None, no_evict, no_waste
    else:
        c_t = spec.c * f_t[:, None, :]
        if size_aware:
            evict, wasted = no_evict, no_waste
        else:
            with spans.span("repro_torch.lifecycle.evict"):
                state, evict, wasted = _evict(spec, state, c_t, fault_policy, queue_depth)

    # enqueue arrivals (one job a port a slot at most)
    with spans.span("repro_torch.lifecycle.enqueue"):
        arrive = x_t > 0
        can_q = state.q_len < queue_depth
        push = arrive & can_q
        pushf = push.to(dtype)
        tail = _tail(state.q_len, queue_depth, dtype)
        q_work = state.q_work + tail * (w_t * pushf)[..., None]
        pushed = (tail * pushf[..., None]).to(i32)
        q_arr = state.q_arr + pushed * t
        q_ready = state.q_ready + pushed * t       # arrivals are ready at once
        q_retry = state.q_retry
        q_len = state.q_len + push.to(i32)
        dropped = state.dropped + (arrive & ~can_q).sum(-1, dtype=i32)

    # admit the queue head on every idle port (under faults, once its
    # backoff has passed)
    with spans.span("repro_torch.lifecycle.admit"):
        admit = (state.remaining <= 0) & (q_len > 0)
        if f_t is not None:
            admit = admit & (q_ready[..., 0] <= t)
        new_work = torch.clamp_min(q_work[..., 0], WORK_FLOOR)
        new_arr, new_retry = q_arr[..., 0], q_retry[..., 0]
        shift = lambda q: torch.cat([q[..., 1:], torch.zeros_like(q[..., :1])], -1)
        adm = admit[..., None]
        q_work = torch.where(adm, shift(q_work), q_work)
        q_arr = torch.where(adm, shift(q_arr), q_arr)
        q_ready = torch.where(adm, shift(q_ready), q_ready)
        q_retry = torch.where(adm, shift(q_retry), q_retry)
        q_len = q_len - admit.to(i32)
        admit_f = admit.to(dtype)

    # allocate
    with spans.span("repro_torch.lifecycle.allocate"):
        if size_aware:
            # preemptive: the whole surviving capacity re-divided across this
            # slot's admissions and every job in service, ranked on remaining work
            sizes = torch.where(admit, new_work, state.remaining)
            spec_t = spec if c_t is None else dataclasses.replace(spec, c=c_t)
            held = baselines.step_fn(algorithm)(spec_t, (sizes > 0).to(dtype), step_w,
                                                sizes=sizes)
            reward_t = reward.total_reward(spec, admit_f, held * admit_f[..., None, None])
        else:
            # held allocations: admissions against the surviving residual capacity
            c_res = graph.residual_capacity(spec, state.held, c_t)
            if algorithm == "ogasched":
                y_prop = state.y
            else:
                y_prop = _propose(algorithm, graph.residual_spec(spec, state.held, c_t),
                                  admit_f, step_w)
            alloc = projection.project_spec_rows(spec, y_prop * admit_f[..., None, None], c_res,
                                                 operands=operands)
            reward_t = reward.total_reward(spec, admit_f, alloc)
            held = torch.where(admit[..., None, None], alloc, state.held)
        remaining = torch.where(admit, new_work, state.remaining)
        svc_arr = torch.where(admit, new_arr, state.svc_arr)
        svc_start = torch.where(admit, t, state.svc_start)
        svc_work = torch.where(admit, new_work, state.svc_work)
        svc_retry = torch.where(admit, new_retry, state.svc_retry)
        used = (held * spec.mask[..., None]).sum(-3)             # (G, R, K) slot peak

    # service at the utility-derived rate of the held allocation
    with spans.span("repro_torch.lifecycle.serve"):
        in_svc = remaining > 0
        in_svc_f = in_svc.to(dtype)
        rates = torch.clamp_min(reward.service_rates(spec, held), rate_floor)
        rem2 = remaining - rates * in_svc_f
        work_done = torch.minimum(rates, remaining) * in_svc_f

    with spans.span("repro_torch.lifecycle.depart"):
        depart = in_svc & (rem2 <= 0)
        departf = depart.to(dtype)
        jct = (t - svc_arr + 1).to(dtype) * departf
        svc_slots = (t - svc_start + 1).to(dtype) * departf
        held = torch.where(depart[..., None, None], 0.0, held)
        remaining = torch.where(depart, 0.0, torch.clamp_min(rem2, 0.0))

    # the policy update: OGA ascends on the arrival indicator, as in slot mode
    with spans.span("repro_torch.lifecycle.update"):
        if algorithm != "ogasched":
            y_next = state.y
        elif backend == "fused":
            y_next = ops.oga_update_batch(spec, state.y, x_t, state.eta, operands=operands)
        else:
            y_next = torch.stack([
                ops.oga_update_spec(spec[g], state.y[g], x_t[g], state.eta[g], backend=backend)
                for g in range(G)])

    new_state = LifecycleState(
        held=held, remaining=remaining, svc_arr=svc_arr, svc_start=svc_start,
        svc_work=svc_work, svc_retry=svc_retry, q_work=q_work, q_arr=q_arr,
        q_ready=q_ready, q_retry=q_retry, q_len=q_len, dropped=dropped,
        rdropped=state.rdropped, y=y_next, eta=state.eta * decay, t=t + 1,
    )
    events = (reward_t, admit, depart, jct, svc_slots, used, remaining > 0, q_len, dropped,
              evict, wasted, state.rdropped, work_done)
    return new_state, events


def default_y0(spec: ClusterSpec) -> torch.Tensor:
    """OGASCHED's start: ``graph.random_feasible_decision`` from a numpy
    generator of seed 0 (the reference draws its start from
    ``jax.random.PRNGKey(0)``, which the port cannot reproduce)."""
    return graph.random_feasible_decision(spec, np.random.default_rng(0))


def run_batch(spec: ClusterSpec, arrivals, works, algorithm: str = "ogasched", *,
              eta0=25.0, decay=0.9999, queue_depth: int = 8, rate_floor=1e-3,
              backend: str = "auto", y0=None, faults=None,
              fault_policy: FaultPolicy = FaultPolicy(),
              device: DeviceLike = None) -> LifecycleTrace:
    """``run`` over a stacked grid: ``spec`` leading (G,), arrivals and works
    (G, T, L), faults (G, T, K) or None, eta0 and decay scalars or (G,),
    y0 (G, L, R, K) or None. Every slot is one ``_step`` over all G
    configurations (one fused-kernel and one projection launch a slot for
    OGASCHED on the card). Returns a trace whose fields lead with (G, T)."""
    with spans.span("repro_torch.lifecycle.segment"):
        with spans.span("repro_torch.lifecycle.setup"):
            dev = resolve_device(device)
            spec = spec.to(dev)
            arrivals = torch.as_tensor(arrivals, device=dev)
            works = torch.as_tensor(works, device=dev)
            G, T, L = arrivals.shape
            if tuple(works.shape) != tuple(arrivals.shape):
                raise ValueError(f"works must pair 1:1 with arrivals: got works "
                                 f"{tuple(works.shape)} vs arrivals {tuple(arrivals.shape)}")
            if faults is not None:
                faults = torch.as_tensor(faults, device=dev)
                if tuple(faults.shape) != (G, T, spec.K):
                    raise ValueError(f"faults must be a (T, K) capacity-multiplier stream: got "
                                     f"{tuple(faults.shape[-2:])} vs T={T}, K={spec.K}")
            if algorithm not in ALL_ALGORITHMS:
                raise ValueError(f"algorithm must be one of {ALL_ALGORITHMS}, "
                                 f"got {algorithm!r}")
            backend = ops.resolve_oga_backend(backend)
            use_oga = algorithm == "ogasched"
            operands = ops.pack_spec_operands(spec)
            step_w = None if use_oga else baselines.default_parallelism(spec, algorithm)
            if y0 is None and use_oga:
                y0 = default_y0(spec)
            state = init_state(spec, eta0, queue_depth, y0)
            decay = torch.as_tensor(decay, dtype=spec.a.dtype, device=dev)
            dtype, i32, b = spec.a.dtype, torch.int32, torch.bool
            R, K = spec.R, spec.K
            empty = lambda shape, dt: torch.empty((G, T) + shape, dtype=dt, device=dev)
            bufs = [empty((), dtype), empty((L,), b), empty((L,), b), empty((L,), dtype),
                    empty((L,), dtype), empty((R, K), dtype), empty((L,), b), empty((L,), i32),
                    empty((), i32), empty((L,), b), empty((), dtype), empty((), i32),
                    empty((L,), dtype)]
        for t in range(T):
            with spans.span("repro_torch.lifecycle.step"):
                state, events = _step(
                    spec, state, arrivals[:, t], works[:, t],
                    None if faults is None else faults[:, t], algorithm=algorithm,
                    decay=decay, rate_floor=rate_floor, backend=backend, step_w=step_w,
                    operands=operands, fault_policy=fault_policy)
            with spans.span("repro_torch.lifecycle.record"):
                for buf, ev in zip(bufs, events):
                    buf[:, t] = ev
        return LifecycleTrace(*bufs)


def run(spec: ClusterSpec, arrivals, works, algorithm: str = "ogasched", *, eta0=25.0,
        decay=0.9999, queue_depth: int = 8, rate_floor=1e-3, backend: str = "auto",
        y0=None, faults=None, fault_policy: FaultPolicy = FaultPolicy(),
        device: DeviceLike = None) -> LifecycleTrace:
    """Run one algorithm through the job lifecycle over a trace, on
    ``device`` (None: the CUDA card).

    arrivals, works: (T, L) arrival indicators and job sizes (works[t, l]
    is consumed iff a job arrives at (t, l)); algorithm: "ogasched" or a
    baseline of ``baselines.ALL_BASELINES`` (heSRPT consumes the sizes);
    eta0, decay: OGA's learning rate; queue_depth: per-port FIFO bound;
    rate_floor: the least service rate, so a zero allocation still drains;
    backend: the OGA update's ("auto" | "fused" | "reference"); y0:
    OGASCHED's start, by default ``default_y0``: an allocation is held
    for a job's tenure, and a zero start would pin the first job of every
    port to the rate floor; faults: an optional (T, K) capacity-multiplier
    stream (``trace.build_faults``), slot t running against
    ``c * faults[t]``; fault_policy: eviction, retry and backoff.
    Returns a LifecycleTrace whose fields lead with T.
    """
    dev = resolve_device(device)
    lead = lambda t: None if t is None else torch.as_tensor(t, device=dev)[None]
    tr = run_batch(ClusterSpec.stack([spec.to(dev)]), lead(arrivals), lead(works), algorithm,
                   eta0=eta0, decay=decay, queue_depth=queue_depth, rate_floor=rate_floor,
                   backend=backend, y0=lead(y0), faults=lead(faults),
                   fault_policy=fault_policy, device=dev)
    return tr[0]


def summarize_batch(tr: LifecycleTrace, spec: ClusterSpec) -> dict[str, torch.Tensor]:
    """Batched ``summarize`` on the device: every field of ``tr`` leads with
    (G, T), ``spec`` with (G,); returns {metric: (G,)} with the scalars
    ``summarize`` reports per row. The p99 is numpy's linear interpolation
    over the departed jobs (the rest sort to +inf past them)."""
    G, T = tr.rewards.shape
    dtype = tr.jct.dtype
    dep = tr.departed.reshape(G, -1)
    jct = tr.jct.reshape(G, -1)
    svc = tr.svc_slots.reshape(G, -1)
    n = dep.sum(-1)
    nf = torch.clamp_min(n, 1).to(dtype)
    some = n > 0
    nan = torch.full_like(nf, float("nan"))
    jct_mean = torch.where(dep, jct, 0.0).sum(-1) / nf
    slow_mean = torch.where(dep, jct / torch.clamp_min(svc, 1.0), 0.0).sum(-1) / nf
    vals = torch.sort(torch.where(dep, jct, torch.inf), dim=-1).values
    pos = 0.99 * (nf - 1.0)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    v_lo = vals.gather(-1, lo[:, None])[:, 0]
    v_hi = vals.gather(-1, hi[:, None])[:, 0]
    p99 = v_lo + (pos - lo.to(dtype)) * (v_hi - v_lo)
    util_k = (tr.used / torch.clamp_min(spec.c, 1e-9)[:, None]).mean((1, 2))   # (G, K)
    evictions = tr.evicted.to(dtype).sum((1, 2))
    fault_drops = tr.rdropped[:, -1].to(dtype)
    wasted = tr.wasted.sum(-1)
    done = tr.work_done.sum((1, 2))
    out = {
        "completed": n.to(dtype),
        "arrived": (tr.admitted.to(dtype).sum((1, 2)) + tr.q_depth[:, -1].to(dtype).sum(-1)
                    - (evictions - fault_drops)),
        "dropped": tr.dropped[:, -1].to(dtype),
        "throughput": n.to(dtype) / T,
        "goodput": (done - wasted) / T,
        "wasted_work": wasted,
        "evictions": evictions,
        "fault_drops": fault_drops,
        "jct_mean": torch.where(some, jct_mean, nan),
        "jct_p99": torch.where(some, p99, nan),
        "slowdown_mean": torch.where(some, slow_mean, nan),
        "utilization": util_k.mean(-1),
    }
    for k in range(util_k.shape[-1]):
        out[f"utilization/{k}"] = util_k[:, k]
    return out


def summarize(tr: LifecycleTrace, spec: ClusterSpec) -> dict[str, float]:
    """Host-side scalar metrics of one lifecycle trace (fields lead with T).

    jct_mean / jct_p99: completion time in slots over finished jobs;
    slowdown_mean: mean JCT / service time; utilization: mean over slots,
    instances and resources of used / c, utilization/<k> per resource;
    completed / arrived / dropped: job counts (arrived counts each accepted
    job once); throughput: completed per slot; goodput: (drained work -
    wasted work) / T; wasted_work, evictions, fault_drops.
    """
    host = lambda x: x.detach().cpu().numpy()
    departed = host(tr.departed).astype(bool)
    jct = host(tr.jct)[departed]
    svc = host(tr.svc_slots)[departed]
    used = host(tr.used)
    c = np.maximum(host(spec.c), 1e-9)
    util_k = (used / c[None]).mean(axis=(0, 1))
    evictions = float(host(tr.evicted).sum())
    fault_drops = float(host(tr.rdropped)[-1])
    wasted = float(host(tr.wasted).sum())
    done = float(host(tr.work_done).sum())
    T = departed.shape[0]
    out = {
        "completed": float(departed.sum()),
        "arrived": float(host(tr.admitted).sum() + host(tr.q_depth)[-1].sum())
                   - (evictions - fault_drops),
        "dropped": float(host(tr.dropped)[-1]),
        "throughput": float(departed.sum()) / T,
        "goodput": (done - wasted) / T,
        "wasted_work": wasted,
        "evictions": evictions,
        "fault_drops": fault_drops,
        "jct_mean": float(jct.mean()) if jct.size else float("nan"),
        "jct_p99": float(np.percentile(jct, 99)) if jct.size else float("nan"),
        "slowdown_mean": (float((jct / np.maximum(svc, 1.0)).mean()) if jct.size
                          else float("nan")),
        "utilization": float(util_k.mean()),
    }
    for k, u in enumerate(util_k):
        out[f"utilization/{k}"] = float(u)
    return out


def recovery_time(rewards, faults, frac: float = 0.95, window: int = 25) -> float:
    """Slots from the first fault until the reward recovers to ``frac`` of
    its pre-fault level (the mean reward before the first slot where any
    resource's multiplier is below 1): the first slot at or after the
    fault where the trailing ``window``-slot moving average reaches it.
    0.0 when the stream never faults, +inf when the run never recovers,
    NaN when the fault lands before any pre-fault baseline exists."""
    r = np.asarray(rewards, np.float64)
    f = np.asarray(faults)
    faulted = np.nonzero((f < 1.0).any(axis=-1))[0]
    if faulted.size == 0:
        return 0.0
    t0 = int(faulted[0])
    if t0 == 0:
        return float("nan")
    base = r[:t0].mean()
    if base <= 0.0:
        return float("nan")
    # trailing moving average, the window clipped at the start of the trace
    cum = np.concatenate([[0.0], np.cumsum(r)])
    lo = np.maximum(np.arange(len(r)) - window + 1, 0)
    avg = (cum[np.arange(len(r)) + 1] - cum[lo]) / (np.arange(len(r)) - lo + 1)
    ok = np.nonzero(avg[t0:] >= frac * base)[0]
    return float(ok[0]) if ok.size else float("inf")
