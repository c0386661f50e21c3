"""The plain reference of the job lifecycle under OGASched (no faults).

Jobs arrive with a size, wait in a per-port FIFO of bounded depth, are
admitted one at a time per port when the port is idle, hold the allocation
they were given until their work drains at the port's service rate, and
leave. The allocation of an admitted job is OGA's decision y(t) on its
port, projected onto the capacity that the jobs in service leave. OGA
ascends on the arrival indicators every slot (paper Alg. 1).

Slot order: enqueue arrivals (a full queue drops), admit queue heads on
idle ports, allocate, collect the admission reward q(admitted, alloc),
serve every job in service at max(rate, rate_floor), depart the drained
ones, update y. The run starts from an empty system and the given y0.

Returns the event record the program's ``lifecycle.run`` returns, one
(T, ...) tensor a field, computed in the dtype of the cluster given.

OGA's iteration at eta 25 stretches a difference in y by up to ~37 a slot
(the log utility's f' changes by alpha / (1 + y)^2 near y = 0), so two
sound float32 runs part within a few slots. Given the program's decisions
y(1..T), the reference therefore proposes from them, as the program did,
and checks each against its own update of the one before (y(0) = y0, the
benchmark's input): ``decision_err``. Everything else (queues, admission,
the allocation's projection, the reward, service and departures) is the
reference's own.
"""
from __future__ import annotations

import torch

from chipbench.reference import oga

# jobs with sampled work below this floor still occupy their port a slot
WORK_FLOOR = 1e-6
FIELDS = ("rewards", "admitted", "departed", "jct", "svc_slots", "used", "running",
          "q_depth", "dropped", "evicted", "wasted", "rdropped", "work_done")


def run(cl: oga.Cluster, arrivals, works, y0, *, eta0: float, decay: float,
        queue_depth: int, rate_floor: float, decisions=None,
        keep_decisions: bool = False) -> dict:
    """The event record of a segment: arrivals, works (T, L), y0 (L, R, K).

    ``decisions``: the T decisions y(t+1) of the run under check, each used
    as the next slot's y; the record then has ``decision_err``, the largest
    ``oga.decision_gap`` of y(t+1) from y(t) over the slots. With
    ``keep_decisions`` the record keeps the reference's own, ``decisions``."""
    T, L = arrivals.shape
    dev, dt = y0.device, cl.dtype
    i32 = torch.int32
    held = torch.zeros_like(y0, dtype=dt)
    y = y0.to(dt)
    remaining = torch.zeros(L, dtype=dt, device=dev)
    svc_arr = torch.zeros(L, dtype=i32, device=dev)
    svc_start = torch.zeros(L, dtype=i32, device=dev)
    q_work = torch.zeros((L, queue_depth), dtype=dt, device=dev)
    q_arr = torch.zeros((L, queue_depth), dtype=i32, device=dev)
    q_len = torch.zeros(L, dtype=i32, device=dev)
    dropped = torch.zeros((), dtype=i32, device=dev)
    eta = torch.tensor(eta0, dtype=dt)
    d = torch.tensor(decay, dtype=dt)
    slot = torch.arange(queue_depth, device=dev)
    rec = {f: [] for f in FIELDS}
    worst, kept = 0.0, []
    for t in range(T):
        x = arrivals[t] > 0
        w = works[t].to(dt)
        # enqueue at the tail; a full queue drops the arrival
        room = q_len < queue_depth
        push = x & room
        at_tail = (slot[None] == q_len[:, None]) & push[:, None]
        q_work = torch.where(at_tail, w[:, None], q_work)
        q_arr = torch.where(at_tail, t, q_arr)
        q_len = q_len + push.to(i32)
        dropped = dropped + (x & ~room).sum(dtype=i32)
        # admit the head of every non-empty queue on an idle port
        admit = (remaining <= 0) & (q_len > 0)
        head_work = torch.clamp_min(q_work[:, 0], WORK_FLOOR)
        head_arr = q_arr[:, 0]
        pop = admit[:, None]
        q_work = torch.where(pop, torch.roll(q_work, -1, 1).index_fill(1, slot[-1:], 0), q_work)
        q_arr = torch.where(pop, torch.roll(q_arr, -1, 1).index_fill(1, slot[-1:], 0), q_arr)
        q_len = q_len - admit.to(i32)
        # allocate: y on the admitted ports, projected onto the residual
        adm = admit.to(dt)
        c_res = torch.clamp_min(cl.c - (held * cl.mask[..., None]).sum(0), 0.0)
        alloc = oga.project(cl, y * adm[:, None, None], c_res)
        rec["rewards"].append(oga.reward(cl, adm, alloc))
        held = torch.where(admit[:, None, None], alloc, held)
        remaining = torch.where(admit, head_work, remaining)
        svc_arr = torch.where(admit, head_arr, svc_arr)
        svc_start = torch.where(admit, t, svc_start)
        rec["used"].append((held * cl.mask[..., None]).sum(0))
        # serve and depart
        busy = remaining > 0
        rate = torch.clamp_min(oga.service_rates(cl, held), rate_floor)
        left = remaining - rate * busy.to(dt)
        rec["work_done"].append(torch.minimum(rate, remaining) * busy.to(dt))
        depart = busy & (left <= 0)
        rec["departed"].append(depart)
        rec["jct"].append(torch.where(depart, (t - svc_arr + 1).to(dt), 0.0))
        rec["svc_slots"].append(torch.where(depart, (t - svc_start + 1).to(dt), 0.0))
        held = torch.where(depart[:, None, None], 0.0, held)
        remaining = torch.where(depart, 0.0, torch.clamp_min(left, 0.0))
        rec["admitted"].append(admit)
        rec["running"].append(remaining > 0)
        rec["q_depth"].append(q_len.clone())
        rec["dropped"].append(dropped.clone())
        # OGA's update on the arrival indicator
        xf = x.to(dt)
        if decisions is None:
            nxt = oga.project(cl, y + eta.to(dev) * oga.gradient(cl, xf, y))
            if keep_decisions:
                kept.append(nxt)
            y = nxt
        else:
            worst = max(worst, oga.decision_gap(cl, xf, y, eta, decisions[t]))
            y = decisions[t].to(dt)
        eta = eta * d
    out = {f: torch.stack(v) for f, v in rec.items() if v}
    if decisions is not None:
        out["decision_err"] = worst
    if keep_decisions:
        out["decisions"] = kept
    out["evicted"] = torch.zeros((T, L), dtype=torch.bool, device=dev)
    out["wasted"] = torch.zeros(T, dtype=dt, device=dev)
    out["rdropped"] = torch.zeros(T, dtype=i32, device=dev)
    return out
