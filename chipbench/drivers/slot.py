"""Slot mode: paper Alg. 1 on one cluster, slot after slot.

The window drives the program's ``repro_torch.core.ogasched.oga_step`` as
``ogasched.run``'s loop does: state from ``ogasched.init_state``, static
operands from ``ops.pack_spec_operands`` once at set-up, the "auto" (fused)
backend, the slot's reward written into a preallocated buffer. After each
slot the host synchronises: a slot's decision is delivered to the cluster
before the next slot's arrivals. The loop is closed: one scheduler, slots
back to back.

Checked slots: slot 0 from the reference's own start y(1) = 0, a sample of
the window's slots drawn from the seed (a reservoir, so holding the
program's decisions costs no copy), and the window's last slot. At each,
the reference takes the program's y(t) and works out q(x(t), y(t)) and
y(t+1) itself, with its own learning rate of slot t.
"""
from __future__ import annotations

import random
import time

import torch

from chipbench import program
from chipbench.reference import oga
from chipbench.traffic import synth

# slots of arrivals drawn: more than any window completes at >= 0.4 ms a slot
ARRIVAL_SLOTS = 1 << 17
# slots run in set-up, the first of them checked from the reference's start
WARMUP_SLOTS = 3
# window slots checked besides slot 0 and the last
RESERVOIR = 4
SMALLEST = 1e-30


class Driver:
    """One cell in slot mode; ``setup``, then ``unit`` until the window
    closes, then ``check``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.sampler = random.Random(f"{seed}:sample")
        self.reservoir = []
        self.seen = 0
        self.entry_s = []
        self.marks = []

    def kernel_shapes(self):
        c = self.cfg
        return [("oga_step", c["R"] * c["K"], c["L"])]

    def setup(self) -> dict:
        from repro_torch.core import ogasched
        from repro_torch.kernels import ops

        c, dev = self.cfg, self.device
        self.inputs = synth.make_spec(self.seed, c, dev)
        self.arrivals = synth.make_arrivals(self.seed, self.traffic, ARRIVAL_SLOTS, c["L"], dev)
        info = program.prepare_kernels(dev, self.kernel_shapes())
        self.ogasched = ogasched
        self.spec = program.cluster_spec(self.inputs)
        self.backend = ops.resolve_oga_backend("auto")
        self.operands = ops.pack_spec_operands(self.spec) if self.backend == "fused" else None
        self.state = ogasched.init_state(self.spec, c["eta0"])
        self.rewards = torch.empty(ARRIVAL_SLOTS, dtype=self.spec.a.dtype, device=dev)
        self.t = 0
        for _ in range(WARMUP_SLOTS):
            t, _, y_out = self._slot()
            if t == 0:
                self.first = (0, None, y_out)
        _sync(dev)
        return info

    def _slot(self):
        t = self.t
        if t >= ARRIVAL_SLOTS:
            raise RuntimeError(f"the window outlasted the {ARRIVAL_SLOTS} slots of arrivals")
        y_in = self.state.y
        self.state, self.rewards[t] = self.ogasched.oga_step(
            self.spec, self.state, self.arrivals[t], self.cfg["decay"], self.backend,
            self.operands)
        self.t = t + 1
        return t, y_in, self.state.y

    def unit(self) -> int:
        """One slot: from handing over x(t) to the synchronised decision."""
        start = _mark(self.device)
        h0 = time.perf_counter()
        item = self._slot()
        self.entry_s.append(time.perf_counter() - h0)
        end = _mark(self.device)
        _sync(self.device)
        self.marks.append((start, end))
        self.last = item
        self.seen += 1
        if len(self.reservoir) < RESERVOIR:
            self.reservoir.append(item)
        else:
            j = self.sampler.randrange(self.seen)
            if j < RESERVOIR:
                self.reservoir[j] = item
        return 1

    def slot_latency_ms(self):
        """Each window slot's time from its start to its decision, on the
        device's clock (CUDA events); None on the CPU."""
        if self.device.type != "cuda":
            return None
        return [a.elapsed_time(b) for a, b in self.marks]

    def retained_bytes(self) -> int:
        """Bytes of the program's decisions that the check keeps past the
        slot that made them (the reservoir, slot 0's and the last)."""
        kept = {t.data_ptr(): t for item in [self.first, *self.reservoir, self.last]
                for t in item[1:] if t is not None}
        return sum(t.numel() * t.element_size() for t in kept.values())

    def free_program_state(self):
        """Drop what only the program needs: its operands and buffers."""
        self.operands = None
        self.state = None

    def check(self, control: bool = False):
        """The numbers compared, each the largest over the checked slots:
        reward_err = |q - q_ref| / |q_ref|, decision_err = max |y(t+1) -
        u| / max |u| for the reference's update u of y(t) (the nearest, where
        k* ties: ``oga.decision_gap``). With ``control`` the reference
        computed in bfloat16 takes the program's place. Returns (numbers,
        per-slot rows, diagnostics)."""
        c = self.cfg
        ref = oga.Cluster(self.inputs)
        low = oga.Cluster(self.inputs, torch.bfloat16) if control else None
        items = {t: (t, y_in, y_out) for t, y_in, y_out in
                 [self.first, *sorted(self.reservoir, key=lambda i: i[0]), self.last]}
        etas = oga.learning_rates(c["eta0"], c["decay"], items)
        etas_low = oga.learning_rates(c["eta0"], c["decay"], items, torch.bfloat16)
        rows = []
        for t, y_in, y_out in items.values():
            x = self.arrivals[t]
            y = torch.zeros_like(y_out) if t == 0 else y_in
            eta = etas[t]
            q_ref = oga.reward(ref, x, y)
            if control:
                q, y_next = oga.oga_slot(low, x, y.to(torch.bfloat16), etas_low[t])
            else:
                q, y_next = self.rewards[t], y_out
            rows.append({
                "slot": t,
                "reward_err": float((q.float() - q_ref).abs() / q_ref.abs().clamp_min(SMALLEST)),
                "decision_err": oga.decision_gap(ref, x, y, eta, y_next),
                # y(1) = 0 ties every k exactly, and both sides take the first
                "kstar_margin": kstar_margin(ref, y) if t else None,
            })
            del y_next
        numbers = {k: max(r[k] for r in rows) for k in ("reward_err", "decision_err")}
        diag = {"checked_slots": [r["slot"] for r in rows],
                "kstar_margin": min((r["kstar_margin"] for r in rows if r["kstar_margin"]
                                     is not None), default=None)}
        return numbers, rows, diag


def kstar_margin(cl: oga.Cluster, y) -> float:
    """The smallest relative gap, over ports with an edge, between the
    largest and the second largest beta_k sum_r y m: where it nears the
    float32 rounding of the sums, k* (eq. 27) may differ between two
    sound computations."""
    _, quota = oga.gain_and_quota(cl, y)
    top = torch.topk(cl.beta[None] * quota, 2, dim=1).values
    gap = (top[:, 0] - top[:, 1]) / top[:, 0].abs().clamp_min(SMALLEST)
    return float(gap.min())


def _mark(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
