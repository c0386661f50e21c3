"""Lifecycle mode: jobs hold their allocation until their work drains.

The window drives the program's ``repro_torch.sched.lifecycle.run`` with
``algorithm="ogasched"`` over consecutive segments of the trace, each of
``segment_slots`` slots, with the benchmark's feasible start y0, and
synchronises at each segment's end. ``lifecycle.run`` carries no state
between calls, so each segment starts from an empty system.

Checked: a sample of the window's segments drawn from the seed (a
reservoir whose draw for a segment is made before it runs). The reference
runs each from the benchmark's inputs (the segment's arrivals and sizes,
y0) and its event record is compared with the one the program returned for
it. OGA's iteration parts two sound float32 runs within a few slots, so the
reference proposes from the program's decisions y(t+1) of that segment and
checks each against its own update of the one before
(``reference.lifecycle``). ``lifecycle.run`` does not return them: the
driver wraps the program's ``ops.oga_update_batch`` to keep a reference to
each output of a sampled segment (no copy, no sync; the wrapper passes
every call through unchanged).
"""
from __future__ import annotations

import random
import time

import torch

from chipbench import program
from chipbench.reference import lifecycle as ref_lifecycle
from chipbench.reference import oga
from chipbench.traffic import synth

# slots of arrivals and job sizes drawn; segments past them wrap around
ARRIVAL_SLOTS = 1 << 16
# window segments checked
RESERVOIR = 1
SMALLEST = 1e-30
# fields of the record that hold counts, flags or whole slots: any
# difference is a different event
DISCRETE = ("admitted", "departed", "jct", "svc_slots", "running", "q_depth", "dropped",
            "evicted", "rdropped")
# fields of the record that hold work: drained, and wasted (none without faults)
WORK = ("work_done", "wasted")


class Driver:
    """One cell in lifecycle mode; ``setup``, then ``unit`` (a segment)
    until the window closes, then ``check``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.sampler = random.Random(f"{seed}:sample")
        self.reservoir = []
        self.seen = 0
        self.entry_s = []
        self.occupancy = []

    def _install_spy(self):
        from repro_torch.kernels import ops

        orig = ops.oga_update_batch

        def oga_update_batch(*args, **kwargs):
            y = orig(*args, **kwargs)
            if self.decisions is not None:
                self.decisions.append(y[0])
            return y

        ops.oga_update_batch = oga_update_batch
        self.restore = (ops, orig)

    def kernel_shapes(self):
        c = self.cfg
        return [("oga_step", c["R"] * c["K"], c["L"]), ("proj", c["R"] * c["K"], c["L"])]

    def setup(self) -> dict:
        from repro_torch.sched import lifecycle

        c, dev = self.cfg, self.device
        self.inputs = synth.make_spec(self.seed, c, dev)
        self.arrivals = synth.make_arrivals(self.seed, self.traffic, ARRIVAL_SLOTS, c["L"], dev)
        self.works = synth.make_works(self.seed, self.traffic, ARRIVAL_SLOTS, c["L"], dev)
        self.y0 = synth.make_y0(self.seed, self.inputs, dev)
        info = program.prepare_kernels(dev, self.kernel_shapes())
        self.lifecycle = lifecycle
        self.spec = program.cluster_spec(self.inputs)
        self.S = c["segment_slots"]
        self.decisions = []
        self._install_spy()
        # the set-up segment keeps its decisions too, so the allocator holds
        # the blocks a sampled segment of the window will keep
        self._segment(0)
        self.decisions = None
        self.seg = 1
        _sync(dev)
        return info

    def _window(self, s: int):
        lo = (s % (ARRIVAL_SLOTS // self.S)) * self.S
        return self.arrivals[lo:lo + self.S], self.works[lo:lo + self.S]

    def _segment(self, s: int):
        c = self.cfg
        arrivals, works = self._window(s)
        return self.lifecycle.run(
            self.spec, arrivals, works, "ogasched", eta0=c["eta0"], decay=c["decay"],
            queue_depth=c["queue_depth"], rate_floor=c["rate_floor"], y0=self.y0,
            device=self.device)

    def unit(self) -> int:
        """One segment of ``segment_slots`` slots, synchronised at its end."""
        s = self.seg
        self.seen += 1
        # the reservoir's draw for this segment does not depend on it, so it
        # is made first, and a segment it will not keep keeps nothing
        j = self.sampler.randrange(self.seen)
        keep = j < RESERVOIR
        if keep:
            if len(self.reservoir) == RESERVOIR:
                self.reservoir.pop(j)
            self.decisions = []
        h0 = time.perf_counter()
        tr = self._segment(s)
        self.entry_s.append(time.perf_counter() - h0)
        _sync(self.device)
        self.seg = s + 1
        self.occupancy.append((tr.running, tr.q_depth, tr.dropped, tr.admitted, tr.departed))
        if keep:
            self.reservoir.append((s, tr, self.decisions))
            self.decisions = None
        return self.S

    def slot_latency_ms(self):
        return None

    def retained_bytes(self) -> int:
        """Bytes of the program's outputs that the check keeps past the
        segment that made them: the sampled segments' decisions and event
        records."""
        return sum(t.numel() * t.element_size()
                   for _, tr, decisions in self.reservoir
                   for t in [*decisions, *(getattr(tr, f) for f in ref_lifecycle.FIELDS)])

    def free_program_state(self):
        ops, orig = self.restore
        ops.oga_update_batch = orig
        self.occupancy_summary = self._occupancy()
        self.occupancy = []

    def _occupancy(self) -> dict:
        """Ports in service, queue length, drops, admissions and departures
        over the window's segments (host numbers, read after the window)."""
        run, qd, drop, adm, dep = (torch.stack(v).float() for v in zip(*self.occupancy))
        return {"ports_in_service": float(run.sum(-1).mean()),
                "queue_mean": float(qd.mean()),
                "drops_per_segment": float(drop[:, -1].mean()),
                "admitted_per_slot": float(adm.sum(-1).mean()),
                "departed_per_slot": float(dep.sum(-1).mean())}

    def check(self, control: bool = False):
        """The numbers compared, each the largest over the checked segments:
        reward_err, alloc_err and work_err, the largest gap of the slot
        rewards, of the slots' occupancy sum_l held (the allocations'
        projection) and of the work drained and wasted, over the reference's
        largest; events, the entries of the record's counts, flags and whole
        slots (admitted, departed, JCT, service slots, running, queue depth,
        drops, evictions) that differ; decision_err, OGA's decisions against
        the reference's update of the one before. With ``control`` the
        reference in bfloat16 takes the program's place."""
        c = self.cfg
        kw = dict(eta0=c["eta0"], decay=c["decay"], queue_depth=c["queue_depth"],
                  rate_floor=c["rate_floor"])
        ref = oga.Cluster(self.inputs)
        rows = []
        for s, tr, decisions in sorted(self.reservoir, key=lambda i: i[0]):
            arrivals, works = self._window(s)
            if control:
                low = oga.Cluster(self.inputs, torch.bfloat16)
                got = ref_lifecycle.run(low, arrivals, works, self.y0, keep_decisions=True, **kw)
                decisions = got.pop("decisions")
            else:
                if len(decisions) != self.S:
                    raise RuntimeError(
                        f"segment {s}: the program's lifecycle.run called ops.oga_update_batch "
                        f"{len(decisions)} times for {self.S} slots; the check reads OGA's "
                        f"decisions from those calls and cannot judge the segment without them")
                got = {f: getattr(tr, f) for f in ref_lifecycle.FIELDS}
            want = ref_lifecycle.run(ref, arrivals, works, self.y0, decisions=decisions, **kw)
            rel = lambda f: float((got[f].float() - want[f].float()).abs().max()
                                  / want[f].float().abs().max().clamp_min(SMALLEST))
            rows.append({"segment": s, "reward_err": rel("rewards"), "alloc_err": rel("used"),
                         "work_err": max(rel(f) for f in WORK),
                         "decision_err": want["decision_err"],
                         "events": sum(int((got[f] != want[f]).sum()) for f in DISCRETE)})
            del got, want, decisions
        keys = ("reward_err", "alloc_err", "work_err", "decision_err", "events")
        numbers = {k: max(r[k] for r in rows) for k in keys}
        diag = {"checked_segments": [r["segment"] for r in rows],
                **getattr(self, "occupancy_summary", {})}
        return numbers, rows, diag


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
