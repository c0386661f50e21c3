"""The traced run's records: a ``torch.profiler`` trace of the window, read
from its Chrome-trace export into device operations, host operations, the
device's busy time and the idle gaps between its operations.

Device time is CUPTI's (the profiler's CUDA activity): kernels, copies and
fills. The window is the harness's ``chipbench.window`` span; an idle gap
is named after the innermost host span or operator that was running at
its middle, so the breakdown says what the host did while the card waited.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile

WINDOW_SPAN = "chipbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
NO_HOST_OP = "host (between operators)"
# the program's own CUDA kernels live in this C++ namespace
PROGRAM_NAMESPACE = "repro_torch::"
BREAKDOWN_ENTRIES = 10


def profile():
    """A profiler of host and CUDA activity, neither shapes nor stacks."""
    import torch.profiler as tp

    return tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA])


def read(prof) -> dict:
    """Records of a finished profiler: device_ops [(name, kind, start_us,
    dur_us)] inside the window, host_ops, window_s, busy_s and idle gaps
    [(host name, seconds)]."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return records_of(events)


def records_of(events) -> dict:
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if ts >= w0 and ts + dur <= w1:
                dev.append((e["name"], e["cat"], ts, dur))
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN:
            host.append((e["name"], ts, dur))
    dev.sort(key=lambda d: d[2])
    busy, gaps = _busy_and_gaps(dev, w0, w1)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6, "device_ops": dev,
            "idle_gaps": _name_gaps(gaps, host)}


def _busy_and_gaps(dev, w0, w1):
    """Union of the device intervals within [w0, w1] and the gaps between."""
    busy, gaps = 0.0, []
    cursor = w0
    for _, _, ts, dur in dev:
        end = ts + dur
        if ts > cursor:
            gaps.append((cursor, ts))
        if end > cursor:
            busy += end - max(ts, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    return busy, gaps


def _name_gaps(gaps, host):
    """(name, seconds) of each gap: the innermost host operation (the latest
    to start) running at the gap's middle. One sweep: the gaps and the
    operations in time order, the operations still running kept aside."""
    host = sorted(host, key=lambda h: h[1])
    out, running, i = [], [], 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][1] <= mid:
            running.append(host[i])
            i += 1
        running = [h for h in running if h[1] + h[2] >= mid]
        name = max(running, key=lambda h: h[1])[0] if running else NO_HOST_OP
        out.append((name, (g1 - g0) * 1e-6))
    return out


def breakdown(rec: dict) -> dict:
    """The device operations that took most time and the longest idle time
    by what the host was doing, at most BREAKDOWN_ENTRIES each, seconds."""
    ops = collections.Counter()
    for name, _, _, dur in rec["device_ops"]:
        ops[name] += dur * 1e-6
    idle = collections.Counter()
    for name, s in rec["idle_gaps"]:
        idle[name] += s
    return {"device_ops": [[n, s] for n, s in ops.most_common(BREAKDOWN_ENTRIES)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(BREAKDOWN_ENTRIES)]}


def is_program_kernel(name: str) -> bool:
    return PROGRAM_NAMESPACE in name


def roofline_pct(rec: dict, kernel: str, bound: dict):
    """100 x the bound's least time over the mean device time of the
    launches of ``kernel`` (a substring of its name), or None when none
    ran in the window."""
    times = [dur for name, kind, _, dur in rec["trace"]["device_ops"]
             if kind == "kernel" and kernel in name]
    if not times:
        return None
    return 100.0 * bound["bound_s"] / (1e-6 * sum(times) / len(times))
