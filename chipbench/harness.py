"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics and the result line.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json``; ``workloads/<cell>.json`` (its configuration, traffic
parameters and limits); ``configs/<config>.json`` (the cluster and the
mode); ``drivers/<mode>.py`` (the entry the window drives);
``metrics/<metric>.py`` (one reader a metric, ``read(records)``, None when
it finds nothing to read).
"""
from __future__ import annotations

import importlib.util
import json
import math
import time
from pathlib import Path

import torch

from chipbench import program, tracing

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
ENTRY_SPAN = "chipbench.entry"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file of the benchmark, named after its path."""
    name = "chipbench_" + "_".join(path.relative_to(HERE).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name.replace("-", "_").replace(".", "_"),
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no benchmark file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's entry in BENCHMARK.json joined with its files: entry,
    cell file, configuration and the metrics it reports by trace mode."""
    bench = load_json(BENCHMARK) if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}")
    entry = entries[0]
    spec = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key}={spec[key]!r}, "
                             f"{BENCHMARK.name} {entry[key]!r}")
    reports = lambda m: "workloads" not in m or name in m["workloads"]
    return {
        "entry": entry, "cell": spec,
        "config": load_json(HERE / "configs" / f"{entry['config']}.json"),
        "metrics": {0: [m for m in bench["end_to_end"] if reports(m)],
                    1: [m for m in bench["per_layer"] if reports(m)]},
    }


def judge(numbers: dict, rows: list, limits: dict) -> tuple[bool, int]:
    """(correct, failed): a checked row fails where one of its numbers is
    not finite or passes its limit; the run is correct where no row fails
    and every number, the largest over the rows, keeps its limit."""
    ok = lambda v, k: math.isfinite(v) and v <= limits[k]
    failed = sum(1 for r in rows if not all(ok(r[k], k) for k in limits))
    return failed == 0 and all(ok(numbers[k], k) for k in limits), failed


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, overrides: dict | None = None,
             control: bool = False, info: dict | None = None) -> dict:
    """Run cell ``name`` once and return its result (the last line's
    object). ``overrides`` replaces configuration and traffic keys (the
    CPU tests' tiny sizes); ``device`` "cpu" runs the program's plain
    versions and reports no device metric. ``control`` also runs the
    control (the reference in bfloat16 in the program's place) on the same
    checked slots and judges it as the program is judged, into
    ``info["control"]``, for ``calibrate.py`` and the tests; the
    benchmark's runs never do. ``info`` is merged into the run's
    information (printed, not judged)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    c = cell(name)
    cfg = {**c["config"], **(overrides or {}).get("config", {})}
    traffic = {**c["cell"]["traffic_params"], **(overrides or {}).get("traffic", {})}
    limits = c["cell"]["limits"]
    drv = load_module(HERE / "drivers" / f"{cfg['mode']}.py").Driver(cfg, traffic, seed, dev)
    setup_info = drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        program.reset_autotune_stats()
    setup_s = time.perf_counter() - t_start

    prof = tracing.profile() if trace and dev.type == "cuda" else None
    if prof is not None:
        prof.__enter__()
    slots = units = 0
    with torch.profiler.record_function(tracing.WINDOW_SPAN):
        w0 = time.perf_counter()
        while True:
            with torch.profiler.record_function(ENTRY_SPAN):
                slots += drv.unit()
            units += 1
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
    if prof is not None:
        prof.__exit__(None, None, None)

    info = {**(info or {}), "setup_s": setup_s, "window_s": window_s, "slots": slots,
            "units": units, **setup_info}
    if dev.type == "cuda":
        info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        info["autotune_in_window"] = program.autotune_stats()
    # what the check keeps of the program's outputs is in the peak above
    info["check_retained_bytes"] = drv.retained_bytes()
    records = {"setup_s": setup_s, "window_s": window_s, "slots": slots,
               "slot_latency_ms": drv.slot_latency_ms(), "entry_s": drv.entry_s,
               "config": cfg}
    drv.free_program_state()

    t0 = time.perf_counter()
    numbers, rows, diag = drv.check()
    info["check_s"] = time.perf_counter() - t0
    info.update(diag)
    if control:
        c_numbers, c_rows, _ = drv.check(control=True)
        c_correct, c_failed = judge(c_numbers, c_rows, limits)
        info["control"] = {"correct": c_correct, "failed": c_failed, "numbers": c_numbers}
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(limits)}
    correct, failed = judge(numbers, rows, limits)

    result = {"correct": correct, "attempted": slots, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu",
                         "count": 1, "memory_peak_bytes": info.get("memory_peak_bytes", 0)}}
    if dev.type == "cuda":
        mode = 0
        if prof is not None:
            mode = 1
            t0 = time.perf_counter()
            records["trace"] = tracing.read(prof)
            info["trace_read_s"] = time.perf_counter() - t0
            result["device"]["busy_s"] = records["trace"]["busy_s"]
            result["device"]["window_s"] = records["trace"]["window_s"]
            result["breakdown"] = tracing.breakdown(records["trace"])
        for m in c["metrics"][mode]:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(records)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["checks"] = checks
    return {"result": result, "info": info, "rows": rows}
