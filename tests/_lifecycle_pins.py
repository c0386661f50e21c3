"""The JAX reference's lifecycle readings that chip_smoke.py pins.

Runs the reference package (``repro.sched.lifecycle``) on the CPU at the
configurations of chip_smoke.py's ``lifecycle`` and ``faults`` phases,
with the port's default OGASCHED start (``lifecycle.default_y0``: a
numpy draw of seed 0) passed to the reference. Prints chip_smoke.py's
LIFECYCLE_REFERENCE and FAULTS_REFERENCE (per algorithm the average
reward and the ``summarize`` metrics; per regime and algorithm the
robustness metrics and ``recovery_time``), and writes both phases'
admitted / departed records (packed bits, zlib, base64) to EVENTS_FILE. Run from the repo root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_lifecycle_pins.py

With ``--sensitivity`` it instead reruns the reference with every capacity
one float32 ulp larger (and, separately, every job size one ulp larger)
and prints, per run, the first slot where its admitted / departed record
leaves the unperturbed one and each metric's error |a - b| / max(|b|, 1):
how far the reference's own readings move once its trajectory drifts,
the yardstick of chip_smoke.py's drift bars (PERF.md section 2).
"""
import base64
import dataclasses
import json
import sys
import zlib

import jax.numpy as jnp
import numpy as np

from repro.sched import lifecycle as jl
from repro.sched import trace as jt
from repro_torch.sched import lifecycle as tl
from repro_torch.sched import trace as tt

# chip_smoke.py's lifecycle phase: benchmarks/bench_lifecycle.py:27
LIFECYCLE_CFG = dict(T=1000, L=10, R=128, K=6, seed=0, work_mean=1200.0)
LIFECYCLE_ALGORITHMS = tl.ALGORITHMS + ("multiclass",)
# chip_smoke.py's faults phase: benchmarks/bench_faults.py:55 (quick) and
# its REGIMES (bench_faults.py:35), T cut from 1500 to 500 (PERF.md section 4)
FAULTS_CFG = dict(T=500, L=10, R=64, K=6, seed=0, work_mean=600.0)
FAULTS_ALGORITHMS = tl.ALGORITHMS + ("hesrpt",)
FAULTS_METRICS = ("goodput", "wasted_work", "evictions", "fault_drops", "completed",
                  "recovery_time")
EVENTS_FILE = "tools/lifecycle_reference_events.json"
REGIMES = {
    "none": {},
    "failures": dict(fail_rate=0.02, fail_frac=0.3, repair_mean=40.0),
    "drains": dict(drain_period=200, drain_len=40, drain_frac=0.5),
    "shocks": dict(shock_rate=0.01, shock_depth=0.5),
}


def pack_events(mask: np.ndarray) -> str:
    """A (T, L) bool record as packed bits, zlib, base64 (chip_smoke.py's
    ``unpack_events`` reads it back)."""
    bits = np.packbits(np.asarray(mask, bool).reshape(-1))
    return base64.b64encode(zlib.compress(bits.tobytes(), 9)).decode()


def readings(kw: dict, algorithms, fault_kw=None, perturb=None) -> dict:
    jcfg = jt.TraceConfig(**kw)
    spec, arr, works = jt.make_lifecycle(jcfg)
    if perturb == "c":
        spec = dataclasses.replace(spec, c=jnp.nextafter(spec.c, jnp.inf))
    elif perturb == "works":
        works = jnp.nextafter(works, jnp.inf)
    y0 = tl.default_y0(tt.build_spec(tt.TraceConfig(**kw), device="cpu")).numpy()
    faults = None
    if fault_kw:
        faults = jt.build_faults(dataclasses.replace(jcfg, faults=jt.FaultConfig(**fault_kw)))
    f_np = np.ones((jcfg.T, jcfg.K), np.float32) if faults is None else np.asarray(faults)
    out = {}
    for name in algorithms:
        tr = jl.run(spec, arr, works, name, y0=jnp.asarray(y0), faults=faults)
        rewards = np.asarray(tr.rewards)
        out[name] = {**jl.summarize(tr, spec), "avg_reward": float(rewards.mean()),
                     "_admitted": np.asarray(tr.admitted), "_departed": np.asarray(tr.departed),
                     "recovery_time": jl.recovery_time(rewards, f_np),
                     "admitted": pack_events(tr.admitted),
                     "departed": pack_events(tr.departed)}
        print(name, out[name]["jct_mean"], file=sys.stderr, flush=True)
    return out


def _error(a: float, b: float) -> float:
    if np.isnan(a) or np.isnan(b):
        return 0.0 if np.isnan(a) and np.isnan(b) else float("inf")
    return abs(a - b) / max(abs(b), 1.0)


def sensitivity() -> None:
    runs = [("lifecycle", LIFECYCLE_CFG, LIFECYCLE_ALGORITHMS, None)]
    runs += [(r, FAULTS_CFG, FAULTS_ALGORITHMS, fkw or None) for r, fkw in REGIMES.items()]
    for label, kw, algorithms, fkw in runs:
        base = readings(kw, algorithms, fkw)
        for perturb in ("c", "works"):
            moved = readings(kw, algorithms, fkw, perturb)
            for n in algorithms:
                a, b = moved[n], base[n]
                bad = np.nonzero(((a["_admitted"] != b["_admitted"])
                                  | (a["_departed"] != b["_departed"])).any(-1))[0]
                errs = {k: _error(a[k], b[k]) for k in b if not k.startswith("_")
                        and k not in ("admitted", "departed")}
                print(json.dumps({"config": label, "algorithm": n, "perturb": perturb,
                                  "first_event_diff": int(bad[0]) if bad.size else None,
                                  "errors": errs}), flush=True)


def main() -> None:
    if "--sensitivity" in sys.argv:
        sensitivity()
        return
    life = readings(LIFECYCLE_CFG, LIFECYCLE_ALGORITHMS)
    faults = {regime: readings(FAULTS_CFG, FAULTS_ALGORITHMS, fkw)
              for regime, fkw in REGIMES.items()}
    with open(EVENTS_FILE, "w") as f:
        events = lambda d: {n: {k: v[k] for k in ("admitted", "departed")} for n, v in d.items()}
        json.dump({"lifecycle": {"config": LIFECYCLE_CFG, "records": events(life)},
                   "faults": {"config": FAULTS_CFG,
                              "records": {r: events(d) for r, d in faults.items()}}},
                  f, indent=1)
        f.write("\n")
    skip = ("admitted", "departed", "recovery_time", "_admitted", "_departed")
    print("LIFECYCLE_REFERENCE = {")
    for n, v in life.items():
        print(f"    {n!r}: {{{', '.join(f'{k!r}: {x!r}' for k, x in v.items() if k not in skip)}}},")
    print("}")
    print("FAULTS_REFERENCE = {")
    for regime, d in faults.items():
        print(f"    {regime!r}: {{")
        for n, v in d.items():
            print(f"        {n!r}: {{{', '.join(f'{k!r}: {v[k]!r}' for k in FAULTS_METRICS)}}},")
        print("    },")
    print("}")


if __name__ == "__main__":
    main()
