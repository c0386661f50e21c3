"""The JAX reference's Theorem-1 readings that chip_smoke.py pins.

Runs the reference's ``core.regret.regret_validation`` on the CPU at
benchmarks/bench_regret.py's quick configuration (T 2048, L 6, R 16, K 4,
contention 10; seven utilities x ("stationary", "flash") x seeds 0-3,
chunk 16, 1500 oracle iterations, 200 bootstrap resamples; host traces)
and prints chip_smoke.py's REGRET_REFERENCE: per (utility, regime) cell
r_T_mean, bound, exponent, bound_ok and sublinear. Run from the repo root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_regret_pins.py

With ``--port`` it also runs the port (``repro_torch.core.regret``) over
the same grid on the CPU and prints its largest error against those
readings, measured as chip_smoke.py measures the card's
(``chip_smoke.regret_errors``): the yardstick of chip_smoke.py's bars.
"""
import json
import os
import sys
import warnings

from repro.core import regret
from repro.sched import trace

# benchmarks/bench_regret.py:28-44, quick
BASE = dict(T=2048, L=6, R=16, K=4, contention=10.0)
REGIMES = ("stationary", "flash")
SEEDS = tuple(range(4))
CHUNK = 16
ORACLE_ITERS = 1500
N_BOOT = 200
KEYS = ("r_T_mean", "bound", "exponent", "bound_ok", "sublinear")


def main() -> None:
    points, labels = regret.make_regret_grid(trace.TraceConfig(**BASE), regimes=REGIMES,
                                             seeds=SEEDS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        records = regret.regret_validation(points, labels, chunk_size=CHUNK,
                                           oracle_iters=ORACLE_ITERS, n_boot=N_BOOT)
    pins = {f"{r['utility']}/{r['regime']}": {k: r[k] for k in KEYS} for r in records}
    print("REGRET_REFERENCE = " + json.dumps(pins, indent=1))
    if "--port" in sys.argv[1:]:
        print("port on the CPU, largest error: " + json.dumps(port_errors(pins)))


def port_errors(pins: dict) -> dict:
    """The port's largest error over the grid's cells against ``pins``."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from repro_torch.core import regret as tregret
    from repro_torch.sched import trace as ttrace

    points, labels = tregret.make_regret_grid(ttrace.TraceConfig(**BASE), regimes=REGIMES,
                                              seeds=SEEDS, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        records = tregret.regret_validation(points, labels, chunk_size=CHUNK,
                                            oracle_iters=ORACLE_ITERS, n_boot=N_BOOT,
                                            device="cpu")
    worst = {}
    for r in records:
        errs = chip_smoke.regret_errors(r, pins[f"{r['utility']}/{r['regime']}"])
        for k, v in errs.items():
            worst[k] = (worst.get(k, True) and v) if k == "flags_equal" else max(worst.get(k, 0.0), v)
    return worst


if __name__ == "__main__":
    main()
