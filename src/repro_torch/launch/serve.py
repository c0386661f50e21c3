"""Serving driver: batched greedy/temperature decoding with the engine.

Counterpart of ``repro.launch.serve``, with the same flags and one more,
``--device`` (default: the CUDA card; the run raises without one):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b --smoke \
      --requests 6 --max-new 12

As in the reference, ``--smoke`` is a store_true flag that defaults to
True, so the reduced config always runs.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import base as configs
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.reduced(cfg)
    params = M.init_params(cfg, 0, dev)
    eng = Engine(cfg, params, slots=args.slots, cache_len=args.cache_len,
                 temperature=args.temperature, device=dev)
    reqs = [Request(prompt=[1 + i, 2 + i, 3 + i], max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(f"served {args.requests} requests / {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {eng.steps_run} engine steps)")
    return {"requests": reqs, "steps": eng.steps_run, "seconds": dt}


if __name__ == "__main__":
    main()
