"""End-to-end training driver.

Counterpart of ``repro.launch.train``, with the same flags and defaults and
one more, ``--device`` (default: the CUDA card; the run raises without
one). Without ``--smoke`` it trains the full config: on one H100,

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --steps 4 --batch 4 --seq 4096

trains stablelm-3b at full width and depth (32 layers, 2.80 B parameters
in bf16), attention forward and backward on the hand-written kernels.
``--smoke`` trains the reduced same-family config, on the CPU too:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 3

``build`` makes the run's configs from the flags; ``chip_smoke.py`` calls
it too.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import base as configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None)
    return ap


def build(args: argparse.Namespace):
    """(ArchConfig, AdamWConfig, DataConfig, TrainConfig) of the parsed
    flags: the reduced config with ``--smoke``, ``--d-model`` (head dim
    d_model / n_heads, at least 16) and ``--layers`` overrides, warm-up
    20 steps and the cosine over ``--steps``."""
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.reduced(cfg)
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
        over["head_dim"] = max(args.d_model // max(cfg.n_heads, 1), 16)
    if args.layers:
        over["n_layers"] = args.layers
    if over:
        cfg = dataclasses.replace(cfg, **over)
    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    data = DataConfig(vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     compress_grads=args.compress)
    return cfg, opt, data, tc


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    cfg, opt, data, tc = build(args)
    trainer = Trainer(cfg, opt, data, tc, device=args.device)

    def on_step(step, loss, dt, slow):
        if step % 10 == 0:
            flag = " [STRAGGLER]" if slow else ""
            print(f"step {step:5d}  loss {loss:.4f}  {dt*1e3:7.1f} ms{flag}", flush=True)

    out = trainer.run(hooks={"on_step": on_step})
    print(f"done: loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"({len(out['straggler_flags'])} straggler flags)")
    return out


if __name__ == "__main__":
    main()
