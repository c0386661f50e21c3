"""Multi-pod dry run on ``meta`` tensors: size every (arch x shape) cell on
the production mesh with nothing allocated anywhere, and record its
memory, cost and collectives for the roofline.

Counterpart of ``repro.launch.dryrun``, with its CLI and record keys:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sched   # scheduler cell

It needs no card: the mesh's positions are named ``meta`` and the model
runs on meta tensors. A record's ``memory`` (per position):

- ``argument_size_in_bytes``: exact bytes of the step's inputs on one
  position: the parameters, the AdamW state in bf16 (training) and the
  batch or the decode cache, each sharded by ``train/sharding.py``'s
  policy (``NamedSharding.shard_shape``);
- ``output_size_in_bytes``: the step's outputs on the same terms (the
  prefill's logits and cache, a decode step's logits and cache, a train
  step's parameters, optimizer state and loss);
- ``temp_size_in_bytes``: the high-water mark of the bytes a meta run of
  the step allocates (outputs included while they are live), each storage
  counted once however many views it has and freed with its last tensor
  (``LiveBytes``). The run takes one data shard's batch at full width on
  the whole parameters: the model axis does not divide its activations,
  and a train step's gradients and new parameters and optimizer state are
  counted whole, so on a mesh of more than one position this overstates a
  position's temporaries (by up to the parameters' sharding factor in
  those terms). On one position it is the step's own.

``cost`` holds the meta run's "flops" (``FlopCounterMode``'s formulas,
with flash attention counted by ``roofline.flash_flops`` through the
kernels' meta op) and "bytes accessed" (the bytes every operation of the run reads
and writes), each split evenly over the positions that share the data
shard. ``collectives`` is ``roofline.collective_bytes``'s model.

The reference also corrects XLA's count of a ``while`` body, which its
cost analysis counts once (``_layer_cost``, ``_corrected``): a torch run
executes every layer, so the twin has no such correction, nor the keys of
XLA's artifacts (``lower_s``, ``compile_s``, ``cost_raw``,
``collectives_raw``, ``layer_cost``); ``meta_s`` is the meta run's time.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs import base as configs
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import sharding as shd
from repro_torch.train import train_step as ts
from repro_torch.train.meshctx import Mesh, axis_size

# the reference's dry run holds the AdamW moments in bf16
OPT = AdamWConfig(state_dtype="bfloat16")
# the §3.2 scheduler cell (the reference's run_sched_cell: trace.build_spec
# at these sizes, density 0.25; the mask is held dense, so its bytes do
# not depend on the density)
SCHED_CELL = dict(L=100, R=131072, K=6)


# operations that allocate and move no data
_NO_TRAFFIC = (torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided)


def _tensors(x, acc: list) -> list:
    """The tensors of an operation's arguments or outputs (tensors, and
    tuples and lists of them, nested), appended to ``acc``."""
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, acc)
    return acc


class LiveBytes(TorchDispatchMode):
    """Live bytes of the storages that operations create inside the
    ``with`` block, and their high-water mark ``peak``.

    A storage counts once, from the operation whose output first holds it,
    however many views share it; an output that shares an input's storage
    (a view, an in-place or out= operation) adds nothing. A storage is
    freed when its last tensor dies: torch keeps one Python object per
    live storage, and a weak reference to it calls back then. Storages
    made before the block (the arguments) are never counted.
    ``bytes_accessed`` adds, for every operation that is not a view or an
    allocation (``_NO_TRAFFIC``), the bytes of the tensors it reads and
    writes; ``flops`` the FLOPs of every operation ``FlopCounterMode``
    has a formula for, by that formula (one pass counts both: a second
    mode would double the meta run's time)."""

    def __init__(self):
        super().__init__()
        self._live: dict = {}   # id of the storage object -> (weak reference, bytes)
        self.current = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.flops = 0
        self._formulas = FlopCounterMode(display=False).flop_registry

    def _freed(self, key: int, _ref) -> None:
        self.current -= self._live.pop(key)[1]

    def _track(self, storage) -> None:
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = (weakref.ref(storage, functools.partial(self._freed, key)), n)
        self.current += n
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args, [])
        if kwargs:
            _tensors(tuple(kwargs.values()), ins)
        outs = _tensors(out, [])
        formula = self._formulas.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and func.overloadpacket not in _NO_TRAFFIC:
            self.bytes_accessed += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            storage = t.untyped_storage()
            if id(storage) not in held:
                self._track(storage)
        return out


def _nbytes(t, mesh: Mesh, spec) -> int:
    """Bytes of one position's shard of ``t`` under ``spec``."""
    return math.prod(shd.NamedSharding(mesh, spec).shard_shape(tuple(t.shape))) \
        * t.dtype.itemsize


def _sharded_bytes(tree, pspecs, mesh: Mesh) -> int:
    """Per-position bytes of a tree under a like tree of PartitionSpecs
    (tuples, so ``tree_leaves`` keeps each whole)."""
    return sum(_nbytes(t, mesh, p) for t, p in zip(tree_leaves(tree), tree_leaves(pspecs)))


def _batch_shards(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> int:
    """How many ways the batch's dim 0 is split (the data shards)."""
    specs = ts.input_specs(cfg, shape)
    if shape.kind == "decode":
        spec = shd.batch_pspecs({"t": specs["tokens"]}, mesh)["t"]
    else:
        spec = shd.batch_pspecs(specs["batch"], mesh, pure_dp=cfg.pure_dp)["tokens"]
    return axis_size(mesh, spec[0])


def argument_parts(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> dict:
    """Exact per-position bytes of the step's inputs, by part: "params",
    "opt_state" (training: m and v in bf16 under the parameters' specs,
    the int32 step replicated), "inputs" (the batch, or the decode cache,
    its tokens and the replicated int32 position)."""
    pshapes = M.param_shapes(cfg)
    pspecs = shd.param_pspecs(pshapes, mesh)
    specs = ts.input_specs(cfg, shape)
    parts = {"params": _sharded_bytes(pshapes, pspecs, mesh)}
    if shape.kind == "train":
        o = ts.opt_specs(cfg, OPT)
        parts["opt_state"] = (_sharded_bytes(o["m"], pspecs, mesh)
                              + _sharded_bytes(o["v"], pspecs, mesh) + o["step"].nbytes)
    if shape.kind in ("train", "prefill"):
        b_specs = shd.batch_pspecs(specs["batch"], mesh, pure_dp=cfg.pure_dp)
        parts["inputs"] = _sharded_bytes(specs["batch"], b_specs, mesh)
    else:
        c_specs = shd.cache_pspecs(specs["cache"], mesh)
        t_spec = shd.batch_pspecs({"t": specs["tokens"]}, mesh)["t"]
        parts["inputs"] = (_sharded_bytes(specs["cache"], c_specs, mesh)
                           + _nbytes(specs["tokens"], mesh, t_spec) + specs["pos"].nbytes)
    return parts


def output_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, parts: dict) -> int:
    """Per-position bytes of the step's outputs: a train step's parameters,
    optimizer state and float32 loss (``parts``: ``argument_parts``'s); a
    prefill's or decode step's float32 last-token logits (B, vocab), split
    like the batch, and its cache under ``cache_pspecs``."""
    if shape.kind == "train":
        return parts["params"] + parts["opt_state"] + 4
    B = shape.global_batch
    clen = shape.seq_len if shape.kind == "prefill" else ts.cache_len_for(cfg, shape)
    cache = tf.init_cache(cfg, B, clen, M.compute_dtype(cfg), "meta")
    logits = torch.empty((B, cfg.vocab), dtype=torch.float32, device="meta")
    return (_sharded_bytes(cache, shd.cache_pspecs(cache, mesh), mesh)
            + _nbytes(logits, mesh, shd.auto_pspec(tuple(logits.shape), mesh, batch_dim=0)))


def meta_run(cfg: ArchConfig, shape: ShapeConfig, batch: Optional[int] = None) -> dict:
    """One step of the cell on meta tensors at full width over ``batch``
    sequences (None: the whole global batch): its temporaries'
    high-water mark, FLOPs, bytes read and written, and seconds. The
    arguments are made before the count starts."""
    B = shape.global_batch if batch is None else batch
    sub = dataclasses.replace(shape, global_batch=B)
    params = M.param_shapes(cfg)
    specs = ts.input_specs(cfg, sub)
    if shape.kind == "train":
        opt = ts.opt_specs(cfg, OPT)
        step, args = ts.make_train_step(cfg, OPT), (params, opt, specs["batch"])
    elif shape.kind == "prefill":
        step, args = ts.make_prefill_step(cfg), (params, specs["batch"])
    else:
        step = ts.make_serve_step(cfg)
        args = (params, specs["cache"], specs["tokens"], specs["pos"])
    t0 = time.perf_counter()
    with LiveBytes() as live:
        out = step(*args)
        del out
    return {"temp_size_in_bytes": live.peak, "flops": float(live.flops),
            "bytes_accessed": float(live.bytes_accessed), "seconds": time.perf_counter() - t0}


def _mesh_of(multi_pod: bool, mesh: Optional[Mesh]) -> Mesh:
    if mesh is not None:
        return mesh
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def _parse_overrides(spec: str) -> dict:
    """'pure_dp=1,logits_chunk=512,remat_policy=dots' -> typed dict."""
    out = {}
    if not spec:
        return out
    for kv in spec.split(","):
        k, v = kv.split("=")
        if v in ("0", "1", "true", "false", "True", "False"):
            out[k] = v in ("1", "true", "True")
        elif v.isdigit():
            out[k] = int(v)
        else:
            out[k] = v
    return out


def run_cell(arch: Union[str, ArchConfig], shape_name: Union[str, ShapeConfig],
             multi_pod: bool = False, overrides: Optional[dict] = None,
             mesh: Optional[Mesh] = None) -> dict:
    """The record of one cell: the arch by name or config, the shape by
    name or ``ShapeConfig``, on the production mesh (or ``mesh``)."""
    mesh = _mesh_of(multi_pod, mesh)
    n_dev = mesh.devices.size
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, reason = applicable(cfg, shape)
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "n_devices": int(n_dev),
        "kind": shape.kind,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    parts = argument_parts(cfg, shape, mesh)
    n_batch = _batch_shards(cfg, shape, mesh)
    run = meta_run(cfg, shape, shape.global_batch // n_batch)
    share = n_dev // n_batch  # positions holding one data shard
    print(f"[{cfg.name} x {shape.name}] meta run: {run['seconds']:.2f} s, "
          f"flops={run['flops']:.3e} temp={run['temp_size_in_bytes'] / 1e9:.2f} GB")
    rec.update(
        status="ok",
        meta_s=round(run["seconds"], 2),
        memory={"argument_size_in_bytes": sum(parts.values()),
                "output_size_in_bytes": output_bytes(cfg, shape, mesh, parts),
                "temp_size_in_bytes": run["temp_size_in_bytes"]},
        argument_parts=parts,
        cost={"flops": run["flops"] / share, "bytes accessed": run["bytes_accessed"] / share},
        collectives=rl.collective_bytes(cfg, shape, mesh),
        model_flops=rl.model_flops(cfg, shape),
        n_params=cfg.n_params,
        n_active_params=cfg.n_active_params,
    )
    rec["roofline"] = rl.roofline(rec, n_dev)
    return rec


def sched_parts(n_positions: int) -> dict:
    """Exact per-position bytes of §3.2's step (``core.distributed``) at
    SCHED_CELL on ``n_positions`` shards of the instances: "spec" (the
    block's mask (L, R/n), c and alpha (R/n, K), and a (L, K), beta and
    kinds (K,) whole), "y" (L, R/n, K), "x" (L,) and "eta", all float32
    but the int32 kinds."""
    L, R, K = SCHED_CELL["L"], SCHED_CELL["R"], SCHED_CELL["K"]
    if R % n_positions:
        raise ValueError(f"R = {R} instances do not divide over {n_positions} positions")
    r = R // n_positions
    return {"spec": 4 * (L * r + L * K + 2 * r * K + K) + 4 * K,
            "y": 4 * L * r * K, "x": 4 * L, "eta": 4}


def run_sched_cell(multi_pod: bool = False, mesh: Optional[Mesh] = None) -> dict:
    """§3.2's distributed scheduler step at cluster scale: the instances
    sharded over every position of the mesh, one sum of the L ports'
    totals (gain (L,) and quota (L, K)) a step. Cost from
    ``kernel_cost_model("oga_step", R K / n, L)``; temporaries the fused
    step's packed operand and output rows."""
    mesh = _mesh_of(multi_pod, mesh)
    n_dev = int(mesh.devices.size)
    L, R, K = SCHED_CELL["L"], SCHED_CELL["R"], SCHED_CELL["K"]
    parts = sched_parts(n_dev)
    cost = rl.kernel_cost_model("oga_step", R * K // n_dev, L)
    rec = {
        "arch": "ogasched-distributed",
        "shape": f"L{L}_R{R}_K{K}",
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "n_devices": n_dev,
        "kind": "sched",
        "status": "ok",
        "memory": {"argument_size_in_bytes": sum(parts.values()),
                   "output_size_in_bytes": parts["y"] + 4,
                   "temp_size_in_bytes": int(cost["bytes"])},
        "argument_parts": parts,
        "cost": {"flops": cost["flops"], "bytes accessed": cost["bytes"]},
        "collectives": {"all-reduce": {"bytes": 4 * L * (K + 1), "count": 1}},
    }
    rec["roofline"] = rl.roofline(rec, n_dev)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sched", action="store_true")
    ap.add_argument("--out", type=str, default="artifacts/dryrun")
    ap.add_argument("--override", type=str, default="",
                    help="cfg overrides, e.g. pure_dp=1,logits_chunk=512")
    ap.add_argument("--suffix", type=str, default="",
                    help="record tag suffix for hillclimb variants")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    overrides = _parse_overrides(args.override)

    def emit(rec):
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        if args.suffix:
            tag += f"__{args.suffix}"
            rec["variant"] = args.suffix
            rec["overrides"] = overrides
        path = os.path.join(args.out, tag + ".json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(
            f"=== {tag}: {rec['status']}"
            + (
                f" meta={rec.get('meta_s')}s dominant="
                f"{rec.get('roofline', {}).get('dominant')}"
                if rec["status"] == "ok"
                else f" ({rec.get('reason', '')[:60]})"
            )
        )

    if args.sched:
        emit(run_sched_cell(args.multi_pod))
        return
    if args.all:
        for arch in configs.names():
            for shape_name in SHAPES:
                try:
                    emit(run_cell(arch, shape_name, args.multi_pod, overrides))
                except Exception:
                    traceback.print_exc()
                    emit(
                        {
                            "arch": arch,
                            "shape": shape_name,
                            "mesh": "2x16x16" if args.multi_pod else "16x16",
                            "status": "error",
                            "reason": traceback.format_exc()[-800:],
                        }
                    )
        return
    emit(run_cell(args.arch, args.shape, args.multi_pod, overrides))


if __name__ == "__main__":
    main()
