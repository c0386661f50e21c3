"""Roofline terms on the NVIDIA H100 SXM, from dry-run records and from the
kernels' own work.

Counterpart of ``repro.analysis.roofline``, whose peaks are a TPU's:

    compute term    = FLOPs / (positions * PEAK_FLOPS)     (bf16 tensor cores)
    memory term     = HBM bytes / HBM_BW                   (per position)
    collective term = collective bytes / NVLINK_BW         (per position)

A record's ``cost`` and ``memory`` are per position (``launch.dryrun``);
its ``collectives`` are the bytes ``collective_bytes`` models for one
position. The reference parses XLA's HLO text for those; torch never
writes such a text, so the twin counts what ``train/sharding.py``'s
policy implies instead.

The kernel half gives the least time the card could take for one call of
a hand-written kernel: the bytes it must move over HBM_BW, or its
operations over the rate of their type, the larger (``kernel_bound``,
``flash_bound``, ``flash_bwd_bound``). ``chip_smoke.py`` prints these
bounds beside every kernel's measured time.
"""
from __future__ import annotations

import math
from typing import Optional

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: HBM3 bandwidth
HBM_BW = 3.35e12            # B/s
# the same sheet: FP64 and FP32 outside the tensor cores (the sortscan
# water level is solved in double, the bisection in float32)
FP64_FLOPS = 34e12          # FLOP/s
FP32_FLOPS = 67e12          # FLOP/s
# the same sheet: BF16 tensor core, dense (its 1979 is with sparsity)
PEAK_FLOPS = 989e12         # FLOP/s
# fourth-generation NVLink, 900 GB/s a card both ways: 450e9 a direction,
# in the place of the reference's ICI link rate
NVLINK_BW = 450e9           # B/s

# the products of attention's gradient (QK^T, dO V^T, P^T dO, dS^T Q,
# dS K), 2 hd FLOPs a head a visible (query, key) pair each
BWD_PRODUCTS = 5


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode D = batch
    tokens per step."""
    n = cfg.n_active_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens


def hbm_traffic(memory: dict) -> float:
    """Per-position HBM traffic of a step: arguments and outputs move once,
    temporaries are written and read back once."""
    return (
        memory.get("argument_size_in_bytes", 0)
        + memory.get("output_size_in_bytes", 0)
        + 2.0 * memory.get("temp_size_in_bytes", 0)
    )


def dryrun_summary(record: dict) -> dict:
    """Derived fields of one dry-run record for table emission, the one
    home of this derivation (``analysis.report`` reads it)."""
    tag = f"{record['arch']} / {record['shape']}"
    if record.get("variant"):
        tag += f" [{record['variant']}]"
    out = {"tag": tag, "status": record["status"]}
    if record["status"] != "ok":
        out["reason"] = record.get("reason", "")
        return out
    rl = record["roofline"]
    mf = record.get("model_flops", 0.0)
    out.update(
        dominant=rl["dominant"],
        t_compute_s=rl["t_compute_s"],
        t_memory_s=rl["t_memory_s"],
        t_collective_s=rl["t_collective_s"],
        t_dominant_s=max(
            rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"]
        ),
        useful_flops=mf / max(rl["hlo_flops_global"], 1),
        temp_gb=record["memory"].get("temp_size_in_bytes", 0) / 1e9,
        model_flops=mf,
        kind=record.get("kind", "train"),
    )
    return out


def roofline(record: dict, n_devices: int) -> dict:
    """record: one dry-run record (per-position flops and bytes, and
    collectives). Keys as the reference's; ``hlo_flops_global`` is the
    FLOPs of all positions together."""
    flops_g = record["cost"].get("flops", 0.0) * n_devices
    traffic = hbm_traffic(record.get("memory", {}))  # per position
    coll_per_dev = sum(v["bytes"] for v in record["collectives"].values())
    t_compute = flops_g / (n_devices * PEAK_FLOPS)
    t_memory = traffic / HBM_BW
    t_coll = coll_per_dev / NVLINK_BW
    dom = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dom,
        "hlo_flops_global": flops_g,
        "hbm_traffic_per_device": traffic,
        "collective_bytes_per_device": coll_per_dev,
    }


# ------------------------------------------------------------ collectives --
# 2-D leaves that multiply the activations as ``x @ W`` (W (in, out)); the
# embedding's lookup contracts over the vocabulary like a one-hot product
_MATMULS = ("wq", "wk", "wv", "wo", "gate", "up", "down", "in_proj", "out_proj",
            "router", "unembed", "patch_proj", "embed")
_EXPERT_LEAVES = ("gate", "up", "down")


def _axes_of(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def collective_bytes(cfg, shape, mesh) -> dict:
    """Per-position operand bytes and counts, by collective kind, of one
    step of the cell (``cfg``, ``shape``) on ``mesh`` under
    ``train/sharding.py``'s policy, in the reference's shape {kind:
    {"bytes", "count"}}.

    This is a model of what a compiler would insert for that placement,
    not a reading of a compiled artifact. Operand bytes are counted as the
    reference counts them: an all-gather's is the local shard, a
    reduce-scatter's the whole local gradient before the scatter. The
    batch axes are those ``batch_pspecs`` gives the tokens. It counts:

    - all-gather: each parameter sharded over a batch axis (FSDP), once a
      forward pass (a block's again in the recompute under remat "full")
      and once more in the backward pass;
    - reduce-scatter: in training, the gradient of each such parameter
      over those axes;
    - all-reduce: in training, the gradient over the batch axes that do
      not shard its parameter; and over 'model' (when it carries no batch)
      the activations a sharded product needs: the output of a product
      whose contraction dim is on 'model', each forward pass, and the
      input gradient of one whose output dim is, in the backward pass; an
      expert-parallel MoE layer's combined output and its gradient.
    """
    from repro_torch.models import model as M
    from repro_torch.train import train_step as ts
    from repro_torch.train.sharding import NamedSharding, batch_pspecs, param_pspecs

    pshapes = M.param_shapes(cfg)
    pspecs = param_pspecs(pshapes, mesh)
    specs = ts.input_specs(cfg, shape)
    if shape.kind == "decode":
        tok_spec = batch_pspecs({"t": specs["tokens"]}, mesh)["t"]
        seq = 1
    else:
        tok_spec = batch_pspecs(specs["batch"], mesh, pure_dp=cfg.pure_dp)["tokens"]
        seq = shape.seq_len
    batch_axes = _axes_of(tok_spec[0])
    n_batch = math.prod(mesh.shape[a] for a in batch_axes)
    tokens = shape.global_batch // n_batch * seq
    patches = shape.global_batch // n_batch * cfg.n_patches
    act = M.compute_dtype(cfg).itemsize
    train = shape.kind == "train"
    block_fwd = 2 if train and cfg.remat and cfg.remat_policy == "full" else 1
    tp = "model" in mesh.shape and mesh.shape["model"] > 1 and "model" not in batch_axes
    out: dict = {}

    def add(kind, nbytes, count=1):
        ent = out.setdefault(kind, {"bytes": 0, "count": 0})
        ent["bytes"] += int(nbytes)
        ent["count"] += int(count)

    def leaf(keys, t, spec):
        in_block = "blocks" in keys
        local_shape = NamedSharding(mesh, spec).shard_shape(tuple(t.shape))
        local = math.prod(local_shape) * t.dtype.itemsize
        used = {a for e in spec for a in _axes_of(e)}
        g_fsdp = math.prod(mesh.shape[a] for a in batch_axes if a in used)
        g_rest = math.prod(mesh.shape[a] for a in batch_axes if a not in used)
        fwd = block_fwd if in_block else 1
        if g_fsdp > 1:
            add("all-gather", local * (fwd + train), fwd + train)
            if train:
                add("reduce-scatter", local * g_fsdp)
        if train and g_rest > 1:
            add("all-reduce", local)
        name = keys[-1]
        if not tp or name not in _MATMULS:
            return
        n_tok = patches if name == "patch_proj" else tokens
        if "moe" in keys and "shared" not in keys and name in _EXPERT_LEAVES:
            # experts on 'model': the combine sums the shards' outputs
            if name == "down" and _axes_of(spec[0]) == ("model",):
                add("all-reduce", n_tok * t.shape[-1] * act * fwd, fwd)
                if train:
                    add("all-reduce", n_tok * t.shape[-1] * act)
            return
        width = 4 if name == "router" else act  # routing runs in float32
        if "model" in _axes_of(spec[0]):
            add("all-reduce", n_tok * t.shape[1] * width * fwd, fwd)
        if "model" in _axes_of(spec[1]) and train and name != "embed":
            add("all-reduce", n_tok * t.shape[0] * width)

    def walk(tree, specs_, keys):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], specs_[k], keys + (k,))
        elif isinstance(tree, list):
            for sub, sp in zip(tree, specs_):
                walk(sub, sp, keys)
        else:
            leaf(keys, tree, specs_)

    walk(pshapes, pspecs, ())
    return out


# --------------------------------------------------------------------------
# Measured-kernel roofline: achieved bytes/s and flops/s of the timed
# kernels against a peak model. On the card the peaks are the data-sheet
# constants above; on the host they are calibrated once per process (a
# large copy for bandwidth, a large float32 matmul for flops), so "fraction
# of peak" means fraction of what that machine demonstrably sustains.
# --------------------------------------------------------------------------

_kernel_peaks_cache: Optional[dict] = None


def _calibrate_host_peaks() -> dict:
    """Measured single-process peaks on the CPU: copy bandwidth (read +
    write bytes over wall time, best of 3) and float32 matmul flops/s
    (best of 3)."""
    import time as _time

    import torch

    n = 1 << 24  # 64 MiB float32 source
    src = torch.ones(n, dtype=torch.float32)
    dst = torch.empty_like(src)
    bw = 0.0
    for _ in range(3):
        t0 = _time.perf_counter()
        dst.copy_(src)
        dt = _time.perf_counter() - t0
        bw = max(bw, 2.0 * 4.0 * n / dt)
    m = 1024
    a = torch.ones((m, m), dtype=torch.float32)
    fl = 0.0
    for _ in range(3):
        t0 = _time.perf_counter()
        a @ a
        dt = _time.perf_counter() - t0
        fl = max(fl, 2.0 * m**3 / dt)
    return {"peak_bytes_s": bw, "peak_flops_s": fl, "calibrated": True}


def kernel_peaks(platform: Optional[str] = None) -> dict:
    """Peak model for the measured-kernel roofline.

    None (or "cuda"): the card's data-sheet constants, HBM_BW and the
    float32 rate, with no device present. "cpu": host-calibrated peaks,
    measured once a process (see the module comment)."""
    global _kernel_peaks_cache
    if platform in (None, "cuda", "gpu"):
        return {"peak_bytes_s": HBM_BW, "peak_flops_s": FP32_FLOPS, "calibrated": False}
    if _kernel_peaks_cache is None:
        _kernel_peaks_cache = _calibrate_host_peaks()
    return _kernel_peaks_cache


def kernel_rate(method: str = "sortscan") -> float:
    """The card's rate for a projection method's operations: the sortscan
    kernels solve in double, the bisect kernels in float32."""
    if method == "sortscan":
        return FP64_FLOPS
    if method == "bisect":
        return FP32_FLOPS
    raise ValueError(f"unknown method {method!r}")


def _sortscan_ops(n: int, l: int) -> int:
    """Float operations of the sortscan projection on n rows: the bitonic
    network, two scans and six block reductions over P slots, plus the
    O(l) clip and recompute passes."""
    p = max(32, 1 << max(0, (2 * l - 1)).bit_length())
    lg = p.bit_length() - 1
    return n * (p // 2 * lg * (lg + 1) // 2 + 2 * p * lg + 6 * p + 12 * l)


def _bisect_ops(n: int, l: int, n_need: int, iters: int) -> int:
    """Float32 operations of the bisection on n rows: the box clip of every
    lane, and (iters + 4) clipped row sums on the n_need rows the capacity
    binds (the others leave after the first sum)."""
    return 4 * n * l + n_need * (iters + 4) * 5 * l


def kernel_cost_model(kernel: str, n: int, l: int, method: str = "sortscan",
                      iters: int = 20, n_need: Optional[int] = None) -> dict:
    """Useful work {bytes, flops} of one call of a port's CUDA kernel on
    (n rows, l lanes), unpadded.

    Bytes count each float32 operand read once and the output written
    once: "oga_step" reads y, a, mask, x, kstar and five per-row scalars
    and writes y(t+1); "proj" reads z, a, mask and c and writes y. Flops
    follow the method: "sortscan" (counted at the float64 rate,
    ``kernel_rate``) or "bisect" with ``iters`` halvings, whose row sums
    run on the ``n_need`` rows the capacity binds (None: every row; the
    count depends on the data). The fused step adds 16 operations a lane
    for the gradient and the ascent.
    """
    if method == "sortscan":
        proj_flops = _sortscan_ops(n, l)
    elif method == "bisect":
        proj_flops = _bisect_ops(n, l, n if n_need is None else n_need, iters)
    else:
        raise ValueError(f"unknown method {method!r}")
    if kernel == "oga_step":
        nbytes = 4 * n * (6 * l + 5)
        flops = proj_flops + 16 * n * l
    elif kernel == "proj":
        nbytes = 4 * n * (4 * l + 1)
        flops = proj_flops
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return {"bytes": float(nbytes), "flops": float(flops)}


def kernel_bound(kernel: str, n: int, l: int, method: str = "sortscan", iters: int = 20,
                 n_need: Optional[int] = None) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for ``kernel_cost_model``'s work, its bytes at HBM_BW or its
    operations at ``kernel_rate(method)``, the larger."""
    cost = kernel_cost_model(kernel, n, l, method=method, iters=iters, n_need=n_need)
    t_bytes = cost["bytes"] / HBM_BW * 1e3
    t_ops = cost["flops"] / kernel_rate(method) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_roofline(
    kernel: str,
    n: int,
    l: int,
    us: float,
    *,
    method: str = "sortscan",
    iters: int = 20,
    platform: Optional[str] = None,
    peaks: Optional[dict] = None,
) -> dict:
    """Measured achieved-vs-peak record for one timed kernel call.

    ``us`` is the measured time per call. Returns achieved bytes/s and
    flops/s from ``kernel_cost_model``, their fractions of the peak model
    (on the card the flops peak is ``kernel_rate(method)``), and which
    roof binds (the larger fraction).
    """
    cost = kernel_cost_model(kernel, n, l, method=method, iters=iters)
    pk = peaks or kernel_peaks(platform)
    peak_flops = pk["peak_flops_s"] if pk.get("calibrated") else kernel_rate(method)
    t = max(us, 1e-9) * 1e-6
    achieved_b = cost["bytes"] / t
    achieved_f = cost["flops"] / t
    frac_b = achieved_b / pk["peak_bytes_s"]
    frac_f = achieved_f / peak_flops
    return {
        "kernel": kernel,
        "shape": f"N{n}xL{l}",
        "method": method,
        "us": float(us),
        "model_bytes": cost["bytes"],
        "model_flops": cost["flops"],
        "achieved_bytes_s": achieved_b,
        "achieved_flops_s": achieved_f,
        "peak_bytes_s": pk["peak_bytes_s"],
        "peak_flops_s": peak_flops,
        "frac_peak_bytes": frac_b,
        "frac_peak_flops": frac_f,
        "dominant": "memory" if frac_b >= frac_f else "compute",
        "peaks_calibrated": bool(pk.get("calibrated", False)),
    }


# -------------------------------------------------------- flash attention --
def flash_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal row set of S rows attends to: with a
    window, row q sees min(q + 1, window) keys (the first ``window`` rows
    1, 2, ..., the rest ``window`` each)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_flops(B: int, S: int, H: int, hd: int, window: int, products: int = 2) -> int:
    """FLOPs of ``products`` attention products of 2 hd FLOPs a head a
    visible pair: the forward's two (QK^T and PV) by default,
    BWD_PRODUCTS for the gradient."""
    return products * 2 * hd * H * B * flash_pairs(S, window)


def flash_bound(B, S, H, G, hd, window, elem_bytes, ops_per_s=PEAK_FLOPS):
    """The least time the H100 could take for the attention itself: its
    ``flash_flops`` at ``ops_per_s`` (the bf16 tensor-core rate, or the
    float32 rate for float32 inputs), or one read of q, k, v and one
    write of o at the HBM rate; the larger. (ms, "operations" or
    "bytes")."""
    t_ops = flash_flops(B, S, H, hd, window) / ops_per_s * 1e3
    t_bytes = elem_bytes * B * S * hd * (2 * H + 2 * G) / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bwd_bound(B, S, H, G, hd, window, elem_bytes, ops_per_s, products=BWD_PRODUCTS):
    """The least time the H100 could take for attention's gradient: the
    BWD_PRODUCTS products at ``ops_per_s``, or one read of q, k, v, o, dO
    and one write of dq, dk, dv at the HBM rate; the larger. Another
    ``products`` gives the time of that many products at that rate."""
    t_ops = flash_flops(B, S, H, hd, window, products) / ops_per_s * 1e3
    t_bytes = elem_bytes * B * S * hd * (4 * H + 4 * G) / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
