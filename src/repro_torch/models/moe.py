"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

Counterpart of ``repro.models.moe`` on one device. Dispatch avoids a
(T, E, C) one-hot tensor (infeasible at E = 384): the (token, expert)
assignments are sorted by expert id (stably), ranked within their expert
by ``searchsorted``, and scattered into an (E, C, d) buffer; the expert
products are batched matmuls over E. An assignment of rank >= C drops.

The router is float32 whatever the parameter dtype, and routing runs in
float32, as in the reference. The dispatch scatter accumulates
(``index_put_(accumulate=True)``) as the reference's ``.at[].add`` does: a
dropped assignment adds a zero at expert 0's slot 0, where a plain indexed
assignment would overwrite the token kept there. The combine adds each
token's k weighted expert outputs (a dropped one weighted 0) in expert-id
order, the order of the reference's ``out.at[st].add`` over the expert-
sorted assignments, as a fixed sequence of sums: an atomic scatter-add
(``index_add_`` on the card) would add them in no fixed order, and in
bf16 that moves the output by an ulp from run to run.

``_local_dispatch_combine`` is the expert-parallel path's local step
(experts [e0, e0 + E_loc) of E), with int-only index plumbing and k
bounded gathers; with e0 = 0 and E_loc = E it is a second implementation
of ``apply_moe`` without the shared expert.

``apply_moe_ep`` and ``apply_mlp_ep`` are the reference's shard_map
layers over a ``train.meshctx.Mesh``, run as a loop over its positions in
one process (as ``core.distributed`` runs §3.2): data shards split the
batch over the DP axes, model shards hold E / tp experts (or d_ff / tp of
the MLP). A shard's all_gather of the sequence across 'model' is a
``torch.cat`` of the sequence blocks on its device; the psum (or
psum_scatter) of the model shards' partial outputs is their sum in shard
order, split along the sequence. Capacity is counted per data shard, from
its own tokens, as in the reference: with more than one data shard at a
binding capacity factor ``apply_moe_ep`` is not ``apply_moe`` over the
whole batch, but ``apply_moe`` over each data shard's tokens.
``apply_moe_auto`` takes the expert-parallel path under a mesh with a
'model' axis that divides the experts, and ``apply_moe`` otherwise.

``apply_moe`` and ``_local_dispatch_combine`` can also return the kept
assignments as a (T, E) bool tensor, each computed by its own index
plumbing, so that the two can be held to the same routing exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import he_init, swiglu_apply
from repro_torch.train.meshctx import Mesh, constrain, current_mesh, dp_positions


def init_moe(gen: torch.Generator, d_model: int, d_expert: int, n_experts: int,
             n_shared: int, dtype) -> dict:
    """Router (d, E) in float32; gate and up (E, d, f), down (E, f, d) and
    the shared expert's (d, n_shared f) / (n_shared f, d) in ``dtype``."""
    p = {
        "router": he_init(gen, (d_model, n_experts), d_model, torch.float32),
        "gate": he_init(gen, (n_experts, d_model, d_expert), d_model, dtype),
        "up": he_init(gen, (n_experts, d_model, d_expert), d_model, dtype),
        "down": he_init(gen, (n_experts, d_expert, d_model), d_expert, dtype),
    }
    if n_shared:
        f = n_shared * d_expert
        p["shared"] = {
            "gate": he_init(gen, (d_model, f), d_model, dtype),
            "up": he_init(gen, (d_model, f), d_model, dtype),
            "down": he_init(gen, (f, d_model), d_expert, dtype),
        }
    return p


def capacity(T: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: int(T k / E cf), at least k (the reference's
    truncation)."""
    return max(int(T * top_k / n_experts * capacity_factor), top_k)


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """float32 routing: softmax over x @ router, the top k renormalised.
    Returns (gate weights (T, k) float32, expert ids (T, k) int64)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    gate_w, eidx = torch.topk(probs, top_k, dim=-1)
    return gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9), eidx


def _rank_in_expert(flat_e: torch.Tensor):
    """Stable sort of the assignments by expert id and each one's rank in
    its expert's group: (order, sorted ids, rank)."""
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(se.numel(), device=se.device) - first
    return order, se, rank


def _experts(p: dict, xbuf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its (C, d) slots: (E, C, d) -> (E, C, d)."""
    g = F.silu(torch.bmm(xbuf, p["gate"]))
    return torch.bmm(g * torch.bmm(xbuf, p["up"]), p["down"])


def _shared(s: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ s["gate"]) * (x @ s["up"])) @ s["down"]


def apply_moe(p: dict, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
              return_kept: bool = False):
    """x: (T, d) tokens -> (T, d), plus the kept assignments (T, E) bool
    with ``return_kept``."""
    T, d = x.shape
    E = p["router"].shape[1]
    C = capacity(T, top_k, E, capacity_factor)
    gate_w, eidx = route(p["router"], x, top_k)

    # ---- sort-based dispatch ------------------------------------------
    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(top_k)
    order, se, rank = _rank_in_expert(flat_e)
    st, sw = flat_t[order], gate_w.reshape(-1)[order]
    keep = rank < C                                   # overflow drops
    slot_e = torch.where(keep, se, 0)
    slot_c = torch.where(keep, rank, 0)
    xbuf = torch.zeros((E, C, d), dtype=x.dtype, device=x.device)
    xbuf.index_put_((slot_e, slot_c), torch.where(keep[:, None], x[st], 0.0).to(x.dtype),
                    accumulate=True)
    # the reference's EP placement hints: experts over 'model', capacity over 'data'
    xbuf = constrain(xbuf, "model", "data", None)

    # ---- expert computation and combine --------------------------------
    ybuf = constrain(_experts(p, xbuf), "model", "data", None)
    vals = ybuf[slot_e, slot_c] * (sw * keep)[:, None].to(x.dtype)
    # a token's k entries, in the expert order the sort left them in
    v = vals[torch.argsort(st, stable=True)].reshape(T, top_k, d)
    out = v[:, 0]
    for j in range(1, top_k):
        out = out + v[:, j]
    if "shared" in p:
        out = out + _shared(p["shared"], x)
    if not return_kept:
        return out
    kept = torch.zeros((T, E), dtype=torch.bool, device=x.device)
    kept[st, se] = keep  # a token's k experts are distinct: no pair repeats
    return out, kept


def _local_dispatch_combine(p_local: dict, x_flat: torch.Tensor, top_k: int, cf: float,
                            e0: int, E: int, E_loc: int, return_kept: bool = False):
    """Capacity dispatch over the expert range [e0, e0 + E_loc) of E.

    Returns this range's part of the output (T, d): assignments to experts
    outside it contribute zero. Invalid entries get the coordinates
    (E_loc, C), one past each buffer's end, and are cut off with it (the
    reference's ``mode="drop"``). With ``return_kept`` also the kept
    assignments (T, E) bool, from this function's own indices.
    """
    T, d = x_flat.shape
    dev = x_flat.device
    C = capacity(T, top_k, E, cf)
    gate_w, eidx = route(p_local["router"], x_flat, top_k)

    flat_e = eidx.reshape(-1) - e0                    # local expert ids
    mine = (flat_e >= 0) & (flat_e < E_loc)
    flat_e = torch.where(mine, flat_e, E_loc)         # sentinel sorts last
    flat_t = torch.arange(T, device=dev).repeat_interleave(top_k)
    order, se, rank = _rank_in_expert(flat_e)
    st = flat_t[order]
    keep = (rank < C) & (se < E_loc)
    slot_e = torch.where(keep, se, E_loc)
    slot_c = torch.where(keep, rank, C)

    # int-only index plumbing: never a (T k, d) features tensor
    tok_for_slot = torch.full((E_loc + 1, C + 1), T, dtype=torch.int64, device=dev)
    tok_for_slot[slot_e, slot_c] = st
    slot_valid = torch.zeros((E_loc + 1, C + 1), dtype=x_flat.dtype, device=dev)
    slot_valid[slot_e, slot_c] = 1.0
    tok_for_slot, slot_valid = tok_for_slot[:E_loc, :C], slot_valid[:E_loc, :C]
    xpad = torch.cat([x_flat, x_flat.new_zeros((1, d))], 0)
    xbuf = xpad[tok_for_slot] * slot_valid[..., None]  # (E_loc, C, d)
    ybuf = _experts(p_local, xbuf)

    # per-(t, k) slot coordinates, recovered by unsorting (ints only)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * top_k, device=dev)
    flat_sc = torch.where(keep, rank, 0)[inv].reshape(T, top_k)
    flat_se = torch.where(mine, eidx.reshape(-1) - e0, 0).reshape(T, top_k)
    kept_tk = keep[inv].reshape(T, top_k)
    w_eff = gate_w.to(x_flat.dtype) * kept_tk.to(x_flat.dtype)
    out = x_flat.new_zeros((T, d))
    for j in range(top_k):  # k bounded gathers of (T, d)
        out = out + w_eff[:, j, None] * ybuf[flat_se[:, j], flat_sc[:, j]]
    if not return_kept:
        return out
    kept = torch.zeros((T, E), dtype=torch.bool, device=dev)
    kept.scatter_(1, eidx, kept_tk)
    return out, kept


def _ep_layout(mesh: Mesh, x: torch.Tensor):
    """The data shards' batch rows and whether the sequence splits over
    'model' (the reference's x spec P(dp, 'model' or None, None))."""
    if "model" not in mesh.shape:
        raise ValueError(f"the mesh {mesh.axis_names} has no 'model' axis")
    tp = mesh.shape["model"]
    B, S, _ = x.shape
    dps = dp_positions(mesh)
    if B % len(dps):
        raise ValueError(f"batch {B} does not divide over {len(dps)} data shards")
    Bl = B // len(dps)
    rows = [slice(i * Bl, (i + 1) * Bl) for i in range(len(dps))]
    return dps, rows, tp, S % tp == 0 and S >= tp


def _seq_blocks(t: torch.Tensor, tp: int) -> list[torch.Tensor]:
    return list(t.split(t.shape[1] // tp, dim=1))


def _shard_sum(parts: list[torch.Tensor], dev) -> torch.Tensor:
    """The psum: the model shards' partials added on ``dev`` in shard order."""
    total = parts[0].to(dev)
    for part in parts[1:]:
        total = total + part.to(dev)
    return total


def _combine(parts: list[torch.Tensor], mesh: Mesh, at: dict, seq_split: bool):
    """The model shards' partial outputs (Bl, S, d) of one data shard
    summed: split along the sequence, shard j's block summed on its device
    (psum_scatter); unsplit, summed once (psum, every shard the same).
    Returns [(model shard j, its output)]."""
    if not seq_split:
        return [(0, _shard_sum(parts, mesh.device(**at, model=0)))]
    tp = len(parts)
    blocks = [_seq_blocks(pt, tp) for pt in parts]
    return [(j, _shard_sum([b[j] for b in blocks], mesh.device(**at, model=j)))
            for j in range(tp)]


def apply_moe_ep(p: dict, x: torch.Tensor, cfg, mesh: Mesh, return_kept: bool = False):
    """Expert-parallel MoE over ``mesh`` (the reference's shard_map). x:
    (B, S, d) -> (B, S, d), on x's device.

    Each data shard's tokens are gathered across 'model'; model shard j
    runs ``_local_dispatch_combine`` over experts [j E / tp, (j + 1) E /
    tp) on its device, with the capacity of the data shard's token count;
    the partials are summed in shard order and split back along the
    sequence. When S % tp != 0 or S < tp the sequence is not split (the
    reference's psum fallback). The shared expert runs on each shard's own
    tokens. With ``return_kept`` also the kept assignments (B S, E) bool,
    the union of the model shards'. Raises ``ValueError`` when the experts
    do not divide over 'model' or the batch over the data shards."""
    E = cfg.n_experts
    dps, rows, tp, seq_split = _ep_layout(mesh, x)
    if E % tp:
        raise ValueError(f"{E} experts do not divide over a 'model' axis of {tp}")
    E_loc = E // tp
    B, S, d = x.shape
    outs, kepts = [], []
    for at, r in zip(dps, rows):
        xr = x[r]
        # the shard (at, j) holds x[r], its sequence block j when split
        local = _seq_blocks(xr, tp) if seq_split else [xr] * tp
        parts, kept = [], None
        for j in range(tp):
            dev = mesh.device(**at, model=j)
            xg = torch.cat([blk.to(dev) for blk in local], dim=1) if seq_split else local[j].to(dev)
            e0 = j * E_loc
            p_loc = {"router": p["router"].to(dev),
                     **{k: p[k][e0:e0 + E_loc].to(dev) for k in ("gate", "up", "down")}}
            res = _local_dispatch_combine(p_loc, xg.reshape(-1, d), cfg.top_k,
                                          cfg.capacity_factor, e0, E, E_loc, return_kept)
            if return_kept:
                res, k_j = res
                kept = k_j.to(x.device) if kept is None else kept | k_j.to(x.device)
            parts.append(res.reshape(xg.shape))
        blocks = []
        for j, out_j in _combine(parts, mesh, at, seq_split):
            if "shared" in p:
                s = {k: t.to(out_j.device) for k, t in p["shared"].items()}
                out_j = out_j + _shared(s, local[j].to(out_j.device))
            blocks.append(out_j.to(x.device))
        outs.append(torch.cat(blocks, dim=1))
        kepts.append(kept)
    out = torch.cat(outs, dim=0)
    return (out, torch.cat(kepts, dim=0)) if return_kept else out


def apply_mlp_ep(p: dict, x: torch.Tensor, cfg, mesh: Mesh) -> torch.Tensor:
    """Dense SwiGLU with d_ff tensor-parallel over 'model' (the
    reference's shard_map): each data shard's sequence gathered across
    'model', shard j's product over its d_ff / tp columns, the partials
    summed in shard order and split back along the sequence. Where S % tp
    != 0, S < tp or d_ff % tp != 0 it is ``swiglu_apply``, as in the
    reference."""
    dps, rows, tp, seq_split = _ep_layout(mesh, x)
    d_ff = p["gate"].shape[1]
    if not seq_split or d_ff % tp:
        return swiglu_apply(p, x)
    f = d_ff // tp
    outs = []
    for at, r in zip(dps, rows):
        local = _seq_blocks(x[r], tp)
        parts = []
        for j in range(tp):
            dev = mesh.device(**at, model=j)
            xg = torch.cat([blk.to(dev) for blk in local], dim=1)
            cols = slice(j * f, (j + 1) * f)
            g = F.silu(xg @ p["gate"][:, cols].to(dev))
            parts.append((g * (xg @ p["up"][:, cols].to(dev))) @ p["down"][cols].to(dev))
        outs.append(torch.cat([o.to(x.device) for _, o in _combine(parts, mesh, at, True)],
                              dim=1))
    return torch.cat(outs, dim=0)


def apply_moe_auto(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): ``apply_moe_ep`` under an active mesh
    with a 'model' axis that divides the experts, else ``apply_moe`` over
    the B S tokens (the reference's two branches)."""
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.axis_names \
            and cfg.n_experts % mesh.shape["model"] == 0:
        return apply_moe_ep(p, x, cfg, mesh)
    B, S, d = x.shape
    return apply_moe(p, x.reshape(B * S, d), cfg.top_k, cfg.capacity_factor).reshape(B, S, d)
