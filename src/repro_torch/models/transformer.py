"""Block assembly: dense, MoE, SSM and hybrid layers.

Counterpart of ``repro.models.transformer``. Layer parameters are a list
of per-layer dicts (the reference stacks them on a leading (n_layers,)
axis for ``jax.lax.scan``; ``convert.params_from_reference`` unstacks
them), and a Python loop over layers takes the place of the scan; the
per-layer window rides along as an int. A layer holds attention where
``cfg.has_attn``, a Mamba-2 mixer where ``cfg.has_ssm`` (the hybrid family
both, mixed as 0.5 (rms_norm(attn, fuse_a) + rms_norm(ssm, fuse_s))), and
an MoE layer (``n_experts`` > 0) or a SwiGLU MLP (``d_ff`` > 0) after it.

Decode caches stay stacked, as in the reference: "k", "v" (n_layers, B,
S, G, hd) and "kpos" (n_layers, B, S) where the config has attention,
"conv" (n_layers, B, K - 1, di + 2 n) and "state" (n_layers, B, H, P, N)
where it has an SSM. ``stack_decode`` writes each layer's new key, value
and position into them in place, and copies the SSM's new conv window and
state back into its layer. With ``cfg.kv_cache_quant`` K and V are
stored int8 with a float32 scale per (token, head), ``k_scale`` and
``v_scale`` of shape (n_layers, B, S, G): prefill emits that layout and
decode quantises the new token's K/V into its slot and dequantises the
cache to attend.

The mesh knobs (``attn_head_parallel``, ``pure_dp``, ``mlp_ep``) do
nothing on one device: ``check_supported`` raises for a config that asks
for them (ROADMAP Queue 1, item 15h).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_mrope, apply_rope, he_init, rms_norm,
                                       swiglu_apply, swiglu_init)

# position held by an empty cache slot: above any real one
EMPTY_KPOS = 2**30
_MESH_KNOBS = ("attn_head_parallel", "pure_dp", "mlp_ep")
# the SSM's decode-cache entries; every other entry has the sequence on axis 2
SSM_CACHE = ("conv", "state")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a config the port does not run on one device."""
    knobs = [k for k in _MESH_KNOBS if getattr(cfg, k)]
    if knobs:
        raise ValueError(f"{cfg.name}: mesh knobs {knobs} have no meaning on one device")


# ------------------------------------------------------------- init --------
def init_attn(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    d, H, G, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {
        "wq": he_init(gen, (d, H * hd), d, dtype),
        "wk": he_init(gen, (d, G * hd), d, dtype),
        "wv": he_init(gen, (d, G * hd), d, dtype),
        "wo": he_init(gen, (H * hd, d), H * hd, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", G * hd), ("bv", G * hd)):
            p[name] = torch.zeros(width, dtype=dtype, device=gen.device)
    return p


def init_block(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    p = {"ln1": zeros()}
    if cfg.has_attn:
        p["attn"] = init_attn(gen, cfg, dtype)
    if cfg.has_ssm:
        p["ssm"] = ssm_lib.init_mamba2(gen, cfg, dtype)
    if cfg.family == "hybrid":
        p["fuse_a"], p["fuse_s"] = zeros(), zeros()  # learned fuse norms
    if cfg.n_experts > 0:
        p["ln2"] = zeros()
        p["moe"] = moe_lib.init_moe(gen, cfg.d_model, cfg.d_expert, cfg.n_experts,
                                    cfg.n_shared_experts, dtype)
    elif cfg.d_ff > 0:
        p["ln2"] = zeros()
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def layer_windows(cfg: ArchConfig) -> list[int]:
    """Per-layer sliding window sizes; 0 = global attention."""
    if cfg.window is None:
        return [0] * cfg.n_layers
    if cfg.window_pattern == 0:  # all layers local
        return [cfg.window] * cfg.n_layers
    return [0 if i % cfg.window_pattern == cfg.window_pattern - 1 else cfg.window
            for i in range(cfg.n_layers)]


# ------------------------------------------------------------ forward ------
def _qkv(p, cfg: ArchConfig, x, positions):
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv, cfg.hd)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.n_kv, cfg.hd)


def attn_forward(p, cfg: ArchConfig, x, positions, window: int, collect=False):
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    o = attn_lib.attention(q, k, v, window=window, attn_softcap=cfg.attn_softcap)
    out = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
    if not collect:
        return out, None
    if cfg.kv_cache_quant:  # prefill emits the quantised cache layout
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return out, {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return out, {"k": k, "v": v}


def _mix(p, cfg: ArchConfig, ao, so):
    """The hybrid's fuse: 0.5 (rms_norm(attn, fuse_a) + rms_norm(ssm, fuse_s))."""
    return 0.5 * (rms_norm(ao, p["fuse_a"], cfg.norm_eps) + rms_norm(so, p["fuse_s"], cfg.norm_eps))


def _ffn(p, cfg: ArchConfig, x):
    """The residual MLP or MoE after the mixer, where the layer has one."""
    if "ln2" not in p:
        return x
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts > 0:
        return x + moe_lib.apply_moe_auto(p["moe"], h, cfg)
    return x + swiglu_apply(p["mlp"], h)


def block_forward(p, cfg: ArchConfig, x, positions, window: int, collect=False):
    """One layer; with ``collect`` also its decode-cache tensors (else None)."""
    cache = {} if collect else None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.has_attn:
        ao, kv = attn_forward(p["attn"], cfg, h, positions, window, collect)
        if collect:
            cache.update(kv)
    if cfg.has_ssm:
        so = ssm_lib.apply_mamba2(p["ssm"], h, cfg, return_state=collect)
        if collect:
            so, sc = so
            cache.update(sc)
    if cfg.family == "hybrid":
        x = x + _mix(p, cfg, ao, so)
    else:
        x = x + (so if cfg.has_ssm else ao)
    return _ffn(p, cfg, x), cache


def stack_forward(blocks, cfg: ArchConfig, x, positions, collect=False):
    """Every layer in order; with ``collect`` also the stacked caches,
    filled layer by layer: {"k", "v"}: (n_layers, B, S, G, hd) (int8, with
    "k_scale" and "v_scale" (n_layers, B, S, G), when
    ``cfg.kv_cache_quant``) where the config has attention, {"conv",
    "state"} where it has an SSM."""
    caches = {} if collect else None
    for i, (p, w) in enumerate(zip(blocks, layer_windows(cfg))):
        x, kv = block_forward(p, cfg, x, positions, w, collect)
        if collect:
            for name, t in kv.items():
                if name not in caches:
                    caches[name] = t.new_empty((cfg.n_layers,) + tuple(t.shape))
                caches[name][i] = t
    return (x, caches) if collect else x


# ------------------------------------------------------------- decode ------
def quantize_kv(t: torch.Tensor):
    """(..., hd) -> int8 values and a float32 scale per (token, head):
    scale = max|t| / 127 (floored at 1e-8 / 127), values round(t / scale)
    half to even, as ``jnp.round``, clipped to +-127."""
    t32 = t.to(torch.float32)
    scale = torch.clamp_min(t32.abs().amax(-1, keepdim=True), 1e-8) / 127.0
    q = torch.clamp(torch.round(t32 / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, device) -> dict:
    """Stacked per-layer decode caches. Attention: "k", "v" and "kpos", the
    absolute token position of each slot (EMPTY_KPOS when empty); with
    ``cfg.kv_cache_quant`` K and V are int8 with float32 per-(token, head)
    scales: (hd + 4) / (2 hd) of bf16's bytes. SSM: "conv" and "state" in
    ``dtype``, zeros."""
    check_supported(cfg)
    cache = {}
    if cfg.has_attn:
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.hd)
        kv_dtype = torch.int8 if cfg.kv_cache_quant else dtype
        cache["k"] = torch.zeros(shape, dtype=kv_dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=kv_dtype, device=device)
        if cfg.kv_cache_quant:
            cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache["kpos"] = torch.full((cfg.n_layers, batch, cache_len), EMPTY_KPOS,
                                   dtype=torch.int32, device=device)
    if cfg.has_ssm:
        one = ssm_lib.init_mamba2_cache(cfg, batch, dtype, device)
        for name in SSM_CACHE:
            cache[name] = one[name].expand(cfg.n_layers, *one[name].shape).contiguous()
    return cache


def attn_decode(p, cfg: ArchConfig, x, cache_slice: dict, pos, positions, window: int):
    """x: (B, 1, d); cache_slice: one layer's {"k", "v"} (B, S, G, hd),
    "kpos" (B, S) and, quantised, "k_scale" and "v_scale" (B, S, G),
    written in place; pos: (B,) per-row positions. Row b writes slot
    pos_b mod cache_len (a ring buffer for windowed configs)."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x, positions)
    k_cache, v_cache, kpos = cache_slice["k"], cache_slice["v"], cache_slice["kpos"]
    slot = pos % k_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    if cfg.kv_cache_quant:
        k_scale, v_scale = cache_slice["k_scale"], cache_slice["v_scale"]
        k_cache[rows, slot], k_scale[rows, slot] = quantize_kv(k[:, 0])
        v_cache[rows, slot], v_scale[rows, slot] = quantize_kv(v[:, 0])
        k_full = dequantize_kv(k_cache, k_scale, q.dtype)
        v_full = dequantize_kv(v_cache, v_scale, q.dtype)
    else:
        k_cache[rows, slot] = k[:, 0]
        v_cache[rows, slot] = v[:, 0]
        k_full, v_full = k_cache, v_cache
    kpos[rows, slot] = pos.to(kpos.dtype)
    o = attn_lib.decode_attention(q, k_full, v_full, pos, kpos, window=window,
                                  attn_softcap=cfg.attn_softcap)
    return o.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"]


def block_decode(p, cfg: ArchConfig, x, cache_slice: dict, pos, positions, window: int):
    """One layer's decode step. The attention's cache is written in place;
    returns (x, the SSM's new {"conv", "state"} or None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.has_attn:
        ao = attn_decode(p["attn"], cfg, h, cache_slice, pos, positions, window)
    sc = None
    if cfg.has_ssm:
        so, sc = ssm_lib.apply_mamba2_decode(
            p["ssm"], h, {n: cache_slice[n] for n in SSM_CACHE}, cfg)
    if cfg.family == "hybrid":
        x = x + _mix(p, cfg, ao, so)
    else:
        x = x + (so if cfg.has_ssm else ao)
    return _ffn(p, cfg, x), sc


def stack_decode(blocks, cfg: ArchConfig, x, cache: dict, pos, positions):
    """One decode step through every layer; ``cache`` is updated in place
    (the SSM's conv window and state copied back into their layer) and
    returned."""
    for i, (p, w) in enumerate(zip(blocks, layer_windows(cfg))):
        layer = {name: t[i] for name, t in cache.items()}
        x, sc = block_decode(p, cfg, x, layer, pos, positions, w)
        if sc is not None:
            for name in SSM_CACHE:
                layer[name].copy_(sc[name])
    return x, cache
