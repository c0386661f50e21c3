"""A float64 numpy emulation of the sortscan water level
(``src/repro_torch/kernels/csrc/sortscan.cuh``), step for step.

Rows of more than 16 lanes go through the register network: the W lanes
of a row are the middle axis of (N, W, E) arrays and the E registers of a
lane the last, with the same partner and direction formulas, the same
split between compare-exchanges inside a lane (partner distance s < E)
and shuffles across lanes (lane distance s / E), and the same serial,
shuffle-scan and butterfly order of every sum. Rows of at most 16 lanes
go through the direct evaluation (``direct_water_level``: g at each
lane's two breakpoints, summed over the ports in order). Both end in the
same closed-form tail. The kernel's products that feed sums are
``__dmul_rn`` (never contracted into an FMA), so on the card the kernel
must give these bits. Shared by tests/test_torch_sortscan_layout.py (CPU)
and tests/test_torch_cuda.py (the card); imports nothing but numpy.
"""
import numpy as np

NEG = -1e30
NARROW_L = 16
WARP = 32


def layout(L: int) -> tuple[int, int]:
    """(W lanes per row, E slots per lane) of a row of L lanes."""
    w = WARP // 2 if L <= NARROW_L else WARP
    p = WARP
    while p < 2 * L:
        p *= 2
    return w, p // w


def group_sum(x, w):
    """Butterfly sum over the lane axis: lane j adds lane j ^ o, o = W/2..1."""
    j = np.arange(w)
    o = w // 2
    while o:
        x = x + x[:, j ^ o]
        o //= 2
    return x


def dmax(x, y):
    """max by compare and select, as the kernel takes it."""
    return np.where(y > x, y, x)


def group_max(x, w):
    j = np.arange(w)
    o = w // 2
    while o:
        x = dmax(x, x[:, j ^ o])
        o //= 2
    return x


def lane_scan(x, w, e_slots):
    """Inclusive scan in slot order s = j E + e: serial over a lane's E
    registers, a Hillis-Steele scan of the lane totals, and the exclusive
    prefix (the inclusive total of lane j - 1) added back."""
    x = x.copy()
    for e in range(1, e_slots):
        x[:, :, e] = x[:, :, e] + x[:, :, e - 1]
    inc = x[:, :, e_slots - 1].copy()
    j = np.arange(w)
    o = 1
    while o < w:
        inc = np.where(j >= o, inc + inc[:, np.maximum(j - o, 0)], inc)
        o *= 2
    x[:, 1:, :] = x[:, 1:, :] + inc[:, :-1, None]
    return x


def sort_slots(v, d, w, e_slots):
    """The ascending bitonic network over P = W E slots of (v, d) pairs:
    slot i = j E + e pairs with i ^ s at sub-step (k, s), ascending when
    i & k == 0, swapped only when out of order (ties never)."""
    v, d = v.copy(), d.copy()
    j = np.arange(w)
    slot = j[:, None] * e_slots + np.arange(e_slots)[None, :]     # (W, E)
    k = 2
    while k <= w * e_slots:
        s = k // 2
        while s:
            up = (slot & k) == 0
            if s < e_slots:                      # inside a lane
                for e in range(e_slots):
                    f = e ^ s
                    if f > e:
                        ve, vf, de, df = v[:, :, e], v[:, :, f], d[:, :, e], d[:, :, f]
                        sw = np.where(up[None, :, e], ve > vf, ve < vf)
                        v[:, :, e], v[:, :, f] = np.where(sw, vf, ve), np.where(sw, ve, vf)
                        d[:, :, e], d[:, :, f] = np.where(sw, df, de), np.where(sw, de, df)
            else:                                # across lanes: a shuffle
                ls = s // e_slots
                pv, pd = v[:, j ^ ls, :], d[:, j ^ ls, :]
                upper = ((j & ls) != 0)[None, :, None]
                lo, hi = np.where(upper, pv, v), np.where(upper, v, pv)
                sw = np.where(up[None], lo > hi, lo < hi)
                v, d = np.where(sw, pv, v), np.where(sw, pd, d)
            s //= 2
        k *= 2
    return v, d


def clip0(x, hi):
    """clip(x, 0, hi) by compare and select, as the kernel takes it."""
    x = np.where(x > 0.0, x, 0.0)
    return np.where(x < hi, x, hi)


def slots(z, a, m, L):
    """The lanes' ports and their breakpoint slots before the sort: port
    j + W q in lane j, slot q its z - a (delta +m), slot E/2 + q its z
    (delta -m), pads -1e30 with delta 0. Returns (has, z, a, m) as (N, W,
    E/2) and (v, d) as (N, W, E)."""
    N = z.shape[0]
    w, e_slots = layout(L)
    q = e_slots // 2
    port = np.arange(w)[:, None] + w * np.arange(q)[None, :]
    has = np.broadcast_to(port < L, (N, w, q))
    take = np.minimum(port, L - 1)
    zf, af, mf = (np.where(has, np.asarray(t, np.float32)[:, take], np.float32(0))
                  for t in (z, a, m))
    v = np.concatenate([np.where(has, zf.astype(np.float64) - af, NEG),
                        np.where(has, zf.astype(np.float64), NEG)], axis=2)
    d = np.concatenate([np.where(has, mf, np.float32(0)),
                        np.where(has, -mf, np.float32(0))], axis=2)
    return has, zf, af, mf, v, d


def _tail(has, zd, ad, md, cd, lo, w):
    """tau from lo: g(lo) and the slope at lo summed directly, closed form."""
    glo = np.zeros(lo.shape)
    slope = np.zeros(lo.shape)
    for q in range(has.shape[2]):
        h, zq, aq, mq = has[:, :, q], zd[:, :, q], ad[:, :, q], md[:, :, q]
        glo = np.where(h, glo + clip0(zq - lo, aq) * mq, glo)
        slope = np.where(h, slope + np.where((zq - aq <= lo) & (zq > lo), mq, 0.0), slope)
    glo = group_sum(glo, w)
    slope = group_sum(slope, w)
    return dmax(np.where(slope > 0.5, lo + (glo - cd) / dmax(slope, 1.0), lo), 0.0)


def _ports(z, a, m, c):
    L = np.shape(z)[1]
    has, zf, af, mf, v, d = slots(z, a, m, L)
    zd, ad, md = (t.astype(np.float64) for t in (zf, af, mf))
    cd = np.asarray(c, np.float32).astype(np.float64)[:, None]
    return has, zd, ad, md, cd, v, d


def network_water_level(z, a, m, c):
    """(tau, need, lo, sorted slots) per row through the register network."""
    N, L = np.shape(z)
    w, e_slots = layout(L)
    has, zd, ad, md, cd, v, d = _ports(z, a, m, c)
    box = np.zeros((N, w))
    g0 = np.zeros((N, w))
    for q in range(e_slots // 2):
        h = has[:, :, q]
        box = np.where(h, box + clip0(zd[:, :, q], ad[:, :, q]) * md[:, :, q], box)
        g0 = np.where(h, g0 + ad[:, :, q] * md[:, :, q], g0)
    need = group_sum(box, w) > cd
    sv, sd = sort_slots(v, d, w, e_slots)
    n = lane_scan(sd.astype(np.float64), w, e_slots)
    j = np.arange(w)
    prev = np.maximum(j - 1, 0)
    v_prev = np.concatenate([np.where(j > 0, sv[:, prev, -1], sv[:, :, 0])[:, :, None],
                             sv[:, :, :-1]], axis=2)
    n_prev = np.concatenate([np.where(j > 0, n[:, prev, -1], 0.0)[:, :, None],
                             n[:, :, :-1]], axis=2)
    drop = lane_scan(n_prev * (sv - v_prev), w, e_slots)
    g0 = group_sum(g0, w)
    best = np.full((N, w), NEG)
    for e in range(e_slots):
        best = np.where(g0 - drop[:, :, e] >= cd, dmax(best, sv[:, :, e]), best)
    lo = group_max(best, w)
    tau = _tail(has, zd, ad, md, cd, lo, w)
    return tau[:, 0], need[:, 0], lo[:, 0], sv.reshape(N, -1)


def direct_water_level(z, a, m, c):
    """(tau, need, lo) per row of at most 16 lanes, one port per lane: g at
    the lane's breakpoints z - a and z summed over l = 0 .. L-1 in order."""
    N, L = np.shape(z)
    w, _ = layout(L)
    assert L <= NARROW_L
    has, zd, ad, md, cd, _, _ = _ports(z, a, m, c)
    h, zl, al, ml = has[:, :, 0], zd[:, :, 0], ad[:, :, 0], md[:, :, 0]
    need = group_sum(np.where(h, clip0(zl, al) * ml, 0.0), w) > cd
    b0, b1 = zl - al, zl
    g0 = np.zeros((N, w))
    g1 = np.zeros((N, w))
    for port in range(L):
        zp, ap, mp = zl[:, port:port + 1], al[:, port:port + 1], ml[:, port:port + 1]
        g0 = g0 + clip0(zp - b0, ap) * mp
        g1 = g1 + clip0(zp - b1, ap) * mp
    best = np.where(h & (g0 >= cd), b0, NEG)
    best = np.where(h & (g1 >= cd), dmax(best, b1), best)
    lo = group_max(best, w)
    tau = _tail(has, zd, ad, md, cd, lo, w)
    return tau[:, 0], need[:, 0], lo[:, 0]


def water_level(z, a, m, c, network=False):
    """(tau, need) per row as the kernel computes them: the direct
    evaluation at L <= 16, the network above (or always, with network)."""
    if np.shape(z)[1] <= NARROW_L and not network:
        return direct_water_level(z, a, m, c)[:2]
    return network_water_level(z, a, m, c)[:2]


def project(z, a, m, c, network=False):
    """The projected rows, rounded once to float32 as the kernel stores
    them: the box clip (in float32) where the capacity does not bind."""
    z, a, m = (np.asarray(t, np.float32) for t in (z, a, m))
    tau, need = water_level(z, a, m, c, network)
    fill = (clip0(z.astype(np.float64) - tau[:, None], a.astype(np.float64))
            * m.astype(np.float64)).astype(np.float32)
    box = np.fmin(np.fmax(z, np.float32(0)), a) * m
    return np.where(need[:, None], fill, box)


def case_inputs(rng, N, L):
    """The reference's projection-test distribution of z and a (z ~ N(0, 5),
    a ~ U(0.1, 4)) with the layout's edge cases: in the first quarter of the
    rows tied breakpoints (odd lanes copy their even neighbour) and a lane
    with z = a; masked lanes (one in five) and a fully masked row; every
    even row's capacity too large to bind, and every odd row's 0.2-0.8 of
    its box sum, so it binds at every width unless the row is all masked:
    at L <= 16 each warp holds a row that binds beside one that does not."""
    z = rng.normal(0.0, 5.0, (N, L)).astype(np.float32)
    a = rng.uniform(0.1, 4.0, (N, L)).astype(np.float32)
    m = (rng.random((N, L)) < 0.8).astype(np.float32)
    tie = slice(0, max(N // 4, 1))
    z[tie, 1::2] = z[tie, 0:L - 1:2]
    a[tie, 1::2] = a[tie, 0:L - 1:2]
    z[tie, 0] = a[tie, 0]
    m[N // 2] = 0.0
    box = (np.clip(z, 0.0, a) * m).sum(1)
    c = (rng.uniform(0.2, 0.8, N) * box).astype(np.float32)
    c[::2] = 1e4
    return z, a, m, c
