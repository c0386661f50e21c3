"""The sortscan kernels' register layout, on the CPU.

``csrc/sortscan.cuh`` holds a row in W lanes of a warp, E breakpoint slots
per lane, and sorts, scans and reduces with shuffles (rows of at most 16
lanes evaluate g at each lane's breakpoints instead); the CUDA code runs
only on the card. Here its layout functions (``kernels.autotune``) are
checked, and ``tests/_sortscan_network.py`` emulates both step for step
in float64 numpy (lanes as array columns). The network must sort like
``np.sort``; the network, and the kernels' design (direct at L <= 16),
must give the water level of the float64 oracle ``ref.proj_rows_exact_np``
within 1e-6 and of the JAX reference's Pallas kernel
``repro.kernels.sortscan.proj_sortscan`` in interpret mode within 1e-6
(the bar tests/test_torch_kernels.py holds the plain version to); at
L <= 16 the direct evaluation must select the network's lo.
tests/test_torch_cuda.py holds the kernels to the emulation's bits on the
card.

Cases: L in {1, 2, 7, 10, 16, 17, 32, 33, 100, 512}, each with tied
breakpoints, z = a lanes, masked lanes and a fully masked row, rows where
the capacity does not bind beside rows where it does in one warp, and an
odd row count.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import _sortscan_network as net
from repro.kernels.sortscan import proj_sortscan as pallas_proj_sortscan
from repro_torch.kernels import autotune
from repro_torch.kernels import ref as tref

LS = [1, 2, 7, 10, 16, 17, 32, 33, 100, 512]
ORACLE_ATOL = 1e-6
PALLAS_ATOL = 1e-6


def _case(L, N=9):
    return net.case_inputs(np.random.default_rng(np.random.SeedSequence([2029, L, N])), N, L)


# ------------------------------------------------------------ layout --
@pytest.mark.parametrize("L,rows_per_warp,lanes,slots", [
    (1, 2, 16, 2), (2, 2, 16, 2), (7, 2, 16, 2), (10, 2, 16, 2), (16, 2, 16, 2),
    (17, 1, 32, 2), (32, 1, 32, 2), (33, 1, 32, 4), (100, 1, 32, 8), (256, 1, 32, 16),
])
def test_layout_functions(L, rows_per_warp, lanes, slots):
    assert autotune.rows_per_warp(L) == rows_per_warp
    assert autotune.lanes_per_row(L) == lanes
    assert autotune.slots_per_lane(L) == slots
    assert lanes * slots == autotune.slots_for(L) >= 2 * L
    assert rows_per_warp * lanes == autotune.WARP
    assert net.layout(L) == (lanes, slots)
    assert autotune.row_threads(L, "sortscan") == lanes
    assert autotune.row_threads(L, "bisect") == lanes   # the bisect row is the sortscan's


@pytest.mark.parametrize("L", [0, autotune.MAX_L + 1])
def test_layout_rejects_widths_outside_the_kernels(L):
    for fn in (autotune.rows_per_warp, autotune.slots_per_lane):
        with pytest.raises(ValueError):
            fn(L)


@pytest.mark.parametrize("L,slots", [(257, 2), (300, 2), (512, 2), (513, 4), (1000, 4),
                                     (2048, 8), (4096, 16)])
def test_wide_rows_take_one_block(L, slots):
    """Rows of WIDE_L < L <= MAX_L: one block of WIDE_THREADS threads, its
    P = slots_for(L) slots in shared memory, P / WIDE_THREADS a thread; row
    block 1 for both methods (the bisect row has sortscan's threads, each
    holding half as many ports as slots, at most MAX_L / WIDE_THREADS), so
    the tuner has one candidate."""
    assert autotune.MAX_L >= 4096 and autotune.WIDE_L == 256
    assert autotune.lanes_per_row(L) == autotune.row_threads(L) == autotune.WIDE_THREADS
    assert autotune.slots_per_lane(L) == slots
    assert slots * autotune.WIDE_THREADS == autotune.slots_for(L) >= 2 * L
    p = autotune.row_threads(L, "bisect")
    assert p == autotune.row_threads(L, "sortscan")
    assert -(-L // p) <= slots // 2 <= autotune.MAX_L // autotune.WIDE_THREADS
    for method in autotune.PROJ_METHODS:
        assert [rb for rb in autotune.ROW_BLOCKS if autotune.legal_row_block(rb, L, method)] == [1]
    assert autotune.block_threads(1, L) == autotune.WIDE_THREADS
    assert [c.row_block for c in autotune.candidates("oga_step", 96, L)] == [1]


@pytest.mark.parametrize("L", [4097, 5000, 10 ** 6])
def test_slots_for_names_its_limit(L):
    """Above MAX_L every entry raises a ValueError naming the limit, as the
    kernels' launch tests refuse the row."""
    with pytest.raises(ValueError, match=f"MAX_L = {autotune.MAX_L}"):
        autotune.slots_for(L)
    with pytest.raises(ValueError, match=str(autotune.MAX_L)):
        autotune.candidates("proj", 8, L)


@pytest.mark.parametrize("row_block,L,threads", [
    (1, 10, 32), (2, 10, 32), (4, 10, 64), (32, 10, 512),
    (1, 100, 32), (16, 100, 512), (1, 256, 32), (1, 512, 512),
])
def test_sortscan_blocks_are_whole_warps(row_block, L, threads):
    """A block is counted in warps, for both methods: two rows of L <= 16
    share one, and a lone such row leaves the other half of its warp
    idle."""
    assert autotune.block_threads(row_block, L, "sortscan") == threads
    assert autotune.block_threads(row_block, L, "bisect") == threads


def test_layout_rejects_unknown_methods():
    with pytest.raises(ValueError):
        autotune.row_threads(10, "quickselect")
    with pytest.raises(ValueError):
        autotune.legal_row_block(1, 10, "quickselect")


# --------------------------------------------------- the network itself --
@pytest.mark.parametrize("L", LS)
def test_network_sorts_like_np_sort(L):
    z, a, m, c = _case(L)
    w, e = net.layout(L)
    _, _, _, _, v, d = net.slots(z, a, m, L)
    sv, sd = net.sort_slots(v, d, w, e)
    flat_v, flat_d = sv.reshape(len(z), -1), sd.reshape(len(z), -1)
    np.testing.assert_array_equal(flat_v, np.sort(v.reshape(len(z), -1), axis=1))
    # the deltas travel with their breakpoints: per distinct value, the
    # same multiset of deltas as before the sort
    for row in range(len(z)):
        before = sorted(zip(v.reshape(len(z), -1)[row], d.reshape(len(z), -1)[row]))
        assert sorted(zip(flat_v[row], flat_d[row])) == before


@pytest.mark.parametrize("L", LS)
def test_network_scans_are_prefix_sums(L):
    """The lane scan is an inclusive prefix sum in slot order s = j E + e."""
    w, e = net.layout(L)
    x = np.random.default_rng(L).integers(-3, 4, (5, w, e)).astype(np.float64)
    np.testing.assert_array_equal(net.lane_scan(x, w, e).reshape(5, -1),
                                  np.cumsum(x.reshape(5, -1), axis=1))


@pytest.mark.parametrize("network", [True, False], ids=["network", "kernel-design"])
@pytest.mark.parametrize("L", LS)
def test_network_matches_float64_oracle(L, network):
    z, a, m, c = _case(L)
    got = net.project(z, a, m, c, network=network)
    np.testing.assert_allclose(got, tref.proj_rows_exact_np(z, a, m, c), atol=ORACLE_ATOL,
                               rtol=0)
    tau, need = net.water_level(z, a, m, c, network=network)
    assert need.any() and not need.all()  # both kinds of row, side by side
    assert not need[::2].any()            # the loose rows never bind
    assert ((got * m).sum(1) <= c + 1e-5).all()


@pytest.mark.parametrize("network", [True, False], ids=["network", "kernel-design"])
@pytest.mark.parametrize("L", LS)
def test_network_matches_pallas_interpret(L, network):
    z, a, m, c = _case(L)
    want = np.asarray(pallas_proj_sortscan(*map(jnp.asarray, (z, a, m, c)), interpret=True))
    np.testing.assert_allclose(net.project(z, a, m, c, network=network), want,
                               atol=PALLAS_ATOL, rtol=0)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("L", [l for l in LS if l <= net.NARROW_L])
def test_direct_evaluation_selects_the_networks_lo(L, seed):
    """At L <= 16 the kernels evaluate g at each breakpoint directly instead
    of sorting and scanning; both must pick the same breakpoint lo, and so
    give the same bits (the tail is shared)."""
    z, a, m, c = net.case_inputs(np.random.default_rng([2030, L, seed]), 257, L)
    tau_d, need_d, lo_d = net.direct_water_level(z, a, m, c)
    tau_n, need_n, lo_n, _ = net.network_water_level(z, a, m, c)
    np.testing.assert_array_equal(need_d, need_n)
    np.testing.assert_array_equal(lo_d[need_d], lo_n[need_n])
    np.testing.assert_array_equal(net.project(z, a, m, c), net.project(z, a, m, c, network=True))


@pytest.mark.parametrize("N", [1, 2, 3, 8, 17])
def test_network_rows_are_independent(N):
    """A row's bits do not depend on its neighbours: the same row alone, or
    with any other rows beside it in the warp, projects the same."""
    for L in (10, 33):
        z, a, m, c = _case(L, N=17)
        whole = net.project(z, a, m, c)
        for start in range(0, 17, N):
            part = slice(start, start + N)
            np.testing.assert_array_equal(net.project(z[part], a[part], m[part], c[part]),
                                          whole[part])
