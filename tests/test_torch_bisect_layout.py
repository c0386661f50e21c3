"""The bisect kernels' layout and arithmetic order, on the CPU.

``csrc/bisect.cuh`` solves the seeded bisection on the sortscan kernels'
layout: a row of L <= 256 lanes is W lanes of one warp (two rows a warp at
L <= 16), each holding Q ports in registers, and every row sum is a lane's
in-order sum over its ports and an xor butterfly over the W lanes; a row
of L > 256 is one block of 512 threads, whose 16 warps' sums meet in a
second butterfly. The CUDA code runs only on the card;
``tests/_bisect_network.py`` emulates that order in float32 numpy, and
tests/test_torch_cuda.py holds ``proj_bisect_kernel`` to its bits there.
Here the emulation is held to what the kernel must compute:

* the port's plain version ``ref.proj_rows_bisect`` and the float64 oracle
  ``ref.proj_rows_exact_np`` within 5e-5, the reference's bar for its
  bisect kernel (bracket width / 2^iters);
* the JAX reference's Pallas ``proj_bisect`` in interpret mode within 2e-6,
  the bar of tests/test_torch_bisect.py (the same float32 algorithm, row
  sums in another order);
* rows of zero capacity and rows of z = 0 come back exactly 0;
* ``chip_smoke.py``'s own copy (it imports nothing from tests/) gives the
  emulation's bits.

Widths L in {1, 2, 7, 10, 16, 17, 33, 100, 256, 257, 1000, 4096}, each with
loose rows beside binding ones, duplicated lanes, z = a lanes and a fully
masked row.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _bisect_network as net
from repro.kernels.proj_bisect import proj_bisect as pallas_proj_bisect
from repro_torch.kernels import autotune
from repro_torch.kernels import ref as tref

LS = [1, 2, 7, 10, 16, 17, 33, 100, 256, 257, 1000, 4096]
BISECT_ATOL = 5e-5
PALLAS_ATOL = 2e-6


def _case(L, N=9):
    return net.case_inputs(np.random.default_rng(np.random.SeedSequence([2031, L, N])), N, L)


@pytest.mark.parametrize("L", LS)
def test_emulated_layout_is_the_kernels(L):
    """W threads a row and Q = slots_per_lane / 2 ports a thread: the
    sortscan layout, with the wide rows' MAX_L / WIDE_THREADS ports at
    most."""
    w, q = net.layout(L)
    assert w == autotune.row_threads(L, "bisect") == autotune.row_threads(L, "sortscan")
    assert q == autotune.slots_per_lane(L) // 2
    assert w * q >= L and q <= autotune.MAX_L // autotune.WIDE_THREADS
    assert net.WIDE_L == autotune.WIDE_L and net.WIDE_THREADS == autotune.WIDE_THREADS


@pytest.mark.parametrize("iters", autotune.BISECT_ITERS)
@pytest.mark.parametrize("L", LS)
def test_emulation_matches_plain_and_oracle(L, iters):
    z, a, m, c = _case(L)
    got = net.project(z, a, m, c, iters)
    assert got.dtype == np.float32
    plain = tref.proj_rows_bisect(*map(torch.from_numpy, (z, a, m, c)), iters=iters).numpy()
    np.testing.assert_allclose(got, plain, atol=BISECT_ATOL, rtol=0)
    np.testing.assert_allclose(got, tref.proj_rows_exact_np(z, a, m, c), atol=BISECT_ATOL,
                               rtol=0)
    tau, need = net.water_level(z, a, m, c, iters)
    assert need.any() and not need.all()        # binding rows beside loose ones
    assert not need[::3].any()
    assert (got >= 0).all() and (got <= a).all() and (got[m == 0] == 0).all()
    assert ((got * m).sum(1) <= c + 1e-4).all()


@pytest.mark.parametrize("L", LS)
def test_emulation_matches_pallas_interpret(L):
    z, a, m, c = _case(L)
    want = np.asarray(pallas_proj_bisect(*map(jnp.asarray, (z, a, m, c)), interpret=True))
    np.testing.assert_allclose(net.project(z, a, m, c), want, atol=PALLAS_ATOL, rtol=0)


@pytest.mark.parametrize("L", LS)
def test_zero_capacity_and_zero_rows_come_back_zero(L):
    """Row 5 has capacity 0, row 7 asks for nothing (z = 0): both exactly 0,
    as the Pallas kernel gives."""
    z, a, m, c = _case(L)
    got = net.project(z, a, m, c)
    assert c[5] == 0.0 and (z[7] == 0.0).all()
    assert (got[5] == 0.0).all() and (got[7] == 0.0).all()


@pytest.mark.parametrize("L", [10, 33, 1000])
def test_row_sums_follow_the_lanes_then_the_butterfly(L):
    """The emulated sum of a row is the lanes' in-order sums reduced by the
    butterfly (and, for a wide row, by warps first), not np.sum's order:
    on these rows both orders round alike or within a few ulp, and the
    butterfly gives every lane the same bits."""
    rng = np.random.default_rng([2032, L])
    v = rng.uniform(0.0, 4.0, (64, L)).astype(np.float32)
    w, q = net.layout(L)
    lanes = net.ports(v, w, q)
    assert lanes.shape == (64, w, q)
    np.testing.assert_array_equal(lanes.transpose(0, 2, 1).reshape(64, -1)[:, :L], v)
    s = net.row_reduce(net.ports_sum(lanes), np.add)
    np.testing.assert_allclose(s, v.astype(np.float64).sum(1), rtol=1e-6)
    spread = net.butterfly(net.ports_sum(lanes)[:, :min(w, net.WARP)], np.add)
    assert (spread == spread[:, :1]).all()


@pytest.mark.parametrize("iters", [0, autotune.DEFAULT_BISECT_ITERS])
@pytest.mark.parametrize("L", LS)
def test_chip_smoke_copy_gives_the_emulation_bits(L, iters):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    z, a, m, c = _case(L, N=64)
    np.testing.assert_array_equal(chip_smoke.bisect_network_project(z, a, m, c, iters),
                                  net.project(z, a, m, c, iters))
