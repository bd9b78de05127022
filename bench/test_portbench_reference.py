"""The benchmark's plain reference and input generators, on the CPU.

The reference (``bench/reference.py``) must equal the port's plain path
bit for bit and reconstruct exactly; it may import nothing of the port,
but this test may.
"""
import numpy as np
import pytest
import torch

from bench import harness
from bench import reference as R
from repro_torch import kernels as K

SHAPES_2D = [((2, 2), 1), ((3, 5), 1), ((7, 9), 2), ((33, 17), 3), ((64, 48), 4), ((2, 31), 1)]
SHAPES_3D = [((2, 3, 2), 1), ((5, 7, 9), 2), ((8, 6, 10), 2), ((16, 20, 18), 3)]


def _leaves(approx, details):
    return [approx] + [b for lvl in details for b in lvl]


@pytest.mark.parametrize("shape,levels", SHAPES_2D)
def test_reference_2d_equals_port_plain_path(shape, levels):
    rng = np.random.default_rng(hash(shape) % 2**32)
    x = rng.integers(-128, 128, (3,) + shape).astype(np.int32)
    pyr = K.dwt_fwd_2d_multi(torch.from_numpy(x), levels, mode="jpeg2000", scheme="cdf53")
    for i in range(x.shape[0]):
        want = _leaves(pyr.ll[i].numpy(), [[b[i].numpy() for b in lvl] for lvl in pyr.details])
        got = _leaves(*R.forward(x[i], levels, 2))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and np.array_equal(g, w)


@pytest.mark.parametrize("shape,levels", SHAPES_3D)
def test_reference_3d_equals_port_plain_path(shape, levels):
    rng = np.random.default_rng(hash(shape) % 2**32)
    x = rng.integers(-2048, 2048, (2,) + shape).astype(np.int32)
    pyr = K.dwt_fwd_nd(torch.from_numpy(x), levels, mode="jpeg2000", scheme="cdf53", ndim=3)
    for i in range(x.shape[0]):
        want = _leaves(pyr.approx[i].numpy(), [[b[i].numpy() for b in lvl] for lvl in pyr.details])
        got = _leaves(*R.forward(x[i], levels, 3))
        assert len(got) == len(want) == 1 + 7 * levels
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("ndim,shape,levels", [(1, (9,), 3), (2, (7, 9), 2), (3, (5, 7, 9), 2),
                                               (2, (64, 48), 4), (3, (16, 20, 18), 3)])
def test_reference_reconstructs_exactly(ndim, shape, levels):
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 20), 1 << 20, shape).astype(np.int32)
    assert np.array_equal(R.inverse(*R.forward(x, levels, ndim), ndim), x)


def test_reference_update_rounds_with_the_annex_f_offset():
    """x = 0 1 0 1 0: d = x_odd - floor((left + right) / 2) = [1, 1], and
    s = x_even + floor((d_prev + d + 2) / 4) = [1, 1, 1] (the ends
    reflected); without the +2 every s would stay 0."""
    s, d = R._fwd_axis(np.array([0, 1, 0, 1, 0], np.int32), -1)
    assert d.tolist() == [1, 1] and s.tolist() == [1, 1, 1]


def _cell(name, **config):
    cell = harness.find_cell(name)
    cell.config.update(config)
    return cell


@pytest.mark.parametrize("name,shape,lo,hi", [("jp2k2d.frames-2048", [40, 36], -128, 127),
                                              ("jp3d.ct-512", [12, 16, 14], -2048, 2047)])
def test_inputs_are_seeded_in_range_and_distinct(name, shape, lo, hi):
    cell = _cell(name, shape=shape)
    make = harness.content(cell).make

    def draw(seed):
        return make(torch.Generator().manual_seed(seed), 3, cell.config, torch.device("cpu"))

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(2**31 + 6)
    assert a.dtype == torch.int32 and tuple(a.shape) == (3, *shape)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert lo <= int(a.min()) and int(a.max()) <= hi
    assert not torch.equal(a[0], a[1])  # every item of a batch is its own
