"""Port parity of the halo-tiled 2-D level at its default tile.

``csrc/tiled2d.cu`` moves whole 16-byte words and sizes its tiles so that
three blocks share an SM (``kernels.backend.pick_tile``: 128 x 128 for
cdf53 and haar, 124 x 128 for 97m).  On the CPU the wrappers run the
kernels' plain versions; these tests hold them, at that default tile,
against the reference's tiled Pallas kernels (``repro.kernels.tiled2d``,
interpret mode, with ``REPRO_DWT_TILE`` forcing the same tile as the
reference's own tests do), on images of a few tiles, odd and even.  The
CUDA kernels are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as RK
from repro.kernels import tiled2d as RT
from repro_torch import kernels as TK
from repro_torch.core import schemes as TS
from repro_torch.kernels import backend as TB
from repro_torch.kernels import tiled2d as TT

MODES = ("paper", "jpeg2000")
# every scheme that windows both axes at these shapes; haar only on even
# sizes.  Two shapes per scheme, so the reference compiles few shapes.
CASES = [
    ("cdf53", (2, 256, 256)),
    ("cdf53", (1, 255, 201)),
    ("97m", (2, 256, 256)),
    ("97m", (1, 255, 201)),
    ("haar", (2, 256, 256)),
    ("haar", (1, 254, 200)),
]
RNG = np.random.default_rng(1717)


def _img(shape):
    return RNG.integers(-(1 << 12), 1 << 12, shape).astype(np.int32)


def _default_tile(name, h, w, monkeypatch):
    """The tile the card would take, then forced in both packages."""
    monkeypatch.delenv("REPRO_DWT_TILE", raising=False)
    th, tw = TB.pick_tile(h, w, TS.get_scheme(name).halo)
    monkeypatch.setenv("REPRO_DWT_TILE", f"{th},{tw}")
    return th, tw


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,shape", CASES)
def test_default_tile_level_matches_reference_tiled_kernels(name, shape, mode, monkeypatch):
    """One level forward and inverse at the default tile: the port's plain
    versions equal the reference's tiled kernels, and invert exactly."""
    _, h, w = shape
    th, tw = _default_tile(name, h, w, monkeypatch)
    assert TB.pick_tile(h, w, TS.get_scheme(name).halo) == (th, tw)
    # a few tiles along each axis: interior tiles take no reflection
    assert (h + 1) // 2 > th // 2 and (w + 1) // 2 > tw // 2
    x = _img(shape)
    got = TT.fwd2d_tiled(torch.from_numpy(x), mode, th, tw, name)
    want = RT.fwd2d_tiled(jnp.asarray(x), mode, th, tw, True, name)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = TT.inv2d_tiled(*got, mode, th, tw, name)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(RT.inv2d_tiled(*want, mode, th, tw, True, name))
    )
    np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("name", ["cdf53", "97m"])
def test_default_tile_pyramid_matches_reference(name, monkeypatch):
    """The public 2-D pyramid with the tile forced to the default: level 1
    of a (1, 255, 201) image is tiled in both packages."""
    x = _img((1, 255, 201))
    th, tw = _default_tile(name, 255, 201, monkeypatch)
    assert TK.plan_2d(255, 201, "cpu", name) == "tiled-torch"
    got = TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=2, mode="jpeg2000", scheme=name)
    want = RK.dwt_fwd_2d_multi(jnp.asarray(x), levels=2, mode="jpeg2000", scheme=name,
                               backend="interpret")
    leaves = [got.ll] + [b for lvl in got.details for b in lvl]
    ref = [want.ll] + [b for lvl in want.details for b in lvl]
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        TK.dwt_inv_2d_multi(got, mode="jpeg2000", scheme=name).numpy(), x)


@pytest.mark.parametrize("halo,tile", [(0, (128, 128)), (2, (128, 128)), (4, (124, 128))])
def test_default_tile_fits_a_third_of_an_sm(halo, tile):
    """The default tile's larger window (forward or inverse, with its
    alignment slack) leaves room for three blocks on an H100 SM; two more
    rows would not, unless the tile is already 128 rows tall."""
    assert TB.pick_tile(4096, 4096, halo) == tile
    share = TB.H100_SMEM_PER_SM // 3 - 1024
    th, tw = tile
    assert TB.tile_window_bytes(th, tw, halo // 2) <= share
    assert th == 128 or TB.tile_window_bytes(th + 2, tw, halo // 2) > share


def test_tile_window_bytes_counts_the_alignment_slack():
    # cdf53 forward: 132 rows of 134 columns (2 of slack before the
    # window) padded to 136; inverse: pairs from 3 past an aligned column,
    # 2 * 3 + 132 samples padded to 144
    assert TB.tile_window_bytes(128, 128, 1) == 132 * 144 * 4
    # haar: no halo, no slack
    assert TB.tile_window_bytes(128, 128, 0) == 128 * 128 * 4
    # tw / 2 odd: the offset varies by tile column; the worst one counts
    assert TB.tile_window_bytes(4, 6, 2) == 12 * 24 * 4
