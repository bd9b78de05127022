"""Port parity: the 2-D part of ``repro_torch.core.lifting`` (and its
oracle surface ``kernels/ref.py``) against ``repro.core.lifting``.

Same seeded numpy inputs through both packages, exact comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lifting as RL
from repro_torch.core import lifting as TL
from repro_torch.kernels import ref as TR

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)
RNG = np.random.default_rng(4059)


def _leaves_t(pyr):
    return [pyr.ll] + [b for lvl in pyr.details for b in lvl]


def _assert_pyr_equal(got, want):
    g, w = _leaves_t(got), _leaves_t(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("hw", [(2, 2), (3, 3), (2, 7), (9, 2), (8, 8), (13, 10), (17, 31)])
def test_fwd_inv_2d_match_reference(hw, name, mode):
    x = RNG.integers(-2000, 2000, (2,) + hw).astype(np.int32)
    got = TL.dwt_fwd_2d(torch.from_numpy(x), mode=mode, scheme=name)
    want = RL.dwt_fwd_2d(jnp.asarray(x), mode=mode, scheme=name)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = TL.dwt_inv_2d(got, mode=mode, scheme=name)
    np.testing.assert_array_equal(y.numpy(), np.asarray(RL.dwt_inv_2d(want, mode=mode, scheme=name)))
    np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_multi_level_matches_reference(name, mode):
    for hw, levels in [((19, 23), 3), ((16, 16), 4), ((5, 4), 2), ((6, 6), 0)]:
        x = RNG.integers(-128, 128, hw).astype(np.int32)
        got = TR.dwt_fwd_2d_multi(torch.from_numpy(x), levels=levels, mode=mode, scheme=name)
        want = RL.dwt_fwd_2d_multi(jnp.asarray(x), levels=levels, mode=mode, scheme=name)
        _assert_pyr_equal(got, want)
        assert got.levels == want.levels == levels
        y = TR.dwt_inv_2d_multi(got, mode=mode, scheme=name)
        np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("val", [I32.min, I32.max])
@pytest.mark.parametrize("name", SCHEMES)
def test_int32_extremes_wrap_like_reference(val, name):
    """iinfo edges: both packages wrap the same int32 bits."""
    x = np.full((2, 12, 10), val, np.int32)
    x[:, ::3, ::2] = -val - 1 if val == I32.max else 7
    for mode in MODES:
        got = TL.dwt_fwd_2d_multi(torch.from_numpy(x), levels=2, mode=mode, scheme=name)
        want = RL.dwt_fwd_2d_multi(jnp.asarray(x), levels=2, mode=mode, scheme=name)
        _assert_pyr_equal(got, want)
        y = TL.dwt_inv_2d_multi(got, mode=mode, scheme=name)
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(RL.dwt_inv_2d_multi(want, mode=mode, scheme=name))
        )


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.uint8, np.uint16])
def test_narrow_dtypes_promote_to_int32(dtype):
    info = np.iinfo(dtype)
    x = RNG.integers(info.min, info.max, (9, 14), endpoint=True).astype(dtype)
    t = torch.from_numpy(x.astype(np.int32)).to(getattr(torch, np.dtype(dtype).name))
    assert TL.promote_narrow(t).dtype == torch.int32
    got = TL.dwt_fwd_2d_multi(t, levels=2, scheme="97m")
    want = RL.dwt_fwd_2d_multi(jnp.asarray(x), levels=2, scheme="97m")
    assert got.ll.dtype == torch.int32 and want.ll.dtype == jnp.int32
    _assert_pyr_equal(got, want)


def test_int64_is_rejected_where_the_reference_narrows():
    """The pinned int64 decision: JAX (x64 disabled) narrows int64 input
    to int32 before lifting; the port refuses it rather than lift in a
    different width."""
    x = np.arange(64, dtype=np.int64).reshape(8, 8)
    assert RL.dwt_fwd_2d(jnp.asarray(x)).ll.dtype == jnp.int32  # narrowed
    with pytest.raises(TypeError, match="int64"):
        TL.dwt_fwd_2d(torch.from_numpy(x))
    with pytest.raises(TypeError, match="int64"):
        TL.promote_narrow(torch.from_numpy(x))


@pytest.mark.parametrize("dtype", [torch.uint32, torch.float32, torch.bool])
def test_wide_unsigned_and_non_integer_dtypes_are_rejected(dtype):
    with pytest.raises(TypeError):
        TL.promote_narrow(torch.zeros((4, 4), dtype=dtype))


def test_degenerate_shapes_raise_like_reference():
    x = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError):
        RL.dwt_fwd_2d(jnp.asarray(x))
    with pytest.raises(ValueError):
        TL.dwt_fwd_2d(torch.from_numpy(x))
    for mod in (RL, TL):
        with pytest.raises(ValueError, match="too small"):
            mod.check_levels_2d(4, 4, 3)
        with pytest.raises(ValueError, match=">= 0"):
            mod.check_levels_2d(4, 4, -1)


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (2, 2), (3, 5), (17, 31), (1024, 768)])
def test_band_geometry_matches_reference(hw):
    h, w = hw
    assert TL.max_levels_2d(h, w) == RL.max_levels_2d(h, w)
    for levels in range(TL.max_levels_2d(h, w) + 1):
        assert TL.band_shapes_2d(h, w, levels) == RL.band_shapes_2d(h, w, levels)


@pytest.mark.parametrize("name", SCHEMES)
def test_pack_unpack_2d_match_reference(name):
    x = RNG.integers(-99, 99, (3, 13, 11)).astype(np.int32)
    got = TL.dwt_fwd_2d_multi(torch.from_numpy(x), levels=3, scheme=name)
    want = RL.dwt_fwd_2d_multi(jnp.asarray(x), levels=3, scheme=name)
    flat = TL.pack2d(got)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(RL.pack2d(want)))
    _assert_pyr_equal(TL.unpack2d(flat, 13, 11, 3), RL.unpack2d(RL.pack2d(want), 13, 11, 3))


def test_pyramid_carries_both_ways():
    x = RNG.integers(-128, 128, (2, 21, 18)).astype(np.int32)
    want = RL.dwt_fwd_2d_multi(jnp.asarray(x), levels=3, scheme="97m", mode="jpeg2000")
    port = TL.Pyramid2D.from_numpy(want)  # reference pyramid -> torch
    assert isinstance(port.ll, torch.Tensor) and port.levels == 3
    _assert_pyr_equal(port, want)
    back = port.to_numpy()  # torch -> numpy -> reference inverse
    ref_pyr = RL.Pyramid2D(
        ll=jnp.asarray(back.ll),
        details=tuple(tuple(jnp.asarray(b) for b in lvl) for lvl in back.details),
    )
    np.testing.assert_array_equal(
        np.asarray(RL.dwt_inv_2d_multi(ref_pyr, scheme="97m", mode="jpeg2000")), x
    )
    np.testing.assert_array_equal(
        TL.dwt_inv_2d_multi(port, scheme="97m", mode="jpeg2000").numpy(), x
    )
