"""Port parity: ``repro_torch.core.schemes`` against ``repro.core.schemes``.

The same integer inputs, made with numpy from a seed, go through the JAX
reference and the torch port; every comparison is exact
(``np.testing.assert_array_equal``) — the transform is integer and
lossless, so any difference is a fault.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import schemes as RS
from repro_torch.core import schemes as TS

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)
RNG = np.random.default_rng(2011)


def _spec(sch):
    """The reference's steps as plain tuples (the cross-package form)."""
    return tuple(tuple(st) for st in sch.steps)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_registries_hold_the_same_schemes():
    assert TS.available_schemes() == RS.available_schemes()
    for name in RS.available_schemes():
        assert _spec(TS.get_scheme(name)) == _spec(RS.get_scheme(name))


@pytest.mark.parametrize("name", SCHEMES)
def test_scheme_from_spec_carries_derived_structure(name):
    ref = RS.get_scheme(name)
    port = TS.scheme_from_spec(name, _spec(ref))
    assert port.steps == TS.get_scheme(name).steps
    assert port.fwd_margin == ref.fwd_margin
    assert port.inv_margin == ref.inv_margin
    assert port.halo == ref.halo
    assert port.symmetric == ref.symmetric
    assert [port.can_window(n) for n in range(12)] == [ref.can_window(n) for n in range(12)]
    assert port.pair_op_counts() == ref.pair_op_counts()
    for mode in MODES:
        assert _spec_of(TS.resolved_steps(port, mode)) == _spec_of(RS.resolved_steps(ref, mode))


def _spec_of(steps):
    return tuple(tuple(st) for st in steps)


@pytest.mark.parametrize(
    "name,adders,shifters",
    [("cdf53", 4, 2), ("haar", 2, 1), ("cdf22", 5, 2), ("97m", 14, 10)],
)
def test_pair_op_counts_are_the_table2_ledger(name, adders, shifters):
    assert TS.get_scheme(name).pair_op_counts() == {
        "adders": adders, "shifters": shifters, "multipliers": 0,
    }


def test_scheme_from_spec_validates_like_register():
    with pytest.raises(ValueError, match="sign"):
        TS.scheme_from_spec("bad", [("predict", ((0, 1),), 1, 2)])
    with pytest.raises(ValueError, match="kind"):
        TS.scheme_from_spec("bad", [("lift", ((0, 1),), 1, 1)])
    with pytest.raises(ValueError, match="malformed"):
        TS.scheme_from_spec("bad", [("predict", (), 1, 1)])
    with pytest.raises(ValueError, match="unknown lifting scheme"):
        TS.get_scheme("db4")


@pytest.mark.parametrize("w", [0, 1, 2, 3, 5, 7, 11, 16, 23, -1, -3, -7])
def test_naf_and_wmul_match_reference(w):
    assert TS._naf(abs(w)) == RS._naf(abs(w))
    x = np.array([I32.min, I32.min + 1, -12345, -1, 0, 1, 98765, I32.max - 1, I32.max],
                 np.int32)
    _eq(TS.wmul(torch.from_numpy(x), w), RS.wmul(jnp.asarray(x), w))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 10])
def test_reflection_maps_match_reference(n):
    np.testing.assert_array_equal(TS.reflect_indices(-9, 30, n), RS.reflect_indices(-9, 30, n))
    if n < 2:
        return
    for parity in (0, 1):
        np.testing.assert_array_equal(
            TS.reflect_entries(-5, 16, parity, n), RS.reflect_entries(-5, 16, parity, n)
        )
        for p in range(-7, 12):
            assert TS.reflect_entry(p, parity, n) == RS.reflect_entry(p, parity, n)


def _data(shape, kind):
    if kind == "rand":
        return RNG.integers(-5000, 5000, shape).astype(np.int32)
    return np.full(shape, I32.min if kind == "min" else I32.max, np.int32)


@pytest.mark.parametrize("kind", ["rand", "min", "max"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_band_policy_axis_matches_reference(name, mode, kind):
    for shape, axis in [((3, 2), -1), ((2, 9), -1), ((11, 4), 0), ((4, 6, 8), 1)]:
        x = _data(shape, kind)
        s, d = TS.lift_fwd_axis(torch.from_numpy(x), name, axis=axis, mode=mode)
        rs, rd = RS.lift_fwd_axis(jnp.asarray(x), name, axis=axis, mode=mode)
        _eq(s, rs)
        _eq(d, rd)
        y = TS.lift_inv_axis(s, d, name, axis=axis, mode=mode)
        _eq(y, RS.lift_inv_axis(rs, rd, name, axis=axis, mode=mode))
        if kind == "rand":
            np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_extended_axis_matches_reference(name, mode):
    sch = TS.get_scheme(name)
    for axis in (-1, -2):
        x = _data((3, 2 * (6 + 2 * sch.fwd_margin), 2 * (6 + 2 * sch.fwd_margin)), "rand")
        s, d = TS.lift_fwd_axis_ext(torch.from_numpy(x), name, axis=axis, mode=mode)
        rs, rd = RS.lift_fwd_axis_ext(jnp.asarray(x), name, axis=axis, mode=mode)
        _eq(s, rs)
        _eq(d, rd)
        m = sch.inv_margin
        sx = _data((2, 5 + 2 * m, 5 + 2 * m), "rand")
        dx = _data((2, 5 + 2 * m, 5 + 2 * m), "rand")
        _eq(
            TS.lift_inv_axis_ext(torch.from_numpy(sx), torch.from_numpy(dx), name, axis=axis,
                                 mode=mode),
            RS.lift_inv_axis_ext(jnp.asarray(sx), jnp.asarray(dx), name, axis=axis, mode=mode),
        )


def test_too_short_axis_and_band_mismatch_raise_like_reference():
    with pytest.raises(ValueError, match="at least 2"):
        TS.lift_fwd_axis(torch.zeros((3, 1), dtype=torch.int32), "cdf53")
    with pytest.raises(ValueError, match="mismatch"):
        TS.lift_inv_axis(torch.zeros(5, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                         "cdf53")
    with pytest.raises(ValueError, match="mode"):
        TS.resolved_steps("cdf53", "lossy")


@settings(max_examples=15, deadline=None)
@given(
    n=st.integers(min_value=2, max_value=40),
    name=st.sampled_from(SCHEMES),
    mode=st.sampled_from(MODES),
    seed=st.integers(0, 2**31 - 1),
)
def test_axis_property_matches_reference(n, name, mode, seed):
    x = np.random.default_rng(seed).integers(-(1 << 24), 1 << 24, (2, n)).astype(np.int32)
    s, d = TS.lift_fwd_axis(torch.from_numpy(x), name, mode=mode)
    rs, rd = RS.lift_fwd_axis(jnp.asarray(x), name, mode=mode)
    _eq(s, rs)
    _eq(d, rd)
    np.testing.assert_array_equal(TS.lift_inv_axis(s, d, name, mode=mode).numpy(), x)
