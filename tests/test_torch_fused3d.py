"""Port parity and policy of the N-D / 3-D volume engine (``kernels.fused3d``).

On the CPU every 3-D wrapper runs its kernel's plain PyTorch version;
those are held bit-exact against ``repro.kernels.dwt_fwd_nd`` /
``dwt_inv_nd`` run the way the reference's own tests run them:
``backend="interpret"`` for the whole-volume Pallas kernels, and
``REPRO_DWT_SLAB`` plus ``backend="interpret"`` for the depth-slab ones
(set in both packages, so both take their slab engines).  The CUDA
kernels themselves need the card: ``tests/test_torch_cuda.py`` holds them
against the plain versions there and skips here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import kernels as RK
from repro.core import lifting as RL
from repro.kernels import backend as RB
from repro_torch import kernels as TK
from repro_torch.core import lifting as TL
from repro_torch.core import schemes as TS
from repro_torch.kernels import _build
from repro_torch.kernels import backend as TB
from repro_torch.kernels import fused3d as T3

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)
RNG = np.random.default_rng(3030)


def _vol(shape, lo=-1000, hi=1000, dtype=np.int32):
    return RNG.integers(lo, hi, shape).astype(dtype)


def _leaves(pyr):
    return [pyr.approx] + [b for lvl in pyr.details for b in lvl]


def _assert_pyr_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _both(x, levels, mode, name, ndim=3, backend="interpret"):
    got = TK.dwt_fwd_nd(torch.from_numpy(x), levels=levels, mode=mode, scheme=name, ndim=ndim)
    want = RK.dwt_fwd_nd(jnp.asarray(x), levels=levels, mode=mode, scheme=name, ndim=ndim,
                         backend=backend)
    return got, want


# ---------------------------------------------------------------------------
# The 3-D path against the reference's Pallas kernels (interpret mode).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_pyramid_matches_reference_whole_volume_kernels(name, mode):
    x = _vol((2, 5, 9, 7))
    assert TK.plan_3d(5, 9, 7, "cpu", name) == "whole-torch"
    got, want = _both(x, 2, mode, name)
    _assert_pyr_equal(got, want)
    np.testing.assert_array_equal(TK.dwt_inv_nd(got, mode=mode, scheme=name).numpy(), x)
    # the reference's pyramid through the port's inverse, and back
    ref_in = TL.PyramidND.from_numpy(want, device="cpu")
    np.testing.assert_array_equal(TK.dwt_inv_nd(ref_in, mode=mode, scheme=name).numpy(),
                                  np.asarray(RK.dwt_inv_nd(want, mode=mode, scheme=name,
                                                           backend="interpret")))


@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("td,mode", [(2, "paper"), (4, "jpeg2000")])
def test_forced_slabs_match_reference_slab_kernels(td, mode, name, monkeypatch):
    """REPRO_DWT_SLAB forces the depth-slab engine in both packages; a
    scheme that cannot window the depth (cdf22, haar on odd D) stays on
    the whole-volume engine in both."""
    monkeypatch.setenv("REPRO_DWT_SLAB", str(td))
    x = _vol((1, 12, 6, 5)) if name == "haar" else _vol((1, 9, 6, 5))
    d, h, w = x.shape[1:]
    slabs = TS.get_scheme(name).can_window(d)
    assert TK.plan_3d(d, h, w, "cpu", name) == ("slab-torch" if slabs else "whole-torch")
    assert RK.plan_3d(d, h, w, "interpret", name).startswith("slab" if slabs else "whole")
    assert TB.pick_slab(d, h, w, TS.get_scheme(name).halo) == td
    got, want = _both(x, 2, mode, name)
    _assert_pyr_equal(got, want)
    np.testing.assert_array_equal(TK.dwt_inv_nd(got, mode=mode, scheme=name).numpy(), x)


@pytest.mark.parametrize("name,mode", [("cdf53", "paper"), ("97m", "jpeg2000"),
                                       ("haar", "paper")])
def test_slab_level_equals_reference_slab_kernel(name, mode):
    """One slab level called directly, at the tail-slab geometries (d_e
    not a multiple of TD/2), against the reference's kernel."""
    from repro.kernels import fused3d as R3

    x = _vol((2, 10, 7, 6)) if name == "haar" else _vol((2, 11, 7, 6))
    for td in (2, 8):  # eight: ceil(D/2) is not a whole number of slabs
        got = T3.fwd3d_slab(torch.from_numpy(x), mode, td, name)
        want = R3.fwd3d_slab(jnp.asarray(x), mode, td, True, scheme=name)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        back = T3.inv3d_slab(got, mode, td, name)
        ref = R3.inv3d_slab(tuple(want), mode, td, True, scheme=name)
        np.testing.assert_array_equal(back.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(back.numpy(), x)


def test_whole_level_equals_reference_whole_volume_kernel():
    from repro.kernels import fused3d as R3

    x = _vol((3, 4, 5, 6))
    for name in SCHEMES:
        got = T3.fwd3d_whole(torch.from_numpy(x), "jpeg2000", name)
        want = R3._fwd3d_pallas(jnp.asarray(x), scheme=TS.get_scheme(name).name,
                                mode="jpeg2000", interpret=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        back = T3.inv3d_whole(got, "jpeg2000", name)
        np.testing.assert_array_equal(back.numpy(), x)


# ---------------------------------------------------------------------------
# Shapes, dtypes, ranks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape", [(2, 2, 2), (3, 2, 5), (2, 3, 2), (7, 3, 3), (3, 11, 2), (6, 4, 9), (13, 5, 3)]
)
def test_odd_and_degenerate_shapes_equal_the_reference(shape):
    x = _vol((1,) + shape)
    levels = TL.max_levels_nd(shape)
    for name, mode in zip(SCHEMES, MODES * 2):
        got, want = _both(x, levels, mode, name, backend="xla")
        _assert_pyr_equal(got, want)
        np.testing.assert_array_equal(TK.dwt_inv_nd(got, mode=mode, scheme=name).numpy(), x)


def test_lead_dims_and_int32_extremes():
    x = _vol((2, 3, 6, 10, 12))
    for name in SCHEMES:
        got, want = _both(x, 2, "paper", name, backend="xla")
        _assert_pyr_equal(got, want)
        assert tuple(got.approx.shape) == (2, 3, 2, 3, 3)
        np.testing.assert_array_equal(TK.dwt_inv_nd(got, scheme=name).numpy(), x)
    for val in (I32.min, I32.max):
        x = np.full((2, 5, 6, 7), val, np.int32)
        for name in SCHEMES:
            got, want = _both(x, 1, "jpeg2000", name, backend="xla")
            _assert_pyr_equal(got, want)


@pytest.mark.parametrize("dt", [np.int8, np.int16, np.uint8, np.uint16])
def test_narrow_dtypes_promote_and_int64_is_refused(dt):
    info = np.iinfo(dt)
    x = RNG.integers(info.min, info.max, (2, 6, 5, 7), endpoint=True).astype(dt)
    x[0, 0, 0, :2] = info.min, info.max
    got, want = _both(x, 2, "jpeg2000", "97m", backend="xla")
    assert got.approx.dtype == torch.int32
    _assert_pyr_equal(got, want)
    np.testing.assert_array_equal(TK.dwt_inv_nd(got, mode="jpeg2000", scheme="97m").numpy(),
                                  x.astype(np.int32))
    with pytest.raises(TypeError, match="int64"):
        TK.dwt_fwd_nd(torch.zeros((4, 4, 4), dtype=torch.int64))
    with pytest.raises(TypeError, match="int32"):
        T3.fwd3d_whole(torch.zeros((1, 4, 4, 4), dtype=torch.int64), "paper")


@settings(max_examples=25, deadline=None)
@given(
    d=st.integers(2, 9), h=st.integers(2, 9), w=st.integers(2, 9),
    name=st.sampled_from(SCHEMES), mode=st.sampled_from(MODES), td=st.sampled_from([2, 4, 6]),
    seed=st.integers(0, 2**31 - 1),
)
def test_slab_and_whole_plain_versions_property(d, h, w, name, mode, td, seed):
    """The slab plain version equals the whole-volume one (the oracle)
    wherever the depth windows; both invert exactly."""
    x = torch.from_numpy(np.random.default_rng(seed).integers(-(1 << 20), 1 << 20, (2, d, h, w))
                         .astype(np.int32))
    want = T3.fwd3d_whole_plain(x, mode, name)
    assert torch.equal(T3.inv3d_whole_plain(want, mode, name), x)
    if TS.get_scheme(name).can_window(d):
        for a, b in zip(T3.fwd3d_slab_plain(x, mode, td, name), want):
            assert torch.equal(a, b)
        assert torch.equal(T3.inv3d_slab_plain(want, mode, td, name), x)


@pytest.mark.parametrize("ndim,name", [(1, "97m"), (2, "cdf22"), (3, "haar"), (4, "cdf53")])
def test_oracle_and_kernel_entry_equal_the_reference_at_every_rank(ndim, name):
    shape = {1: (3, 13), 2: (2, 7, 9), 3: (2, 5, 4, 6), 4: (2, 4, 3, 3)}[ndim]
    x = _vol(shape)
    levels = TL.max_levels_nd(shape[-ndim:])
    if True:
        want = RL.dwt_fwd_nd(jnp.asarray(x), levels=levels, mode="jpeg2000", scheme=name,
                             ndim=ndim)
        got = TL.dwt_fwd_nd(torch.from_numpy(x), levels=levels, mode="jpeg2000", scheme=name,
                            ndim=ndim)
        _assert_pyr_equal(got, want)
        _assert_pyr_equal(TK.dwt_fwd_nd(torch.from_numpy(x), levels=levels, mode="jpeg2000",
                                        scheme=name, ndim=ndim), want)
        back = RL.dwt_inv_nd(want, mode="jpeg2000", scheme=name)
        np.testing.assert_array_equal(TL.dwt_inv_nd(got, mode="jpeg2000", scheme=name).numpy(),
                                      np.asarray(back))
        np.testing.assert_array_equal(TK.dwt_inv_nd(got, mode="jpeg2000", scheme=name).numpy(),
                                      x)


def test_levels_zero_is_the_identity_pyramid():
    x = _vol((2, 4, 4, 4), dtype=np.int16)
    for fn in (TK.dwt_fwd_nd, TL.dwt_fwd_nd):
        pyr = fn(torch.from_numpy(x), levels=0)
        assert pyr.details == () and pyr.approx.dtype == torch.int32
        np.testing.assert_array_equal(TK.dwt_inv_nd(pyr).numpy(), x)


def test_pack_unpack_equal_the_reference():
    x = _vol((2, 7, 6, 5))
    got, want = _both(x, 2, "paper", "cdf53", backend="xla")
    flat = TK.pack_nd(got)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(RL.pack_nd(want)))
    back = TK.unpack_nd(flat, (7, 6, 5), 2)
    _assert_pyr_equal(back, want)
    assert TK.band_shapes_nd((7, 6, 5), 2) == RL.band_shapes_nd((7, 6, 5), 2)
    ident = TK.dwt_fwd_nd(torch.from_numpy(x), levels=0)
    with pytest.raises(ValueError, match="pass ndim explicitly"):
        TK.pack_nd(ident)
    assert TK.pack_nd(ident, ndim=3).shape == (2, 7 * 6 * 5)
    with pytest.raises(ValueError, match="ndim=2 but pyramid has ndim=3"):
        TK.pack_nd(got, ndim=2)


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_value_errors_match_the_reference():
    x = _vol((2, 4, 5, 6))
    tx, rx = torch.from_numpy(x), jnp.asarray(x)
    for kw in (dict(ndim=0), dict(ndim=5), dict(levels=-1), dict(levels=3)):
        assert _message(lambda: TK.dwt_fwd_nd(tx, **kw)) == \
            _message(lambda: RK.dwt_fwd_nd(rx, **kw))
    got, want = _both(x, 2, "paper", "cdf53", backend="xla")
    bad_t = TL.PyramidND(approx=got.approx, details=((got.details[0][0],) * 7,) + got.details[1:])
    bad_r = RL.PyramidND(approx=want.approx,
                         details=((want.details[0][0],) * 7,) + tuple(want.details[1:]))
    assert _message(lambda: TK.dwt_inv_nd(bad_t)) == _message(lambda: RK.dwt_inv_nd(bad_r))
    six = TL.PyramidND(approx=got.approx, details=(got.details[0][:6],))
    assert "2**ndim - 1" in _message(lambda: TK.dwt_inv_nd(six))
    with pytest.raises(ValueError, match="mismatch"):
        T3.inv3d_whole(list(T3.fwd3d_whole_plain(tx, "paper"))[:7] + [tx[:, :1]], "paper")
    with pytest.raises(ValueError, match="D>=2"):
        T3.fwd3d_whole(torch.zeros((1, 1, 4, 4), dtype=torch.int32), "paper")
    with pytest.raises(ValueError, match="even"):
        T3.fwd3d_slab(tx, "paper", 3)
    with pytest.raises(ValueError, match="window"):
        T3.fwd3d_slab(tx, "paper", 2, "cdf22")


# ---------------------------------------------------------------------------
# Dispatch policy, budgets, plan names.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dhw,name,plan",
    [
        ((64, 512, 512), "cdf53", "slab-torch"),
        ((32, 256, 256), "cdf53", "slab-torch"),
        ((16, 128, 128), "97m", "slab-torch"),
        ((8, 64, 64), "cdf53", "whole-torch"),
        ((64, 512, 512), "cdf22", "whole-torch"),
        ((65, 512, 512), "haar", "whole-torch"),
        ((64, 512, 512), "haar", "slab-torch"),
        ((5, 9, 7), "cdf53", "whole-torch"),
    ],
)
def test_plan_3d_names_the_path(dhw, name, plan):
    assert TK.plan_3d(*dhw, "cpu", name) == plan


def test_slab_lever_keeps_reference_meaning(monkeypatch):
    assert TB.whole3d_budget_elems() == 232448 // 4
    assert not TB.slab_forced()
    td = TB.pick_slab(64, 512, 512, 2)
    assert td % 2 == 0 and td >= 2 and (td + 4) * 32 * 4 <= 233472 // 4
    assert TB.pick_slab(5, 9, 7, 4) == 6  # never deeper than the volume (odd rounds up)
    monkeypatch.setenv("REPRO_DWT_SLAB", "4")
    assert TB.slab_forced() and TB.pick_slab(64, 512, 512, 2) == 4
    assert TK.plan_3d(5, 9, 7, "cpu") == "slab-torch"
    for bad in ("3", "0", "x"):
        monkeypatch.setenv("REPRO_DWT_SLAB", bad)
        with pytest.raises(ValueError) as got:
            TB.pick_slab(8, 8, 8)
        with pytest.raises(ValueError) as want:
            RB.pick_slab(8, 8, 8)
        assert str(got.value) == str(want.value)


def test_volume_geometry_one_block_or_three_passes():
    g = T3.volume_geometry(4, 8, 64, 64)
    assert g["fused"] == 1
    g = T3.volume_geometry(4, 64, 512, 512)
    assert g["fused"] == 0 and g["cw_h"] == 32 and g["cw_d"] == 32 and g["scratch"] == 0
    g = T3.volume_geometry(1, 60001, 3, 2)  # a depth line longer than shared memory
    assert g["cw_d"] == 0 and g["scratch"] == 60001 * 32 * 4
    g = T3.volume_geometry(1, 2, 2, 60001)  # a row longer than shared memory
    assert g["row_global"] == 1 and g["scratch"] >= 4 * 60001


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize(
    "name,dhw,passes",
    [
        ("cdf53", (64, 512, 512), 2),  # the main path: the fused plane pass
        ("97m", (64, 512, 512), 2),
        ("cdf53", (32, 256, 256), 2),
        ("97m", (5, 3, 7), 2),  # a window taller than the slice reflects
        ("cdf53", (2, 2, 2), 2),
        ("haar", (64, 512, 512), 2),
        ("haar", (8, 9, 16), 3),  # haar cannot window an odd H
        ("cdf53", (3, 5, 60001), 3),  # rows too wide for one block's window
        ("97m", (3, 5, 60001), 3),
    ],
)
def test_slab_level_is_two_passes_where_the_plane_pass_applies(name, dhw, passes, inverse):
    """The plane-pass choice comes from the shape and the H100's figures
    alone, so the CPU sees the card's choice: R rows whose R + 4m window
    fits a third of an SM, never past H; otherwise the row and column
    passes."""
    sch = TS.get_scheme(name)
    d, h, w = dhw
    td = TB.pick_slab(d, h, w, sch.halo)
    g = T3.slab_geometry(4, d, h, w, td, name, inverse)
    m = sch.inv_margin if inverse else sch.fwd_margin
    assert g["m"] == m and g["passes"] == passes
    rows = g["plane_rows"]
    assert (rows > 0) == (passes == 2)
    if rows:
        assert rows % 2 == 0 and rows <= h + h % 2
        assert (rows + 4 * m) * w * 4 <= 233472 // 3 - 1024
        assert rows == h + h % 2 or (rows + 2 + 4 * m) * w * 4 > 233472 // 3 - 1024
        assert g["scratch"] == 0
    else:
        assert g["rb"] >= 1 and g["cw_h"] >= 0
    assert g["cw_s"] in (32, 64, 128) and (td + 4 * m) * g["cw_s"] * 4 <= 233472 // 4
    if dhw == (64, 512, 512) and name != "haar":
        assert rows >= 28  # the halo re-read stays under 30% of the plane pass
    if dhw == (3, 5, 60001):
        assert g["row_global"] == 1 and g["scratch"] >= 4 * 5 * 3 * 60001


def test_plane_rows_and_slab_strip_budgets():
    assert TB.plane_rows(512, 512, 1, True) == 32
    assert TB.plane_rows(512, 512, 2, True) == 28
    assert TB.plane_rows(512, 512, 1, False) == 0  # the scheme cannot window H
    assert TB.plane_rows(9, 16, 0, True) == 10  # never past H (odd rounds up)
    assert TB.plane_rows(64, 2000, 1, True) == 0  # fewer than 8 rows fit
    assert TB.plane_rows(4, 2000, 1, True) == 4  # ... unless H itself is shorter
    assert TB.slab_strip(68) == 128 and TB.slab_strip(460) == 32
    assert TB.slab_strip(2000) == 16 and TB.slab_strip(60000) == 0


def test_plan_3d_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        TK.plan_3d(8, 8, 8)


def test_kernel_wrappers_refuse_cpu_tensors_and_count_no_plain_launch():
    x = torch.zeros((1, 4, 4, 4), dtype=torch.int32)
    bands = T3.fwd3d_whole_plain(x, "paper")
    for fn in (lambda: T3.fwd3d_whole_cuda(x, "paper"), lambda: T3.inv3d_whole_cuda(bands, "paper"),
               lambda: T3.fwd3d_slab_cuda(x, "paper", 2),
               lambda: T3.inv3d_slab_cuda(bands, "paper", 2)):
        with pytest.raises(ValueError, match="CUDA"):
            fn()
    TK.launches.reset()
    TK.dwt_inv_nd(TK.dwt_fwd_nd(torch.from_numpy(_vol((70, 60, 40))), levels=3))
    assert TK.launches.snapshot() == {}


def test_both_3d_sources_are_registered_with_their_c_signatures():
    """Every exported launcher of whole3d.cu and slab3d.cu takes exactly
    the arguments its ctypes signature passes (ctypes would not notice)."""
    import re

    for name in ("whole3d", "slab3d"):
        assert name in _build.SOURCES
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in _build._SIGNATURES[name].items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
            assert m, fn
            params = [p.strip() for p in m.group(1).split(",")]
            assert len(params) == len(argtypes), fn
            for p, t in zip(params, argtypes):
                assert ("*" in p) == (t is _build._P), (fn, p)
