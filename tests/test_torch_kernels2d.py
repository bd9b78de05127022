"""Port parity and policy of the 2-D kernel layer (``repro_torch.kernels``).

On the CPU every wrapper runs its kernel's plain PyTorch version; those
are held bit-exact against ``repro.kernels`` run the way its own tests run
it: ``backend="interpret"`` for the whole-image Pallas kernels, and
``REPRO_DWT_TILE`` plus ``backend="interpret"`` for the tiled ones.  The
CUDA kernels themselves need the card: ``tests/test_torch_cuda.py`` holds
them against the plain versions there and skips here.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import kernels as RK
from repro.core import lifting as RL
from repro.kernels import tiled2d as RT
from repro_torch import kernels as TK
from repro_torch.core import schemes as TS
from repro_torch.kernels import _build
from repro_torch.kernels import backend as TB
from repro_torch.kernels import fused2d as TF
from repro_torch.kernels import ops as TO
from repro_torch.kernels import tiled2d as TT

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)
RNG = np.random.default_rng(1010)


def _img(shape, lo=-1000, hi=1000):
    return RNG.integers(lo, hi, shape).astype(np.int32)


def _leaves(pyr):
    return [pyr.ll] + [b for lvl in pyr.details for b in lvl]


def _assert_pyr_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The whole 2-D path against the reference's Pallas kernels (interpret).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_pyramid_matches_reference_whole_image_kernels(name, mode):
    x = _img((2, 11, 14))
    got = TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=2, mode=mode, scheme=name)
    want = RK.dwt_fwd_2d_multi(jnp.asarray(x), levels=2, mode=mode, scheme=name,
                               backend="interpret")
    _assert_pyr_equal(got, want)
    y = TK.dwt_inv_2d_multi(got, mode=mode, scheme=name)
    np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["cdf53", "97m", "haar"])
def test_forced_multi_tile_grid_matches_reference_tiled_kernels(name, mode, monkeypatch):
    """REPRO_DWT_TILE forces the tiled engine in both packages."""
    monkeypatch.setenv("REPRO_DWT_TILE", "4")
    x = _img((1, 12, 16)) if name == "haar" else _img((1, 13, 9))
    h, w = x.shape[1:]
    assert TK.plan_2d(h, w, "cpu", name) == "tiled-torch"
    got = TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=2, mode=mode, scheme=name)
    want = RK.dwt_fwd_2d_multi(jnp.asarray(x), levels=2, mode=mode, scheme=name,
                               backend="interpret")
    _assert_pyr_equal(got, want)
    y = TK.dwt_inv_2d_multi(got, mode=mode, scheme=name)
    np.testing.assert_array_equal(
        y.numpy(),
        np.asarray(RK.dwt_inv_2d_multi(want, mode=mode, scheme=name, backend="interpret")),
    )
    np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("tile", [(4, 4), (6, 8), (8, 4)])
@pytest.mark.parametrize("mode", MODES)
def test_tiled_level_matches_reference_tiled_kernel(tile, mode):
    th, tw = tile
    x = _img((2, 15, 17))
    got = TT.fwd2d_tiled(torch.from_numpy(x), mode, th, tw)
    want = RT.fwd2d_tiled(jnp.asarray(x), mode, th, tw, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = TT.inv2d_tiled(*got, mode, th, tw)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(RT.inv2d_tiled(*want, mode, th, tw, True))
    )
    np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("hw", [(2, 2), (3, 3), (2, 9), (7, 4), (16, 16), (23, 19)])
def test_every_path_matches_the_oracle(hw, name, mode):
    """Whole and (where the scheme windows) tiled plain versions, at
    small tiles that make multi-tile grids, equal the reference oracle."""
    x = _img((2,) + hw)
    want = RL.dwt_fwd_2d(jnp.asarray(x), mode=mode, scheme=name)
    xt = torch.from_numpy(x)
    for got in [TF.fwd2d_whole(xt, mode, name)] + (
        [TT.fwd2d_tiled(xt, mode, 4, 6, name), TT.fwd2d_tiled(xt, mode, 8, 8, name)]
        if TS.get_scheme(name).can_window(hw[0]) and TS.get_scheme(name).can_window(hw[1])
        else []
    ):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(TF.inv2d_whole(*TF.fwd2d_whole(xt, mode, name), mode, name)
                                  .numpy(), x)


@settings(max_examples=12, deadline=None)
@given(
    h=st.integers(min_value=2, max_value=40),
    w=st.integers(min_value=2, max_value=40),
    th=st.sampled_from([4, 6, 8, 16]),
    tw=st.sampled_from([4, 6, 8, 16]),
    name=st.sampled_from(["cdf53", "97m"]),
    mode=st.sampled_from(MODES),
)
def test_tiled_plain_version_property(h, w, th, tw, name, mode):
    """Any tile grid over any shape: the tiled plain version equals the
    whole-image plain version (the oracle) and inverts exactly."""
    xt = torch.from_numpy(_img((1, h, w)))
    got = TT.fwd2d_tiled(xt, mode, th, tw, name)
    for a, b in zip(got, TF.fwd2d_whole(xt, mode, name)):
        assert torch.equal(a, b)
    assert torch.equal(TT.inv2d_tiled(*got, mode, th, tw, name), xt)


@pytest.mark.parametrize("val", [I32.min, I32.max])
@pytest.mark.parametrize("name", SCHEMES)
def test_plain_versions_wrap_int32_extremes_like_reference(val, name):
    x = np.full((1, 10, 12), val, np.int32)
    x[0, 1::4, ::3] = 3
    want = RL.dwt_fwd_2d(jnp.asarray(x), scheme=name)
    xt = torch.from_numpy(x)
    outs = [TF.fwd2d_whole(xt, "paper", name)]
    if TS.get_scheme(name).can_window(10) and TS.get_scheme(name).can_window(12):
        outs.append(TT.fwd2d_tiled(xt, "paper", 4, 4, name))
    for got in outs:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_window_math_matches_reference():
    for name in ("cdf53", "97m"):
        h = TS.get_scheme(name).halo
        w = _img((2, 8 + 2 * h, 6 + 2 * h))
        for a, b in zip(TT.fwd_window_math(torch.from_numpy(w), "paper", name),
                        RT.fwd_window_math(jnp.asarray(w), "paper", name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        m = TS.get_scheme(name).inv_margin
        bands = [_img((2, 3 + 2 * m, 4 + 2 * m)) for _ in range(4)]
        np.testing.assert_array_equal(
            TT.inv_window_math(*map(torch.from_numpy, bands), "jpeg2000", name).numpy(),
            np.asarray(RT.inv_window_math(*map(jnp.asarray, bands), "jpeg2000", name)),
        )


def test_single_level_api_and_lead_dims():
    x = _img((2, 3, 9, 10))
    got = TK.dwt_fwd_2d(torch.from_numpy(x), scheme="97m")
    want = RK.dwt_fwd_2d(jnp.asarray(x), scheme="97m", backend="interpret")
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(TK.dwt_inv_2d(got, scheme="97m").numpy(), x)
    with pytest.raises(ValueError):
        TK.dwt_fwd_2d(torch.zeros((4, 1), dtype=torch.int32))


def test_public_api_promotes_narrow_and_rejects_int64():
    x8 = RNG.integers(-128, 128, (9, 9)).astype(np.int8)
    got = TK.dwt_fwd_2d_multi(torch.from_numpy(x8), levels=2)
    _assert_pyr_equal(got, RK.dwt_fwd_2d_multi(jnp.asarray(x8), levels=2, backend="interpret"))
    assert got.ll.dtype == torch.int32
    with pytest.raises(TypeError, match="int64"):
        TK.dwt_fwd_2d_multi(torch.zeros((8, 8), dtype=torch.int64))
    assert TO._compute_dtype(torch.uint16) == torch.int32
    with pytest.raises(TypeError, match="int64"):
        TO._compute_dtype(torch.int64)
    with pytest.raises(TypeError):
        TO._compute_dtype(torch.float32)


def test_levels_zero_and_band_validation():
    x = _img((5, 7))
    pyr = TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=0)
    assert pyr.details == ()
    np.testing.assert_array_equal(TK.dwt_inv_2d_multi(pyr).numpy(), x)
    good = TK.dwt_fwd_2d_multi(torch.from_numpy(_img((8, 8))), levels=2)
    lh, hl, hh = good.details[0]
    bad = TK.Pyramid2D(ll=good.ll, details=((lh[:1], hl, hh),) + good.details[1:])
    with pytest.raises(ValueError, match="band shape mismatch"):
        TK.dwt_inv_2d_multi(bad)
    with pytest.raises(ValueError, match="mode"):
        TK.dwt_fwd_2d_multi(torch.from_numpy(x), mode="lossy")


# ---------------------------------------------------------------------------
# Dispatch policy, budgets, tiles.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "hw,name,plan",
    [
        ((2048, 2048), "cdf53", "tiled-torch"),
        ((256, 256), "cdf53", "tiled-torch"),  # 65536 samples > one block's smem
        ((128, 128), "cdf53", "whole-torch"),
        ((2048, 2048), "cdf22", "whole-torch"),  # never windows: no size cap
        ((301, 301), "haar", "whole-torch"),  # odd: haar cannot window
        ((300, 300), "haar", "tiled-torch"),
        ((2, 2), "97m", "whole-torch"),
    ],
)
def test_plan_2d_names_the_path(hw, name, plan):
    assert TK.plan_2d(*hw, "cpu", name) == plan


def test_tile_lever_keeps_reference_meaning(monkeypatch):
    assert not TB.tile_forced()
    assert TB.pick_tile(2048, 2048, 2) == (64, 64)  # from the H100 budget
    assert TB.pick_tile(9, 5, 4) == (10, 6)  # never wider than the image
    monkeypatch.setenv("REPRO_DWT_TILE", "6,8")
    assert TB.tile_forced()
    assert TB.pick_tile(2048, 2048, 2) == (6, 8)
    assert TK.plan_2d(16, 16, "cpu", "cdf53") == "tiled-torch"
    assert TK.plan_2d(16, 16, "cpu", "cdf22") == "whole-torch"
    monkeypatch.setenv("REPRO_DWT_TILE", "5")
    with pytest.raises(ValueError, match="even"):
        TB.pick_tile(16, 16)


def test_cpu_budgets_are_the_h100_figures():
    b = TB.budgets()
    assert b == {"smem_per_block": 232448, "smem_per_sm": 233472, "sms": 132}
    assert TB.whole_budget_elems() == 232448 // 4


def test_whole_geometry_stages_long_lines_in_global_memory():
    g = TF.whole_geometry(8, 128, 128)
    assert g == {"rb": 32, "row_global": 0, "cw": 32, "col_global": 0, "scratch": 0}
    g = TF.whole_geometry(1, 3000, 5)
    assert (g["cw"], g["col_global"]) == (16, 0)  # 3000 x 16 x 4 B fits
    g = TF.whole_geometry(2, 60001, 3)
    assert g["col_global"] == 1 and g["scratch"] == (1 + 1) * 2 * 60001 * 32
    g = TF.whole_geometry(1, 3, 60001)
    assert g["row_global"] == 1 and g["rb"] == 1 and g["scratch"] >= 3 * 60001


def test_cuda_device_is_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        TB.resolve_device("cuda")
    assert TB.resolve_device("cpu") == torch.device("cpu")
    assert TB.on_cuda(torch.zeros(1)) is False


def test_cascade_table_encodes_the_resolved_steps():
    t = _build.cascade_table("97m", "jpeg2000", inverse=False).tolist()
    assert t[0] == 4
    # first step: predict, sign -1, shift 1, no rounding, two taps of
    # weight 3 = -x + 4x (NAF digits (-1, +4))
    assert t[1:6] == [1, -1, 1, 0, 2]
    assert t[6:12] == [0, 2, 0, 1, 2, 0]
    inv = _build.cascade_table("cdf53", "jpeg2000", inverse=True).tolist()
    # inverse: the update runs first, sign flipped, jpeg2000 rounding +2
    assert inv[:6] == [2, 0, -1, 2, 2, 2]


# ---------------------------------------------------------------------------
# No hidden fallback: kernel wrappers refuse what the kernel cannot take.
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_cpu_tensors_and_wrong_dtypes():
    x32 = torch.zeros((1, 8, 8), dtype=torch.int32)
    x64 = torch.zeros((1, 8, 8), dtype=torch.int64)
    bands = TF._fwd2d_math(x32, "paper")
    with pytest.raises(ValueError, match="CUDA"):
        TF.fwd2d_whole_cuda(x32, "paper")
    with pytest.raises(ValueError, match="CUDA"):
        TT.fwd2d_tiled_cuda(x32, "paper", 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        TF.inv2d_whole_cuda(*bands, "paper")
    with pytest.raises(ValueError, match="CUDA"):
        TT.inv2d_tiled_cuda(*bands, "paper", 4, 4)
    for fn in (TF.fwd2d_whole_cuda, TF.fwd2d_whole):
        with pytest.raises(TypeError, match="int32"):
            fn(x64, "paper")
    with pytest.raises(TypeError, match="int32"):
        TT.fwd2d_tiled(x64, "paper", 4, 4)
    with pytest.raises(ValueError, match="window"):
        TT.fwd2d_tiled(x32, "paper", 4, 4, "cdf22")
    with pytest.raises(ValueError, match="even"):
        TT.fwd2d_tiled(x32, "paper", 5, 4)
    for fn in (TF.fwd2d_whole_cuda, TF.fwd2d_whole):
        with pytest.raises(ValueError, match="H>=2"):
            fn(torch.zeros((1, 1, 8), dtype=torch.int32), "paper")
    with pytest.raises(ValueError, match="mismatch"):
        TF.inv2d_whole(bands[0], bands[1][:, :1], bands[2], bands[3], "paper")


def test_plain_path_never_counts_a_launch():
    TK.launches.reset()
    TK.dwt_inv_2d_multi(TK.dwt_fwd_2d_multi(torch.from_numpy(_img((300, 300))), levels=3))
    assert TK.launches.snapshot() == {}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.library("tiled2d")
    assert not (tmp_path / "build").exists()
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build.build(["dwt53"])


def test_launch_raises_on_a_cuda_error_code(monkeypatch):
    class FakeLib:
        @staticmethod
        def repro_tiled_fwd(*args):
            return 9

        @staticmethod
        def repro_error_string(rc):
            return b"invalid configuration argument"

    monkeypatch.setattr(_build, "library", lambda name: FakeLib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0})())
    with pytest.raises(_build.KernelLaunchError, match="invalid configuration"):
        _build.launch("tiled2d", "repro_tiled_fwd", 0, [None], [1], np.zeros(1, np.int32))
    assert ctypes.sizeof(ctypes.c_void_p) == 8
