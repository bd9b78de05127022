"""Port parity of the 1-D library transform (``repro_torch.kernels`` 1-D).

On the CPU every wrapper runs its kernel's plain PyTorch version: the
windowed level (``kernels/dwt53.py``) and the row-pass fallback.  The
same seeded numpy inputs go through ``repro.kernels`` run the way its
own tests run it — ``backend="interpret"`` for the Pallas window
kernels, ``backend="xla"`` for the oracle under jit — and every result
must be equal exactly.  The CUDA kernels themselves need the card:
``tests/test_torch_cuda.py`` holds them against these plain versions
there and skips here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import kernels as RK
from repro.core import lifting as RL
from repro.core import schemes as RS
from repro.kernels import dwt53 as RD
from repro.kernels import ops as RO
from repro_torch import kernels as TK
from repro_torch.core import lifting as TL
from repro_torch.core import schemes as TS
from repro_torch.kernels import backend as TB
from repro_torch.kernels import dwt53 as TD
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TREF

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)


def _rng(*key):
    return np.random.default_rng([len(str(k)) + 31 * i for i, k in enumerate(key)] + [7])


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _eq_pyr(got, want) -> None:
    assert len(got.details) == len(want.details)
    _eq(got.approx, want.approx)
    for g, w in zip(got.details, want.details):
        _eq(g, w)


# ---------------------------------------------------------------------------
# One level: every length 2..40 and long odd lines, against the oracle
# (xla) for the forward; the inverse must give the input back.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_one_level_equals_the_reference_for_every_length(name, mode):
    rng = _rng(name, mode)
    for n in list(range(2, 41)) + [1001, 1003]:
        rows = (1, 3, 9)[n % 3]
        x = rng.integers(-(1 << 20), 1 << 20, (rows, n)).astype(np.int32)
        s, d = TK.dwt_fwd_1d(torch.from_numpy(x), mode=mode, scheme=name)
        rs, rd = RK.dwt_fwd_1d(jnp.asarray(x), mode=mode, scheme=name, backend="xla")
        _eq(s, rs)
        _eq(d, rd)
        _eq(TK.dwt_inv_1d(s, d, mode=mode, scheme=name), x)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_pallas_window_kernels_agree_with_the_port(name, mode):
    """The reference's Pallas path in interpret mode: one level of a
    windowed length and of a short one, a 3-level pyramid of a long odd
    line, and the inverse of arbitrary (not forward-made) bands."""
    rng = _rng("interpret", name, mode)
    x = rng.integers(-4096, 4096, (3, 1001)).astype(np.int32)
    for n in (17, 1001):
        s, d = TK.dwt_fwd_1d(torch.from_numpy(x[:, :n]), mode=mode, scheme=name)
        rs, rd = RK.dwt_fwd_1d(jnp.asarray(x[:, :n]), mode=mode, scheme=name,
                               backend="interpret")
        _eq(s, rs)
        _eq(d, rd)
    got = TK.dwt_fwd(torch.from_numpy(x), levels=3, mode=mode, scheme=name)
    want = RK.dwt_fwd(jnp.asarray(x), levels=3, mode=mode, scheme=name, backend="interpret")
    _eq_pyr(got, want)
    bands = TL.WaveletPyramid(
        approx=torch.from_numpy(rng.integers(-9000, 9000, (3, 126)).astype(np.int32)),
        details=tuple(torch.from_numpy(rng.integers(-9000, 9000, (3, k)).astype(np.int32))
                      for k in (125, 250, 500)),
    )
    _eq(TK.dwt_inv(bands, mode=mode, scheme=name),
        RK.dwt_inv(RL.WaveletPyramid(approx=jnp.asarray(bands.approx.numpy()),
                                     details=tuple(jnp.asarray(d.numpy()) for d in bands.details)),
                   mode=mode, scheme=name, backend="interpret"))


# ---------------------------------------------------------------------------
# Multi-level pyramids.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_every_level_count_equals_the_reference(name, mode):
    rng = _rng("levels", name, mode)
    for n in (2, 5, 16, 67, 1003):
        assert TK.max_levels(n) == RL.max_levels(n)
        x = rng.integers(-30000, 30000, (2, 3, n)).astype(np.int32)  # leading dims
        for levels in sorted({0, 1, TK.max_levels(n) // 2, TK.max_levels(n)}):
            got = TK.dwt_fwd(torch.from_numpy(x), levels=levels, mode=mode, scheme=name)
            want = RK.dwt_fwd(jnp.asarray(x), levels=levels, mode=mode, scheme=name,
                              backend="xla")
            _eq_pyr(got, want)
            _eq(TK.dwt_inv(got, mode=mode, scheme=name), x)
            _eq_pyr(got, TREF.dwt_fwd(torch.from_numpy(x), levels=levels, mode=mode,
                                      scheme=name))


@settings(max_examples=20, deadline=None)
@given(
    n=st.integers(2, 300),
    rows=st.integers(1, 4),
    name=st.sampled_from(SCHEMES),
    mode=st.sampled_from(MODES),
    seed=st.integers(0, 2**16),
)
def test_pyramid_property_equals_the_oracle(n, rows, name, mode, seed):
    x = np.random.default_rng(seed).integers(I32.min, I32.max, (rows, n), dtype=np.int64)
    xt = torch.from_numpy(x.astype(np.int32))
    levels = TK.max_levels(n)
    got = TK.dwt_fwd(xt, levels=levels, mode=mode, scheme=name)
    want = TL.dwt_fwd(xt, levels=levels, mode=mode, scheme=name)
    assert torch.equal(got.approx, want.approx)
    assert all(torch.equal(a, b) for a, b in zip(got.details, want.details))
    assert torch.equal(TK.dwt_inv(got, mode=mode, scheme=name), xt)


# ---------------------------------------------------------------------------
# Dtypes.
# ---------------------------------------------------------------------------

_DTYPES = [
    (np.int8, -128, 127),
    (np.int16, -32768, 32767),
    (np.uint8, 0, 255),
    (np.uint16, 0, 65535),
    (np.int32, int(I32.min), int(I32.max)),
]


@pytest.mark.parametrize("dt,lo,hi", _DTYPES, ids=lambda v: getattr(v, "__name__", None))
def test_every_accepted_dtype_with_extremes_equals_the_reference(dt, lo, hi):
    rng = _rng("dtype", dt.__name__)
    for name in SCHEMES:
        x = rng.integers(lo, hi, (3, 70), endpoint=True).astype(dt)
        x[0, :9] = lo
        x[1, :9] = hi
        x[2, ::2] = lo
        x[2, 1::2] = hi
        got = TK.dwt_fwd(torch.from_numpy(x), levels=2, scheme=name, mode="jpeg2000")
        want = RK.dwt_fwd(jnp.asarray(x), levels=2, scheme=name, mode="jpeg2000", backend="xla")
        _eq_pyr(got, want)  # int32 bands from every narrow dtype
        s, d = TK.dwt_fwd_1d(torch.from_numpy(x), scheme=name)
        rs, rd = RK.dwt_fwd_1d(jnp.asarray(x), scheme=name, backend="xla")
        _eq(s, rs)
        _eq(d, rd)
        back = TK.dwt_inv(got, scheme=name, mode="jpeg2000")
        _eq(back, np.asarray(RK.dwt_inv(want, scheme=name, mode="jpeg2000", backend="xla")))
        _eq(back, x.astype(np.int32))
    # int32 extremes wrap exactly as the reference's int32 does
    ext = np.full((2, 40), I32.max, np.int32)
    ext[1] = I32.min
    for name in SCHEMES:
        s, d = TK.dwt_fwd_1d(torch.from_numpy(ext), scheme=name)
        rs, rd = RK.dwt_fwd_1d(jnp.asarray(ext), scheme=name, backend="interpret")
        _eq(s, rs)
        _eq(d, rd)


def test_rejected_dtypes():
    x = torch.arange(32, dtype=torch.int64).reshape(2, 16)
    with pytest.raises(TypeError, match="int64"):
        TK.dwt_fwd(x)
    with pytest.raises(TypeError, match="int64"):
        TK.dwt_inv_1d(x[:, :8], x[:, 8:])
    with pytest.raises(TypeError):
        TK.dwt_fwd_1d(x.float())
    with pytest.raises(TypeError):
        TK.dwt_fwd(x.to(torch.uint32))
    with pytest.raises(TypeError, match="int64"):  # the oracle refuses it too
        TL.dwt_fwd(x)


# ---------------------------------------------------------------------------
# Packing, checks, aliases.
# ---------------------------------------------------------------------------


def test_pack_unpack_equal_the_reference():
    rng = _rng("pack")
    for n, levels in ((2, 1), (37, 3), (1000, 5), (9, 0)):
        x = rng.integers(-500, 500, (2, n)).astype(np.int32)
        got = TK.dwt_fwd(torch.from_numpy(x), levels=levels)
        want = RK.dwt_fwd(jnp.asarray(x), levels=levels, backend="xla")
        flat = TK.pack(got)
        _eq(flat, RL.pack(want))
        assert TK.band_sizes(n, levels) == RL.band_sizes(n, levels)
        _eq_pyr(TK.unpack(flat, n, levels), RL.unpack(RL.pack(want), n, levels))
        _eq(TK.dwt_inv(TK.unpack(flat, n, levels)), x)


def test_value_errors_match_the_reference():
    x = torch.zeros((2, 1), dtype=torch.int32)
    rx = jnp.zeros((2, 1), jnp.int32)
    for port, ref in (
        (lambda: TK.dwt_fwd_1d(x), lambda: RK.dwt_fwd_1d(rx, backend="xla")),
        (lambda: TK.dwt_fwd(torch.zeros((3, 5), dtype=torch.int32), levels=4),
         lambda: RK.dwt_fwd(jnp.zeros((3, 5), jnp.int32), levels=4, backend="xla")),
        (lambda: TK.dwt_fwd(x, levels=-1), lambda: RK.dwt_fwd(rx, levels=-1, backend="xla")),
        (lambda: TK.dwt_inv_1d(torch.zeros((2, 5), dtype=torch.int32),
                               torch.zeros((2, 3), dtype=torch.int32)),
         lambda: RK.dwt_inv_1d(jnp.zeros((2, 5), jnp.int32), jnp.zeros((2, 3), jnp.int32),
                               backend="xla")),
    ):
        with pytest.raises(ValueError) as want:
            ref()
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(want.value)
    # a malformed pyramid raises before any level runs, on every engine
    good = TK.dwt_fwd(torch.zeros((2, 64), dtype=torch.int32), levels=3)
    for bad in (
        TL.WaveletPyramid(approx=good.approx, details=(good.details[0][..., :-2],) + good.details[1:]),
        TL.WaveletPyramid(approx=good.approx, details=good.details[::-1]),
    ):
        rbad = RL.WaveletPyramid(approx=jnp.asarray(bad.approx.numpy()),
                                 details=tuple(jnp.asarray(d.numpy()) for d in bad.details))
        with pytest.raises(ValueError, match="band length mismatch") as want:
            RK.dwt_inv(rbad, backend="interpret")
        with pytest.raises(ValueError, match="band length mismatch") as got:
            TK.dwt_inv(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="lead dims"):
        TK.dwt_inv_1d(torch.zeros((2, 8), dtype=torch.int32), torch.zeros((3, 8), dtype=torch.int32))


def test_aliases_and_empty_rows():
    x = torch.from_numpy(_rng("alias").integers(-99, 99, (2, 50)).astype(np.int32))
    assert all(torch.equal(a, b) for a, b in zip(TK.dwt53_fwd_1d(x, mode="jpeg2000"),
                                                 TK.dwt_fwd_1d(x, mode="jpeg2000")))
    assert torch.equal(TK.dwt53_inv_1d(*TK.dwt53_fwd_1d(x)), x)
    assert torch.equal(TK.dwt53_inv(TK.dwt53_fwd(x, levels=3)), x)
    assert torch.equal(TREF.dwt53_inv(TREF.dwt53_fwd(x, levels=3)), x)
    s, d = TL.dwt53_fwd_1d(x)
    ev, od = x[..., 0::2], x[..., 1::2]
    nxt = torch.cat([ev[..., 1:], ev[..., -1:]], dim=-1)
    assert torch.equal(d, TL.predict(ev, nxt, od))  # eq. (5) on the interior
    dp = torch.cat([d[..., :1], d[..., :-1]], dim=-1)
    assert torch.equal(s, TL.update(ev, d, dp))
    assert torch.equal(TL.inv_update(s, d, dp), ev)
    empty = TK.dwt_fwd(torch.zeros((0, 40), dtype=torch.int32), levels=2)
    assert empty.approx.shape == (0, 10) and [tuple(d.shape) for d in empty.details] == [
        (0, 10), (0, 20)]
    assert TK.dwt_inv(empty).shape == (0, 40)


# ---------------------------------------------------------------------------
# The windowed engine's plain versions and its dispatch.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cdf53", "97m", "haar"])
def test_window_bodies_equal_the_reference_kernels_on_gathered_windows(name):
    """The port's kernel bodies on the reference's own gathered windows
    give what ``repro.kernels.dwt53.lift_fwd_windows`` / ``lift_inv_windows``
    give (Pallas, interpret mode), and the port's index maps are the ones
    ``ops._fwd_level`` / ``_inv_level`` build."""
    sch, rsch = TS.get_scheme(name), RK.get_scheme(name)
    rng = _rng("windows", name)
    n, bp, rows = 90, 8, 8
    x = rng.integers(-5000, 5000, (rows, n)).astype(np.int32)
    idx = TD.fwd_window_index(n, bp, sch.halo)
    want_idx = np.stack([RS.reflect_indices(2 * t * bp - rsch.halo, 2 * bp + 2 * rsch.halo, n)
                         for t in range(-(-(n - n // 2) // bp))])
    np.testing.assert_array_equal(idx, want_idx)
    wins = x[:, idx]
    for mode in MODES:
        rs, rd = RD.lift_fwd_windows(jnp.asarray(wins), scheme=rsch, mode=mode, block_rows=8,
                                     block_pairs=bp, interpret=True)
        s, d = TD.fwd_windows_math(torch.from_numpy(wins), mode, sch)
        _eq(s, rs)
        _eq(d, rd)
        band_s = rng.integers(-5000, 5000, (rows, n - n // 2)).astype(np.int32)
        band_d = rng.integers(-5000, 5000, (rows, n // 2)).astype(np.int32)
        i_s, i_d = TD.inv_window_index(n, bp, sch.inv_margin)
        want = RD.lift_inv_windows(jnp.asarray(band_s[:, i_s]), jnp.asarray(band_d[:, i_d]),
                                   scheme=rsch, mode=mode, block_rows=8, block_pairs=bp,
                                   interpret=True)
        got = TD.inv_windows_math(torch.from_numpy(band_s[:, i_s]),
                                  torch.from_numpy(band_d[:, i_d]), mode, sch)
        _eq(got, want)
        # the plain level = gather + body + crop = the oracle, at any tile size
        for bp_ in (1, 3, 8, 64):
            s2, d2 = TD.lift_fwd_windows(torch.from_numpy(x), mode, 1, bp_, sch)
            s3, d3 = TL.dwt_fwd_1d(torch.from_numpy(x), mode=mode, scheme=sch)
            assert torch.equal(s2, s3) and torch.equal(d2, d3)
            assert torch.equal(TD.lift_inv_windows(s2, d2, mode, 1, bp_, sch),
                               torch.from_numpy(x))


@pytest.mark.parametrize(
    "n,name,plan",
    [(16, "cdf53", "windowed-torch"), (15, "cdf53", "rows-torch"), (17, "97m", "windowed-torch"),
     (64, "cdf22", "policy-torch"), (64, "haar", "windowed-torch"), (65, "haar", "policy-torch"),
     (3, "97m", "rows-torch")],
)
def test_plan_1d_names_the_path(n, name, plan):
    """Short lines (< 8 pairs) take the row pass, as the reference's
    ``_MIN_KERNEL_PAIRS`` fallback; longer ones a run, windowed where the
    scheme windows the length (``can_window``), else a policy run (the
    reference's in-graph band-policy fallback)."""
    assert TK.plan_1d(n, "cpu", name) == plan
    assert TO._MIN_KERNEL_PAIRS == RO._MIN_KERNEL_PAIRS
    assert (plan == "rows-torch") == (n // 2 < RO._MIN_KERNEL_PAIRS)
    assert (plan == "windowed-torch") == (n // 2 >= RO._MIN_KERNEL_PAIRS
                                          and RK.get_scheme(name).can_window(n))
    if not TS.get_scheme(name).can_window(n):  # the windowed wrapper refuses it
        with pytest.raises(ValueError, match="can window"):
            TD.lift_fwd_windows(torch.zeros((1, n), dtype=torch.int32), "paper", 1, 8, name)


def test_pick_blocks_from_the_card_budget():
    """Tiles come from the H100's shared memory, not the TPU's 8 x 256."""
    assert TB.pick_blocks(64, 32768, 2) == (3, 1024)
    assert TB.pick_blocks(1, 5767168, 4) == (1, 1024)
    rb, bp = TB.pick_blocks(10**6, 8, 4)
    assert bp == 8 and rb * (2 * bp + 8) * 4 <= TB.H100_SMEM_PER_SM // 8
    assert TB.pick_blocks(3, 5, 4) == (1, 5)
    for rows, pairs, halo in ((1, 1, 0), (7, 100, 4), (2048, 8, 4), (64, 4096, 2)):
        rb, bp = TB.pick_blocks(rows, pairs, halo)
        assert 1 <= rb <= min(rows, 4) and 1 <= bp <= pairs  # the run kernel's 4 rows a block
        assert rb * (2 * bp + 2 * halo) * 4 <= TB.H100_SMEM_PER_SM // 8
    # a pyramid's run of windowed levels picks its tile from the same budget
    for rows, n, levels in ((64, 65536, 4), (1, 11534336, 4), (10**6, 64, 2), (3, 4099, 6)):
        tile, rb = TB.run_tile(rows, n, levels, 2, 2)
        assert tile % (1 << levels) == 0 and 1 <= rb <= min(rows, 4)
        assert rb * TB.run_row_bytes(tile, levels, 2, 2) <= TB.H100_SMEM_PER_SM // 4 - 1024
    with pytest.raises(RuntimeError, match="is_available"):
        TK.plan_1d(64)  # the default device is the card


@pytest.mark.parametrize("name", ["dwt53_fwd_1d", "dwt53_inv_1d", "dwt53_fwd", "dwt53_inv"])
def test_dwt53_1d_aliases_pass_checked_through(name, monkeypatch):
    """int32 extremes: each (5,3) alias raises the typed overflow error
    under ``checked=True`` in the port's kernels and oracle, as the
    reference's oracle does under ``REPRO_DWT_CHECKED=1``; unchecked,
    all three return the same wrapped bands."""
    from repro.resilience.errors import IntegerOverflowError as RefOverflow
    from repro_torch.resilience.errors import IntegerOverflowError

    x = np.full((2, 24), I32.max, np.int32)
    x[:, ::3] = I32.min

    def args(mod, conv):
        if name in ("dwt53_fwd_1d", "dwt53_fwd"):
            return (conv(x),)
        if name == "dwt53_inv_1d":
            return tuple(conv(a) for a in (x[:, :12], x[:, 12:]))
        return (mod.WaveletPyramid(approx=conv(x[:, :12]), details=(conv(x[:, 12:]),)),)

    t_args = args(TL, torch.from_numpy)
    for mod in (TK, TL):
        with pytest.raises(IntegerOverflowError):
            getattr(mod, name)(*t_args, checked=True)
    r_args = args(RL, jnp.asarray)
    monkeypatch.setenv("REPRO_DWT_CHECKED", "1")
    with pytest.raises(RefOverflow):
        getattr(RL, name)(*r_args)
    monkeypatch.delenv("REPRO_DWT_CHECKED")
    want = getattr(RL, name)(*r_args)
    for mod in (TK, TL):
        got = getattr(mod, name)(*t_args, checked=False)
        got_leaves = [got] if isinstance(got, torch.Tensor) else \
            [got.approx, *got.details] if hasattr(got, "approx") else list(got)
        want_leaves = [want] if not isinstance(want, tuple) else \
            [want.approx, *want.details] if hasattr(want, "approx") else list(want)
        for a, b in zip(got_leaves, want_leaves, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


F1_SHAPES = [(2, 0), (0, 0), (3, 0), (1, 0, 4, 4), (2, 4, 4, 0)]


def _outcome(fn):
    """(exception class name, message), or ("ok", the band shapes)."""
    try:
        pyr = fn()
    except Exception as e:  # noqa: BLE001  the class and message are compared
        return type(e).__name__, str(e)
    return "ok", [tuple(b.shape) for b in (pyr.approx,) + tuple(pyr.details)]


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("shape", F1_SHAPES, ids=str)
def test_zero_length_axes_at_levels_0_equal_the_reference(shape, checked):
    """A zero-length axis at ``levels=0`` is the identity pyramid and its
    inverse the input, in both packages (the port once raised on a
    ``reshape(-1, 0)``); at ``levels >= 1`` both raise the same
    ``ValueError`` where the last axis is empty."""
    x = np.zeros(shape, np.int32)
    want = RK.dwt_fwd(x, levels=0, checked=checked)
    got = TK.dwt_fwd(torch.from_numpy(x), levels=0, checked=checked)
    assert len(got.details) == len(want.details) == 0
    assert got.approx.dtype == torch.int32
    np.testing.assert_array_equal(got.approx.numpy(), np.asarray(want.approx))
    back = TK.dwt_inv(got, checked=checked)
    np.testing.assert_array_equal(back.numpy(), np.asarray(RK.dwt_inv(want, checked=checked)))
    assert tuple(back.shape) == shape
    for levels in (1, 2):
        r = _outcome(lambda: RK.dwt_fwd(x, levels=levels))
        t = _outcome(lambda: TK.dwt_fwd(torch.from_numpy(x), levels=levels))
        assert r == t and (r[0] == "ValueError") == (shape[-1] == 0)
