"""The port's range certificates and checked mode (``repro_torch.core.ranges``)
against the reference ``repro.core.ranges``.

The certificate math is host bigint code, ported line for line: every
query must return the reference's numbers, for every scheme, rounding
mode, transform dimension, level count and dtype name (int64 included).
The checked mode must raise ``IntegerOverflowError`` on exactly the
inputs where the reference raises — built on both sides of the limit —
for the 1-D and 2-D engines, forward and inverse, by keyword and by the
``REPRO_DWT_CHECKED`` toggle.  Property tests set ``deadline=None``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import kernels as RK
from repro.core import lifting as RL
from repro.core import ranges as RR
from repro.resilience.errors import IntegerOverflowError as RefOverflow
from repro_torch import kernels as TK
from repro_torch.core import lifting as TL
from repro_torch.core import ranges as TR
from repro_torch.resilience.errors import IntegerOverflowError

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
DTYPES = ("int8", "int16", "uint8", "uint16", "int32", "int64")
I32 = np.iinfo(np.int32)


@pytest.fixture(autouse=True)
def _checked_off(monkeypatch):
    monkeypatch.delenv("REPRO_DWT_CHECKED", raising=False)


# ---------------------------------------------------------------------------
# Certificates and traces: the reference's numbers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_certificates_equal_the_reference(scheme, mode):
    for ndim in (1, 2, 3):
        for levels in range(1, 7):
            for dt in DTYPES:
                want = RR.range_certificate(scheme, levels, np.dtype(dt), mode=mode, ndim=ndim)
                got = TR.range_certificate(scheme, levels, dt, mode=mode, ndim=ndim)
                assert tuple(got) == tuple(want), (ndim, levels, dt)
                if dt in ("int32", "int16"):  # torch and numpy dtypes name the same certificate
                    assert TR.range_certificate(scheme, levels, getattr(torch, dt), mode=mode,
                                                ndim=ndim) == got
            for lo, hi in ((0, 255), (-128, 127), (-(1 << 20), 1 << 20), (-(1 << 28), 1 << 28),
                           (int(I32.min), int(I32.max))):
                for dt in ("int32", "int64"):
                    assert TR.certified_levels(scheme, dt, (lo, hi), mode=mode, ndim=ndim) == \
                        RR.certified_levels(scheme, np.dtype(dt), (lo, hi), mode=mode, ndim=ndim)
        for levels in (1, 3, 5):
            for limit in (0, 127, 32767, 1 << 20):
                assert TR.band_safe_input(scheme, levels, limit, mode=mode, ndim=ndim) == \
                    RR.band_safe_input(scheme, levels, limit, mode=mode, ndim=ndim)


@settings(max_examples=40, deadline=None)
@given(
    scheme=st.sampled_from(SCHEMES),
    mode=st.sampled_from(MODES),
    ndim=st.integers(1, 3),
    levels=st.integers(0, 6),
    lo=st.integers(-(1 << 40), 1 << 40),
    width=st.integers(0, 1 << 41),
)
def test_traces_equal_the_reference(scheme, mode, ndim, levels, lo, width):
    iv = (lo, lo + width)
    ft, rft = (m.trace_forward(scheme, levels, iv, mode=mode, ndim=ndim) for m in (TR, RR))
    assert (tuple(ft.approx), [[tuple(b) for b in lvl] for lvl in ft.details], ft.lo, ft.hi) == \
        (tuple(rft.approx), [[tuple(b) for b in lvl] for lvl in rft.details], rft.lo, rft.hi)
    assert tuple(TR.cascade_extremes(scheme, levels, iv, mode=mode, ndim=ndim)) == \
        tuple(RR.cascade_extremes(scheme, levels, iv, mode=mode, ndim=ndim))
    it, rit = (m.trace_inverse(scheme, levels, f.approx, f.details, mode=mode, ndim=ndim)
               for m, f in ((TR, ft), (RR, rft)))
    assert (tuple(it.approx), it.lo, it.hi) == (tuple(rit.approx), rit.lo, rit.hi)


def test_query_errors_match_the_reference():
    for call in (
        lambda m: m.range_certificate("cdf53", 1, np.float32),
        lambda m: m.trace_forward("cdf53", -1, (0, 1)),
        lambda m: m.trace_forward("cdf53", 1, (2, 1)),
        lambda m: m.trace_forward("cdf53", 1, (0, 1), ndim=0),
        lambda m: m.trace_inverse("cdf53", 2, (0, 1), [[(0, 1)]]),
        lambda m: m.certified_levels("cdf53", np.int32, (3, 2)),
        lambda m: m.band_safe_input("cdf53", 1, -1),
    ):
        with pytest.raises((TypeError, ValueError)) as want:
            call(RR)
        with pytest.raises(want.type) as got:
            call(TR)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", ["", "0", "false", "off", "no", "1", "yes", "ON"])
def test_checked_enabled_reads_the_env_like_the_reference(value, monkeypatch):
    monkeypatch.setenv("REPRO_DWT_CHECKED", value)
    assert TR.checked_enabled() == RR.checked_enabled()
    assert TR.checked_enabled(False) is RR.checked_enabled(False) is False
    assert TR.checked_enabled(True) is RR.checked_enabled(True) is True


# ---------------------------------------------------------------------------
# Checked mode on the engines: the reference's outcome on both sides of
# the limit.
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        out = fn()
    except (IntegerOverflowError, RefOverflow) as e:
        assert issubclass(type(e), OverflowError)
        return "overflow", None
    return "ok", out


def _built_inputs(scheme, mode, ndim, shape, seed):
    """Noise plus two samples at +-m, for m just inside and just outside
    the one-level and the two-level certificates (the per-level walk's
    boundary and the full cascade's)."""
    rng = np.random.default_rng(seed)
    mags = set()
    for levels in (1, 2):
        cert = RR.range_certificate(scheme, levels, np.int32, mode=mode, ndim=ndim)
        mags |= {cert.hi, cert.hi + 1}
    out = []
    for m in sorted(v for v in mags if v <= I32.max):
        x = rng.integers(-(m // 2), m // 2 + 1, shape).astype(np.int64)
        x.reshape(-1)[0], x.reshape(-1)[-1] = -m, m
        out.append((m, x.astype(np.int32)))
    out.append(("max", np.full(shape, I32.max, np.int32)))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_checked_1d_raises_exactly_where_the_reference_raises(scheme, mode, monkeypatch):
    seen = set()
    for m, x in _built_inputs(scheme, mode, 1, (2, 40), seed=len(scheme)):
        for levels in (1, 2):
            want, rp = _outcome(lambda: RK.dwt_fwd(jnp.asarray(x), levels=levels, mode=mode,
                                                   scheme=scheme, checked=True, backend="xla"))
            got, tp = _outcome(lambda: TK.dwt_fwd(torch.from_numpy(x), levels=levels, mode=mode,
                                                  scheme=scheme, checked=True))
            assert got == want, (m, levels)
            monkeypatch.setenv("REPRO_DWT_CHECKED", "1")
            assert _outcome(lambda: TK.dwt_fwd(torch.from_numpy(x), levels=levels, mode=mode,
                                               scheme=scheme))[0] == want
            monkeypatch.delenv("REPRO_DWT_CHECKED")
            if levels == 1:
                assert _outcome(lambda: TK.dwt_fwd_1d(torch.from_numpy(x), mode=mode,
                                                      scheme=scheme, checked=True))[0] == want
            seen.add(want)
            # the inverse of the unchecked pyramid: certified through its
            # reconstruction, as the reference certifies it
            tp = TK.dwt_fwd(torch.from_numpy(x), levels=levels, mode=mode, scheme=scheme)
            rp = RL.WaveletPyramid(approx=jnp.asarray(tp.approx.numpy()),
                                   details=tuple(jnp.asarray(d.numpy()) for d in tp.details))
            want_i, rx = _outcome(lambda: RK.dwt_inv(rp, mode=mode, scheme=scheme, checked=True,
                                                     backend="xla"))
            got_i, tx = _outcome(lambda: TK.dwt_inv(tp, mode=mode, scheme=scheme, checked=True))
            assert got_i == want_i, (m, levels)
            if got_i == "ok":
                np.testing.assert_array_equal(tx.numpy(), np.asarray(rx))
            if levels == 1:
                assert _outcome(lambda: TK.dwt_inv_1d(tp.approx, tp.details[0], mode=mode,
                                                      scheme=scheme, checked=True))[0] == want_i
    assert seen == {"ok", "overflow"}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_checked_2d_raises_exactly_where_the_reference_raises(scheme, monkeypatch):
    mode = "jpeg2000"
    seen = set()
    for m, x in _built_inputs(scheme, mode, 2, (1, 13, 10), seed=3 + len(scheme)):
        want, _ = _outcome(lambda: RK.dwt_fwd_2d_multi(jnp.asarray(x), levels=2, mode=mode,
                                                       scheme=scheme, checked=True,
                                                       backend="xla"))
        got, _ = _outcome(lambda: TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=2, mode=mode,
                                                      scheme=scheme, checked=True))
        assert got == want, m
        w1, _ = _outcome(lambda: RK.dwt_fwd_2d(jnp.asarray(x), mode=mode, scheme=scheme,
                                               checked=True, backend="xla"))
        g1, _ = _outcome(lambda: TK.dwt_fwd_2d(torch.from_numpy(x), mode=mode, scheme=scheme,
                                               checked=True))
        assert g1 == w1, m
        monkeypatch.setenv("REPRO_DWT_CHECKED", "1")
        assert _outcome(lambda: TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=2, mode=mode,
                                                    scheme=scheme))[0] == want
        monkeypatch.delenv("REPRO_DWT_CHECKED")
        seen |= {want, w1}
        tp = TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=2, mode=mode, scheme=scheme)
        rp = RL.Pyramid2D(ll=jnp.asarray(tp.ll.numpy()),
                          details=tuple(tuple(jnp.asarray(b.numpy()) for b in lvl)
                                        for lvl in tp.details))
        want_i, rx = _outcome(lambda: RK.dwt_inv_2d_multi(rp, mode=mode, scheme=scheme,
                                                          checked=True, backend="xla"))
        got_i, tx = _outcome(lambda: TK.dwt_inv_2d_multi(tp, mode=mode, scheme=scheme,
                                                         checked=True))
        assert got_i == want_i, m
        if got_i == "ok":
            np.testing.assert_array_equal(tx.numpy(), np.asarray(rx))
        b1 = TK.dwt_fwd_2d(torch.from_numpy(x), mode=mode, scheme=scheme)
        rb1 = RL.Bands2D(*(jnp.asarray(b.numpy()) for b in b1))
        assert _outcome(lambda: TK.dwt_inv_2d(b1, mode=mode, scheme=scheme, checked=True))[0] \
            == _outcome(lambda: RK.dwt_inv_2d(rb1, mode=mode, scheme=scheme, checked=True,
                                              backend="xla"))[0]
    assert seen == {"ok", "overflow"}


def test_checked_inverse_rejects_hostile_bands_and_admits_real_data():
    """Bands that are the forward image of no in-range input wrap in the
    inverse; the checked inverse certifies the reconstruction and raises
    (as the reference).  The per-level walk admits real data a static
    full-cascade trace would reject."""
    hp = TL.WaveletPyramid(approx=torch.full((1, 8), int(I32.max), dtype=torch.int32),
                           details=(torch.full((1, 8), int(I32.max), dtype=torch.int32),
                                    torch.full((1, 16), int(I32.max), dtype=torch.int32)))
    with pytest.raises(IntegerOverflowError):
        TK.dwt_inv(hp, checked=True)
    rhp = RL.WaveletPyramid(approx=jnp.asarray(hp.approx.numpy()),
                            details=tuple(jnp.asarray(d.numpy()) for d in hp.details))
    with pytest.raises(RefOverflow):
        RK.dwt_inv(rhp, checked=True, backend="xla")
    assert TK.dwt_inv(hp, checked=False).shape == (1, 32)  # unchecked: wraps silently
    cert = TR.range_certificate("97m", 3, "int32", ndim=2)
    assert cert.hi < 4096
    x = torch.from_numpy(np.random.default_rng(5).integers(-4096, 4096, (1, 32, 32))
                         .astype(np.int32))
    pyr = TK.dwt_fwd_2d_multi(x, levels=3, scheme="97m", checked=True)
    assert torch.equal(TK.dwt_inv_2d_multi(pyr, scheme="97m", checked=True), x)


def test_boundary_validators_equal_the_reference():
    for scheme in SCHEMES:
        cert = TR.range_certificate(scheme, 3, "int32", ndim=2)
        for lo, hi in ((cert.lo, cert.hi), (cert.lo - 1, cert.hi + 1), (0, cert.hi + 1)):
            kw = dict(scheme=scheme, levels=3, dtype=np.int32, ndim=2)
            want = _outcome(lambda: RR.assert_interval_safe(lo, hi, **kw))[0]
            assert _outcome(lambda: TR.assert_interval_safe(lo, hi, **kw))[0] == want
        band = np.array([cert.band_lo, 0, cert.band_hi], np.int32)
        for b in (band, band + np.array([0, 0, 1], np.int32), band - np.array([1, 0, 0], np.int32)):
            kw = dict(scheme=scheme, levels=3, ndim=2)
            want = _outcome(lambda: RR.assert_encodable([b, b[:0]], **kw))[0]
            assert _outcome(lambda: TR.assert_encodable([torch.from_numpy(b)], **kw))[0] == want
            assert _outcome(lambda: TR.assert_encodable([b], **kw))[0] == want


def test_port_only_rules():
    """int64 certificates are computed, but the engines refuse int64 input
    (checked or not); 3-D checked stepping runs through the volume
    engine; the overflow error is typed."""
    assert TR.range_certificate("cdf53", 2, "int64").hi == \
        RR.range_certificate("cdf53", 2, np.int64).hi
    x64 = torch.zeros((2, 32), dtype=torch.int64)
    for checked in (True, False):
        with pytest.raises(TypeError, match="int64"):
            TK.dwt_fwd(x64, levels=2, checked=checked)
    for levels in (1, 2):  # two levels step the approximation down once
        TR.run_checked(lambda a: a, torch.zeros((4, 4, 4), dtype=torch.int32), scheme="cdf53",
                       levels=levels, ndim=3)
    with pytest.raises(OverflowError, match="compute range"):
        TK.dwt_fwd(torch.full((1, 32), int(I32.max), dtype=torch.int32), levels=1, checked=True)
    u16 = torch.from_numpy(np.array([[0, 65535] * 8], np.uint16))
    assert TR._data_interval([u16]) == (0, 65535)


# ---------------------------------------------------------------------------
# Checked mode on the oracles (core.lifting): the reference's outcome,
# by keyword and by the env toggle.
# ---------------------------------------------------------------------------


def _oracle_calls(name, x, mode, kw):
    """(reference call, port call) of oracle ``name`` on the numpy input
    ``x``; an inverse is fed the bands of the unchecked forward."""
    sch = dict(scheme="97m", mode=mode, **kw)
    j, t = jnp.asarray(x), torch.from_numpy(x)
    if name in ("dwt_fwd_1d", "dwt_fwd_2d"):
        return (lambda: getattr(RL, name)(j, **sch)), (lambda: getattr(TL, name)(t, **sch))
    if name in ("dwt_fwd", "dwt_fwd_2d_multi"):
        return (lambda: getattr(RL, name)(j, levels=2, **sch)), \
            (lambda: getattr(TL, name)(t, levels=2, **sch))
    if name == "dwt_inv_1d":
        s, d = TL.dwt_fwd_1d(t, scheme="97m", mode=mode, checked=False)
        return (lambda: RL.dwt_inv_1d(jnp.asarray(s.numpy()), jnp.asarray(d.numpy()), **sch)), \
            (lambda: TL.dwt_inv_1d(s, d, **sch))
    if name == "dwt_inv_2d":
        b = TL.dwt_fwd_2d(t, scheme="97m", mode=mode, checked=False)
        rb = RL.Bands2D(*(jnp.asarray(a.numpy()) for a in b))
        return (lambda: RL.dwt_inv_2d(rb, **sch)), (lambda: TL.dwt_inv_2d(b, **sch))
    if name == "dwt_inv":
        p = TL.dwt_fwd(t, levels=2, scheme="97m", mode=mode, checked=False)
        rp = RL.WaveletPyramid(approx=jnp.asarray(p.approx.numpy()),
                               details=tuple(jnp.asarray(d.numpy()) for d in p.details))
        return (lambda: RL.dwt_inv(rp, **sch)), (lambda: TL.dwt_inv(p, **sch))
    p = TL.dwt_fwd_2d_multi(t, levels=2, scheme="97m", mode=mode, checked=False)
    rp = RL.Pyramid2D(ll=jnp.asarray(p.ll.numpy()),
                      details=tuple(tuple(jnp.asarray(b.numpy()) for b in lvl)
                                    for lvl in p.details))
    return (lambda: RL.dwt_inv_2d_multi(rp, **sch)), (lambda: TL.dwt_inv_2d_multi(p, **sch))


def _leaves_np(out):
    if isinstance(out, (tuple, list)):
        return [a for sub in out for a in _leaves_np(sub)]
    return [np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)]


ORACLES = ("dwt_fwd_1d", "dwt_inv_1d", "dwt_fwd", "dwt_inv",
           "dwt_fwd_2d", "dwt_inv_2d", "dwt_fwd_2d_multi", "dwt_inv_2d_multi")


@pytest.mark.parametrize("how", ["kwarg", "env"])
@pytest.mark.parametrize("name", ORACLES)
def test_checked_oracles_raise_what_the_reference_raises(name, how, monkeypatch):
    """97m int32 extremes and their neighbours: the same exception class
    (and label) as ``repro.core.lifting``, the same bands where neither
    raises."""
    mode = "jpeg2000"
    ndim = 2 if "2d" in name else 1
    shape = (1, 13, 10) if ndim == 2 else (2, 40)
    kw = {"checked": True} if how == "kwarg" else {}
    seen = set()
    for m, x in _built_inputs("97m", mode, ndim, shape, seed=11 + ndim):
        ref, port = _oracle_calls(name, x, mode, kw)
        if how == "env":
            monkeypatch.setenv("REPRO_DWT_CHECKED", "1")
        try:
            rw = _raised(ref)
            tw = _raised(port)
        finally:
            monkeypatch.delenv("REPRO_DWT_CHECKED", raising=False)
        assert (tw[0] is None) == (rw[0] is None), (m, rw, tw)
        if rw[0] is None:
            for a, b in zip(_leaves_np(tw[1]), _leaves_np(rw[1]), strict=True):
                np.testing.assert_array_equal(a, b)
        else:
            assert issubclass(tw[0], IntegerOverflowError) and issubclass(rw[0], RefOverflow)
            assert tw[1].split(":")[0] == rw[1].split(":")[0] == f"lifting.{name}"
        seen.add(rw[0] is None)
    assert seen == {True, False}


def _raised(fn):
    """(None, result) or (exception class, message)."""
    try:
        return None, fn()
    except Exception as e:  # noqa: BLE001  the class itself is compared
        return type(e), str(e)


BY_DESIGN_ABSENT = {
    # the dispatch convention: the tensor's device is the whole choice
    "VALID_BACKENDS", "BackendDegradeWarning", "default_backend", "has_compiled_pallas",
    "platform", "resolve", "resolve_backend", "use_backend",
}


@pytest.mark.parametrize("pkg", ["core", "kernels"])
def test_port_exports_the_reference_surface(pkg):
    import importlib

    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    names = set(getattr(ref, "__all__", None) or
                [n for n in vars(ref) if not n.startswith("_") and
                 not isinstance(vars(ref)[n], type(importlib))])
    missing = sorted(n for n in names - BY_DESIGN_ABSENT if not hasattr(port, n))
    assert not missing
    if hasattr(ref, "__all__"):
        assert not sorted(n for n in names - BY_DESIGN_ABSENT if n not in port.__all__)
