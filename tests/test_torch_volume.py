"""The port's volume paths as a whole, against the reference ``repro``.

3-D serve buckets, ``KIND_ND`` containers, WZRS volume streams and checked
3-D transforms: the same seeded volumes go through ``repro_torch`` on the
CPU (the 3-D kernels' plain versions) and through the reference; pyramids
must be equal bit for bit, container and stream bytes byte for byte in
both directions, and checked mode must raise ``IntegerOverflowError``
exactly where the reference raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codec as RCODEC
from repro import kernels as RK
from repro import serve as RSV
from repro.codec import stream as RS
from repro.core import lifting as RL
from repro.core import ranges as RR
from repro.resilience.errors import IntegerOverflowError as RefOverflow
from repro_torch import codec as TCODEC
from repro_torch import kernels as TK
from repro_torch import serve as TSV
from repro_torch.codec import container as TC
from repro_torch.codec import stream as TS
from repro_torch.core import lifting as TL
from repro_torch.core import ranges as TR
from repro_torch.resilience.errors import IntegerOverflowError
from repro_torch.serve import ProgressiveServeRoute, WaveletServeEngine, crop_result, tier_shape

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)
BUCKETS = [(4, 16, 16), (8, 32, 24)]


@pytest.fixture(autouse=True)
def _checked_off(monkeypatch):
    monkeypatch.delenv("REPRO_DWT_CHECKED", raising=False)


def _leaves(pyr):
    return [pyr.approx] + [b for lvl in pyr.details for b in lvl]


def _requests(mod, seed=0, n=7):
    rng = np.random.default_rng(seed)
    shapes = [(4, 16, 16), (8, 32, 24), (3, 10, 12), (8, 20, 24), (2, 2, 2), (5, 31, 17),
              (4, 16, 9)]
    return [mod.TransformRequest(uid=i, image=rng.integers(-2048, 2048, shapes[i % len(shapes)],
                                                           dtype=np.int32))
            for i in range(n)]


def _pair(scheme, mode, encode, **kw):
    port = WaveletServeEngine(buckets=BUCKETS, batch_slots=3, levels=2, scheme=scheme, mode=mode,
                              device="cpu", encode_response=encode, **kw)
    ref = RSV.WaveletServeEngine(buckets=BUCKETS, batch_slots=3, levels=2, scheme=scheme,
                                 mode=mode, encode_response=encode)
    got = sorted(port.run(_requests(TSV)), key=lambda r: r.uid)
    want = sorted(ref.run(_requests(RSV)), key=lambda r: r.uid)
    return port, got, want


# ---------------------------------------------------------------------------
# 3-D serve buckets.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme,mode", [("cdf53", "jpeg2000"), ("97m", "paper"),
                                         ("cdf22", "paper"), ("haar", "jpeg2000")])
def test_volume_engine_matches_reference_engine(scheme, mode):
    port, got, want = _pair(scheme, mode, encode=False)
    assert [r.uid for r in got] == [r.uid for r in want] == list(range(7))
    assert any(r.padded for r in got)
    for g, w in zip(got, want):
        assert g.done and g.error is None and g.bucket == w.bucket
        gl, wl = _leaves(g.pyramid), jax.tree_util.tree_leaves(w.pyramid)
        assert len(gl) == len(wl) == 1 + 2 * 7
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        xr = crop_result(TK.dwt_inv_nd(g.pyramid, scheme=scheme, mode=mode), g)
        np.testing.assert_array_equal(xr.numpy(), g.image)
    assert port.executor.misses == 2 and port.executor.hits > 0


@pytest.mark.parametrize("scheme,mode", [("cdf53", "jpeg2000"), ("97m", "paper")])
def test_volume_engine_containers_equal_the_reference_both_ways(scheme, mode):
    port, got, want = _pair(scheme, mode, encode=True)
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        assert g.encoded == w.encoded and g.batch_index == w.batch_index
        assert TCODEC.peek(g.encoded)["kind"] == TC.KIND_ND == 3
        assert TCODEC.peek(g.encoded)["ndim"] == 3
        # the port decodes the reference's bytes, the reference the port's
        row = TCODEC.decode_batch(w.encoded, device="cpu")[g.batch_index]
        for a, b in zip(_leaves(row), _leaves(g.pyramid)):
            assert torch.equal(a, b)
        xr = crop_result(TK.dwt_inv_nd(row, scheme=scheme, mode=mode), g)
        np.testing.assert_array_equal(xr.numpy(), g.image)
        ref_row = RCODEC.decode_batch(g.encoded)[w.batch_index]
        for a, b in zip(jax.tree_util.tree_leaves(ref_row), jax.tree_util.tree_leaves(w.pyramid)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_volume_route_tiers_equal_the_reference_route():
    port, got, want = _pair("cdf53", "jpeg2000", encode=True)
    rt, rr = ProgressiveServeRoute(device="cpu"), RSV.ProgressiveServeRoute()
    for g, w in zip(got, want):
        rt.store(g)
        rr.store(w)
    for g in got:
        assert rt.tiers(g.uid) == rr.tiers(g.uid)
        thumb = rt.thumbnail(g.uid)
        np.testing.assert_array_equal(thumb.numpy(), rr.thumbnail(g.uid))
        assert tuple(thumb.shape) == tier_shape(g.image.shape, 2, 0)
        # the thumbnail is the request's approximation band, cropped
        np.testing.assert_array_equal(thumb.numpy(), g.pyramid.approx[
            tuple(slice(0, s) for s in thumb.shape)].numpy())
        np.testing.assert_array_equal(rt.refine(g.uid, 1).numpy(), rr.refine(g.uid, 1))
        np.testing.assert_array_equal(rt.full(g.uid).numpy(), g.image)


def test_legacy_depth_bucket_and_checked_submit(monkeypatch):
    eng = WaveletServeEngine(height=16, width=16, depth=4, levels=2, batch_slots=2, device="cpu")
    ref = RSV.WaveletServeEngine(height=16, width=16, depth=4, levels=2, batch_slots=2)
    assert eng.bucket_shape == ref.bucket_shape == (4, 16, 16)
    assert eng.warmup() == ref.warmup() == 1
    with pytest.raises(ValueError, match="too small"):
        WaveletServeEngine(buckets=[(2, 16, 16)], levels=2, device="cpu")
    # checked admission certifies with ndim=3, as the reference
    cert = RR.range_certificate("97m", 2, np.int32, mode="paper", ndim=3)
    for m, want in ((cert.hi, "ok"), (int(I32.max), "overflow")):
        img = np.zeros((4, 16, 16), np.int32)
        img[0, 0, 0], img[-1, -1, -1] = m, max(cert.lo, -m)
        port = WaveletServeEngine(buckets=[(4, 16, 16)], levels=2, scheme="97m", device="cpu",
                                  checked=True)
        refe = RSV.WaveletServeEngine(buckets=[(4, 16, 16)], levels=2, scheme="97m",
                                      checked=True)
        outcomes = []
        for e, mod in ((port, TSV), (refe, RSV)):
            try:
                e.submit(mod.TransformRequest(uid=0, image=img))
                outcomes.append("ok")
            except (IntegerOverflowError, RefOverflow):
                outcomes.append("overflow")
        assert outcomes == [want, want]


# ---------------------------------------------------------------------------
# KIND_ND containers and WZRS volume streams.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_nd_inverse_transform_equals_the_reference(scheme, mode):
    x = np.random.default_rng(len(scheme)).integers(-4096, 4096, (2, 7, 9, 10)).astype(np.int32)
    rp = RK.dwt_fwd_nd(jnp.asarray(x), levels=2, mode=mode, scheme=scheme, ndim=3)
    tp = TK.dwt_fwd_nd(torch.from_numpy(x), levels=2, mode=mode, scheme=scheme)
    blob = RCODEC.encode_pyramid(rp, scheme=scheme, mode=mode)
    assert TCODEC.encode_pyramid(tp, scheme=scheme, mode=mode) == blob
    dec = TCODEC.decode_pyramid(blob, device="cpu")
    got = TCODEC.inverse_transform(dec)
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RCODEC.inverse_transform(RCODEC.decode_pyramid(blob))))
    # a truncated (progressive) decode reconstructs like the reference's
    np.testing.assert_array_equal(
        TCODEC.reconstruct(TCODEC.decode_progressive(blob, 1, device="cpu")).numpy(),
        np.asarray(RCODEC.reconstruct(RCODEC.decode_progressive(blob, 1))))


@pytest.mark.parametrize("scheme,mode", [("cdf53", "jpeg2000"), ("97m", "paper"),
                                         ("haar", "paper"), ("cdf22", "jpeg2000")])
def test_volume_stream_bytes_equal_the_reference_both_ways(scheme, mode):
    vol = np.random.default_rng(7).integers(-2048, 2048, (13, 12, 10)).astype(np.int32)
    want = b"".join(RS.encode_volume(vol, slab=4, levels=3, scheme=scheme, mode=mode))
    got = b"".join(TS.encode_volume(vol, slab=4, levels=3, scheme=scheme, mode=mode,
                                    device="cpu"))
    assert got == want
    np.testing.assert_array_equal(TS.decode_volume(want, device="cpu").numpy(), vol)
    np.testing.assert_array_equal(RS.decode_volume(got), vol)
    # an N-D stream encoder on lead-dim chunks, and a 4-D frame
    chunks = [vol[:4], vol[4:5], vol[None, :3]]
    for ndim in (3, 4) if scheme == "cdf53" else (3,):
        parts = [c for c in chunks if c.ndim >= ndim]
        t = b"".join(TS.StreamEncoder(levels=2, scheme=scheme, mode=mode, ndim=ndim,
                                      device="cpu").encode(parts))
        r = b"".join(RS.StreamEncoder(levels=2, scheme=scheme, mode=mode, ndim=ndim)
                     .encode(parts))
        assert t == r
        for a, b in zip(TS.decode_stream(t, device="cpu"), parts):
            np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# Checked 3-D: certificates and the engines' outcome on both sides of the
# limit.
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        out = fn()
    except (IntegerOverflowError, RefOverflow):
        return "overflow", None
    return "ok", out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_checked_3d_raises_exactly_where_the_reference_raises(scheme, monkeypatch):
    mode = "jpeg2000"
    for levels in (1, 2, 3):
        want = RR.range_certificate(scheme, levels, np.int32, mode=mode, ndim=3)
        assert tuple(TR.range_certificate(scheme, levels, "int32", mode=mode, ndim=3)) == \
            tuple(want)
    rng = np.random.default_rng(len(scheme))
    seen = set()
    mags = sorted({c.hi + e for lv in (1, 2) for c in [RR.range_certificate(
        scheme, lv, np.int32, mode=mode, ndim=3)] for e in (0, 1)} | {int(I32.max)})
    for m in mags:
        x = rng.integers(-(m // 2), m // 2 + 1, (1, 6, 9, 8)).astype(np.int64)
        x[0, 0, 0, 0], x[0, -1, -1, -1] = -m, m
        x = x.astype(np.int32)
        want, _ = _outcome(lambda: RK.dwt_fwd_nd(jnp.asarray(x), levels=2, mode=mode,
                                                 scheme=scheme, ndim=3, checked=True,
                                                 backend="xla"))
        got, tp = _outcome(lambda: TK.dwt_fwd_nd(torch.from_numpy(x), levels=2, mode=mode,
                                                 scheme=scheme, checked=True))
        assert got == want, m
        assert _outcome(lambda: TL.dwt_fwd_nd(torch.from_numpy(x), levels=2, mode=mode,
                                              scheme=scheme, checked=True))[0] == want
        monkeypatch.setenv("REPRO_DWT_CHECKED", "1")
        assert _outcome(lambda: TK.dwt_fwd_nd(torch.from_numpy(x), levels=2, mode=mode,
                                              scheme=scheme))[0] == want
        monkeypatch.delenv("REPRO_DWT_CHECKED")
        seen.add(want)
        # the inverse of the unchecked pyramid, certified through its
        # reconstruction as the reference certifies it
        tp = TK.dwt_fwd_nd(torch.from_numpy(x), levels=2, mode=mode, scheme=scheme)
        rp = RL.PyramidND(approx=jnp.asarray(tp.approx.numpy()),
                          details=tuple(tuple(jnp.asarray(b.numpy()) for b in lvl)
                                        for lvl in tp.details))
        want_i, rx = _outcome(lambda: RK.dwt_inv_nd(rp, mode=mode, scheme=scheme, checked=True,
                                                    backend="xla"))
        got_i, tx = _outcome(lambda: TK.dwt_inv_nd(tp, mode=mode, scheme=scheme, checked=True))
        assert got_i == want_i, m
        if got_i == "ok":
            np.testing.assert_array_equal(tx.numpy(), np.asarray(rx))
    assert seen == {"ok", "overflow"}


def test_checked_3d_stepping_runs_through_the_volume_engine():
    """Per-level certification steps the approximation down with the
    port's own 3-D transform (no refusal at ndim 3), and a 3-D container
    encode certifies its bands like the reference."""
    x = torch.from_numpy(np.random.default_rng(3).integers(-2048, 2048, (2, 9, 8, 7))
                         .astype(np.int32))
    got = TR.run_checked(lambda a: TK.dwt_fwd_nd(a, levels=3, checked=False), x,
                         scheme="cdf53", levels=3, ndim=3)
    for a, b in zip(_leaves(got), _leaves(TL.dwt_fwd_nd(x, levels=3))):
        assert torch.equal(a, b)
    pyr = TK.dwt_fwd_nd(x, levels=2, scheme="97m", checked=True)
    rp = RL.PyramidND(approx=jnp.asarray(pyr.approx.numpy()),
                      details=tuple(tuple(jnp.asarray(b.numpy()) for b in lvl)
                                    for lvl in pyr.details))
    assert TCODEC.encode_pyramid(pyr, scheme="97m", checked=True) == \
        RCODEC.encode_pyramid(rp, scheme="97m", checked=True)
    with pytest.raises(IntegerOverflowError):
        TK.dwt_fwd_nd(torch.full((1, 4, 4, 4), int(I32.max), dtype=torch.int32), levels=1,
                      checked=True)


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("shape", [(1, 0, 4, 4), (2, 4, 4, 0), (0, 3, 4, 5)], ids=str)
def test_nd_zero_length_axes_at_levels_0_equal_the_reference(shape, checked):
    """``dwt_fwd_nd`` / ``dwt_inv_nd`` at ``levels=0`` on a zero-length
    axis return the identity pyramid and the input, as the reference
    does (the port once raised on a ``reshape(-1, ...)``); at ``levels >=
    1`` both raise the same ``ValueError`` where a volume axis is empty;
    under 3 axes both refuse."""
    x = np.zeros(shape, np.int32)
    want = RK.dwt_fwd_nd(x, levels=0, checked=checked)
    got = TK.dwt_fwd_nd(torch.from_numpy(x), levels=0, checked=checked)
    assert len(got.details) == len(want.details) == 0
    np.testing.assert_array_equal(got.approx.numpy(), np.asarray(want.approx))
    back = TK.dwt_inv_nd(got, checked=checked)
    np.testing.assert_array_equal(back.numpy(), np.asarray(RK.dwt_inv_nd(want, checked=checked)))
    assert tuple(back.shape) == shape and back.dtype == torch.int32
    for levels in (1, 2):
        if 0 not in shape[-3:]:  # an empty batch of valid volumes transforms
            got = TK.dwt_fwd_nd(torch.from_numpy(x), levels=levels)
            want = RK.dwt_fwd_nd(x, levels=levels)
            assert tuple(got.approx.shape) == np.asarray(want.approx).shape
            continue
        with pytest.raises(ValueError, match="too small") as port:
            TK.dwt_fwd_nd(torch.from_numpy(x), levels=levels)
        with pytest.raises(ValueError, match="too small") as ref:
            RK.dwt_fwd_nd(x, levels=levels)
        assert str(port.value) == str(ref.value)
    for flat in ((2, 0), (0, 0), (3, 0)):
        with pytest.raises(ValueError, match="need >= 3 axes"):
            TK.dwt_fwd_nd(torch.zeros(flat, dtype=torch.int32), levels=0)
