"""The port's codec (``repro_torch.codec``) against the reference ``repro.codec``.

The same seeded integer inputs go through both packages on the CPU (the
Rice kernels' plain versions on the port's side; the reference's Pallas
pack stage in interpret mode where its own tests run it so); coded bytes
must be equal byte for byte, decoded bands exactly, and corruption must
raise the same typed errors with the same per-band status.  The kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as RK
from repro.codec import container as RC
from repro.codec import progressive as RP
from repro.codec import rice as RR
from repro.codec import stream as RS
from repro.core import lifting as RL
from repro.resilience import inject as RINJ
from repro_torch import codec as TCODEC
from repro_torch.codec import container as TC
from repro_torch.codec import progressive as TP
from repro_torch.codec import rice as TR
from repro_torch.codec import stream as TS
from repro_torch.core import lifting as TL
from repro_torch import kernels as TK

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32_MIN, I32_MAX = -(2**31), 2**31 - 1

ADVERSARIAL = [
    np.zeros(1000, np.int32),  # constant: k=0 degenerate blocks
    np.full(513, 7, np.int32),
    np.full(300, I32_MIN, np.int32),  # every code escapes
    np.full(300, I32_MAX, np.int32),
    np.array([0], np.int32),
    np.array([], np.int32),  # empty band
    np.arange(-640, 640, dtype=np.int32),
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _costs(block: np.ndarray) -> np.ndarray:
    """Exact Rice cost of every k for one block (numpy, from the spec)."""
    u = ((block.astype(np.int64) << 1) ^ (block.astype(np.int64) >> 31)) & 0xFFFFFFFF
    out = []
    for k in range(RR.K_MAX + 1):
        q = u >> k
        out.append(int(np.where(q >= RR.Q_MAX, RR.LMAX, np.minimum(q, RR.Q_MAX) + 1 + k).sum()))
    return np.array(out)


# ---------------------------------------------------------------------------
# Coder primitives.
# ---------------------------------------------------------------------------


def test_zigzag_and_unzigzag_equal_the_reference_at_the_extremes():
    x = np.array([0, -1, 1, 17, -17, I32_MIN, I32_MAX, I32_MIN + 1, 12345, -12345], np.int32)
    want_u = np.asarray(RR.zigzag(jnp.asarray(x)))
    got_u = TR.zigzag(_t(x))
    np.testing.assert_array_equal(got_u.numpy(), want_u.astype(np.int64))
    assert int(got_u[5]) == 0xFFFFFFFF and int(got_u[6]) == 0xFFFFFFFE
    got_x = TR.unzigzag(torch.from_numpy(want_u.astype(np.int64)))
    assert got_x.dtype == torch.int32
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(RR.unzigzag(jnp.asarray(want_u))))
    np.testing.assert_array_equal(got_x.numpy(), x)


@pytest.mark.parametrize("nb", [1, 8])
def test_pack_words_equals_the_pallas_kernel(nb):
    rng = np.random.default_rng(nb)
    bits3 = rng.integers(0, 2, (nb, 32, 320)).astype(np.int32)
    want = np.asarray(RR._pack_words_pallas(jnp.asarray(bits3), interpret=True))
    got = TR.pack_words(_t(bits3))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _tie_blocks(rng) -> np.ndarray:
    """Blocks whose least cost is reached by two k: a value with
    ``u >> k`` in {1, 2} costs the same at k and k + 1, so a block of
    zigzag values drawn from [2**k, 3 * 2**k) ties k with k + 1."""
    blocks = [np.full(256, -1), np.full(256, 1)]  # u = 1 and u = 2 (k = 0, 1 and 2 tie)
    for k in (0, 3, 5, 10, 20):
        u = rng.integers(1 << k, 3 << k, 256)
        blocks.append(np.where(u & 1, -(u >> 1) - 1, u >> 1))  # unzigzag
    return np.stack(blocks).astype(np.int32)


def test_plain_chunk_encode_equals_the_reference_including_ties():
    rng = np.random.default_rng(3)
    ties = _tie_blocks(rng)
    for b in ties:
        c = _costs(b)
        assert (c == c.min()).sum() > 1  # the block really ties
    xb = np.concatenate([
        ties,
        rng.integers(-500, 500, (2, 256)),
        np.full((1, 256), I32_MIN), np.full((1, 256), I32_MAX),
        rng.integers(I32_MIN, I32_MAX, (5, 256), dtype=np.int64),
    ]).astype(np.int32)
    assert xb.shape[0] % 8 == 0  # the Pallas pack's grid covers whole groups of 8 rows
    by, nbits, k = RR._encode_chunk(jnp.asarray(xb), pack_backend="interpret")
    tby, tnbits, tk = TR._encode_chunk(_t(xb))
    np.testing.assert_array_equal(tby.numpy(), np.asarray(by))
    np.testing.assert_array_equal(tnbits.numpy(), np.asarray(nbits))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k))
    # ties resolve to the first k of least cost, as jnp.argmin does
    for row, kk in zip(xb, tk.numpy()):
        assert kk == int(np.argmin(_costs(row)))


def test_plain_chunk_decode_equals_the_reference():
    rng = np.random.default_rng(4)
    x = rng.integers(-3000, 3000, 5 * 256).astype(np.int32)
    payload, ks, lens = RR.encode_band(x)
    mat = np.zeros((5, 1024), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
    for i in range(5):
        mat[i, : lens[i]] = np.frombuffer(payload, np.uint8)[offs[i] : offs[i + 1]]
    want = np.asarray(RR._decode_chunk(jnp.asarray(mat), jnp.asarray(ks.astype(np.int32))))
    got = TR._decode_chunk(_t(mat), _t(ks.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().reshape(-1), x)


# ---------------------------------------------------------------------------
# Band API.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vals", ADVERSARIAL, ids=lambda v: f"n{v.size}")
def test_encode_band_equals_the_reference_on_adversarial_bands(vals):
    want = RR.encode_band(vals, backend="pallas")  # interpret mode off the TPU
    got = TR.encode_band(_t(vals))
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for stream in (got, want):
        out = TR.decode_band(*stream, vals.size, device="cpu")
        assert out.dtype == torch.int32 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), vals)
    np.testing.assert_array_equal(RR.decode_band(*got, vals.size), vals)


def test_encode_band_longer_than_one_reference_chunk():
    rng = np.random.default_rng(5)
    x = rng.integers(-3000, 3000, RR.CHUNK_BLOCKS * RR.BLOCK_VALUES + 777).astype(np.int32)
    want = RR.encode_band(x)
    got = TR.encode_band(_t(x))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(TR.decode_band(*want, x.size, device="cpu").numpy(), x)


def test_encode_band_takes_narrow_dtypes_and_views_as_int32():
    rng = np.random.default_rng(6)
    for dt in (np.int8, np.int16):
        x = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, 700).astype(dt)
        assert TR.encode_band(_t(x))[0] == RR.encode_band(x)[0]
    big = _t(rng.integers(-99, 99, (6, 300)).astype(np.int32))
    view = big[:, ::2]  # strided: flattened contiguously before coding
    assert TR.encode_band(view)[0] == RR.encode_band(view.numpy())[0]


def test_decode_band_rejects_bad_tables_like_the_reference():
    rng = np.random.default_rng(7)
    x = rng.integers(-500, 500, 1000).astype(np.int32)
    payload, ks, lens = TR.encode_band(_t(x))
    for args in [(payload[:-3], ks, lens), (payload, ks[:-1], lens)]:
        with pytest.raises(ValueError) as want:
            RR.decode_band(*args, x.size)
        with pytest.raises(ValueError) as got:
            TR.decode_band(*args, x.size, device="cpu")
        assert str(got.value) == str(want.value)
    bad_k = ks.copy()
    bad_k[0] = 200
    with pytest.raises(ValueError, match="K_MAX"):
        TR.decode_band(payload, bad_k, lens, x.size, device="cpu")


def test_decode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    payload, ks, lens = TR.encode_band(torch.arange(300, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="is_available"):
        TR.decode_band(payload, ks, lens, 300)
    blob = TC.encode_pyramid(TL.WaveletPyramid(approx=torch.arange(9, dtype=torch.int32),
                                               details=()))
    with pytest.raises(RuntimeError, match="is_available"):
        TC.decode_pyramid(blob)


# ---------------------------------------------------------------------------
# Containers.
# ---------------------------------------------------------------------------

_FORMATS = [
    dict(version=1, checksum=True),
    dict(version=1, checksum=False),
    dict(version=2),
    dict(version=2, parity=True),
]


def _pyramids(kind, scheme, mode, seed):
    """(reference pyramid, the port's copy, encode kwargs) of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "1d":
        x = jnp.asarray(rng.integers(-4096, 4096, (3, 41)), jnp.int32)
        rp = RK.dwt_fwd(x, levels=3, mode=mode, scheme=scheme)
        return rp, TL.WaveletPyramid.from_numpy(rp, device="cpu"), {}
    if kind == "2d":
        x = jnp.asarray(rng.integers(-4096, 4096, (2, 19, 23)), jnp.int32)
        rp = RK.dwt_fwd_2d_multi(x, levels=2, mode=mode, scheme=scheme)
        return rp, TL.Pyramid2D.from_numpy(rp, device="cpu"), {}
    x = jnp.asarray(rng.integers(-4096, 4096, (6, 9, 10)), jnp.int32)
    rp = RK.dwt_fwd_nd(x, levels=2, mode=mode, scheme=scheme, ndim=3)
    return rp, TL.PyramidND.from_numpy(rp, device="cpu"), {}


def _assert_same_pyramid(port_pyr, ref_pyr):
    got = TC._leaves(port_pyr)
    want = [np.asarray(b) for b in RC._flatten_bands(ref_pyr, RC._pyramid_kind(ref_pyr))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kind", ["1d", "2d", "3d"])
def test_container_bytes_equal_the_reference_both_ways(kind, scheme, mode):
    rp, tp, kw = _pyramids(kind, scheme, mode, seed=len(scheme) * 7 + len(mode))
    for fmt in _FORMATS:
        want = RC.encode_pyramid(rp, scheme=scheme, mode=mode, **fmt, **kw)
        got = TC.encode_pyramid(tp, scheme=scheme, mode=mode, **fmt, **kw)
        assert got == want, fmt
        assert TC.peek(got) == RC.peek(want)
        dec = TC.decode_pyramid(want, device="cpu")  # the port reads the reference's bytes
        rdec = RC.decode_pyramid(got)  # and the reference reads the port's
        assert (dec.kind, dec.scheme, dec.mode, dec.levels, dec.lead, dec.shape, dec.dtype,
                dec.band_status) == (rdec.kind, rdec.scheme, rdec.mode, rdec.levels, rdec.lead,
                                     rdec.shape, rdec.dtype, rdec.band_status)
        _assert_same_pyramid(dec.pyramid, rdec.pyramid)
    assert TC.roundtrip_exact(tp, scheme=scheme, mode=mode, **kw)


@pytest.mark.parametrize("dt", [np.int8, np.int16])
def test_container_narrow_dtypes_equal_the_reference(dt):
    rp = RL.WaveletPyramid(approx=jnp.asarray([[1, -2, 3]], dt), details=(jnp.asarray([[4, -5]], dt),))
    tp = TL.WaveletPyramid.from_numpy(rp, device="cpu")
    want = RC.encode_pyramid(rp)
    assert TC.encode_pyramid(tp) == want
    dec = TC.decode_pyramid(want, device="cpu")
    assert dec.pyramid.approx.dtype == getattr(torch, np.dtype(dt).name)
    assert dec.dtype == RC.decode_pyramid(want).dtype
    assert TC.roundtrip_exact(tp)
    x = jnp.asarray(np.random.default_rng(8).integers(-100, 100, (2, 12, 10)), dt)
    rp2 = RK.dwt_fwd_2d_multi(x, levels=1)
    rp2 = RL.Pyramid2D(ll=rp2.ll.astype(dt), details=tuple(tuple(b.astype(dt) for b in lvl)
                                                            for lvl in rp2.details))
    assert TC.encode_pyramid(TL.Pyramid2D.from_numpy(rp2, device="cpu")) == RC.encode_pyramid(rp2)


def test_container_levels_zero_and_extremes_equal_the_reference():
    rng = np.random.default_rng(9)
    rp = RL.dwt_fwd_nd(jnp.asarray(rng.integers(0, 9, (4, 4, 4)), jnp.int32), levels=0, ndim=3)
    tp = TL.PyramidND.from_numpy(rp, device="cpu")
    want = RC.encode_pyramid(rp, ndim=3)
    assert TC.encode_pyramid(tp, ndim=3) == want
    dec = TC.decode_pyramid(want, device="cpu")
    np.testing.assert_array_equal(TC.inverse_transform(dec).numpy(), np.asarray(rp.approx))
    with pytest.raises(ValueError, match="ndim"):
        TC.encode_pyramid(tp)  # levels=0 ND needs the hint
    ext = RL.WaveletPyramid(approx=jnp.asarray([[I32_MIN, I32_MAX, 0, -1]], jnp.int32),
                            details=(jnp.asarray([[I32_MAX, I32_MIN, 1]], jnp.int32),))
    assert TC.encode_pyramid(TL.WaveletPyramid.from_numpy(ext, device="cpu")) == RC.encode_pyramid(ext)
    x = jnp.full((64, 64), 123, jnp.int32)
    const = RK.dwt_fwd_2d_multi(x, levels=2)
    assert TC.encode_pyramid(TL.Pyramid2D.from_numpy(const, device="cpu")) == RC.encode_pyramid(const)


def test_container_rejects_what_the_reference_rejects():
    rp, tp, _ = _pyramids("1d", "cdf53", "paper", seed=10)
    bad = TL.WaveletPyramid(approx=tp.approx, details=(tp.details[0][..., :-1],) + tp.details[1:])
    with pytest.raises(ValueError, match="malformed pyramid"):
        TC.encode_pyramid(bad)
    with pytest.raises(TypeError):
        TC.encode_pyramid(TL.WaveletPyramid(approx=tp.approx.float(), details=tp.details))
    with pytest.raises(ValueError, match="parity requires"):
        TC.encode_pyramid(tp, version=1, parity=True)
    with pytest.raises(TCODEC.UnsupportedVersionError):
        TC.encode_pyramid(tp, version=3)
    with pytest.raises(ValueError, match="mode"):
        TC.encode_pyramid(tp, mode="nope")


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - the outcome IS the comparison
        return type(e).__name__, tuple(getattr(e, "band_status", ()))
    return "ok", tuple(out.band_status)


@pytest.mark.parametrize("fmt", _FORMATS, ids=lambda f: "-".join(f"{k}{v}" for k, v in f.items()))
def test_corruption_gives_the_same_typed_outcome(fmt):
    rp, tp, _ = _pyramids("2d", "cdf53", "jpeg2000", seed=11)
    blob = RC.encode_pyramid(rp, mode="jpeg2000", **fmt)
    assert TC.encode_pyramid(tp, mode="jpeg2000", **fmt) == blob
    h = RC._parse_header(blob)
    sites = [5, 12, h.body_off - 2, h.body_off + 3, h.body_off + h.blob_lens[0] + 1, len(blob) - 2]
    cases = [RINJ.flip_byte(blob, i) for i in sites]
    cases += [blob[:-5], blob[: h.body_off - 1], b"JUNK" + blob[4:]]
    if fmt.get("parity"):  # two damaged bands: parity cannot heal
        cases.append(RINJ.flip_byte(RINJ.flip_byte(blob, h.body_off + 1),
                                    h.body_off + h.blob_lens[0] + 1))
    if h.version == 2:
        cases.append(RINJ.flip_byte(blob, h.body_off + 1))
    for data in cases:
        assert _outcome(lambda: TC.decode_pyramid(data, device="cpu")) == _outcome(
            lambda: RC.decode_pyramid(data))
        assert _outcome(lambda: TC.decode_pyramid_partial(data, device="cpu")) == _outcome(
            lambda: RC.decode_pyramid_partial(data))


def _outcome_of(fn):
    """"ok", or the class name of what ``fn`` raised."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__
    return "ok"


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_checked_encode_certifies_like_the_reference(kind, monkeypatch):
    """``checked=`` encode raises IntegerOverflowError on exactly the
    pyramids the reference rejects: bands just inside and just outside
    the certificate's band envelope, by keyword and by the env toggle."""
    from repro.core import ranges as RR_

    _, tp, _ = _pyramids(kind, "97m", "jpeg2000", seed=12)
    levels = len(tp.details)
    nd = 1 if kind == "1d" else 2
    cert = RR_.range_certificate("97m", levels, np.int32, mode="jpeg2000", ndim=nd)
    for bump in (cert.band_hi, cert.band_hi + 1, cert.band_lo, cert.band_lo - 1):
        leaves = TC._leaves(tp)
        first = leaves[-1].clone()
        first.view(-1)[0] = bump
        if kind == "1d":
            pyr = TL.WaveletPyramid(approx=tp.approx, details=tp.details[:-1] + (first,))
            ref = RL.WaveletPyramid(approx=jnp.asarray(tp.approx.numpy()),
                                    details=tuple(jnp.asarray(d.numpy()) for d in pyr.details))
        else:
            last = tp.details[-1][:2] + (first,)
            pyr = TL.Pyramid2D(ll=tp.ll, details=tp.details[:-1] + (last,))
            ref = RL.Pyramid2D(ll=jnp.asarray(tp.ll.numpy()),
                               details=tuple(tuple(jnp.asarray(b.numpy()) for b in lvl)
                                             for lvl in pyr.details))
        kw = dict(scheme="97m", mode="jpeg2000")
        want = _outcome_of(lambda: RC.encode_pyramid(ref, checked=True, **kw))
        assert _outcome_of(lambda: TC.encode_pyramid(pyr, checked=True, **kw)) == want, bump
        assert want == ("ok" if cert.band_lo <= bump <= cert.band_hi else "IntegerOverflowError")
        monkeypatch.setenv("REPRO_DWT_CHECKED", "1")
        assert _outcome_of(lambda: TC.encode_pyramid(pyr, **kw)) == want
        monkeypatch.delenv("REPRO_DWT_CHECKED")
        if want == "ok":
            assert TC.encode_pyramid(pyr, checked=True, **kw) == RC.encode_pyramid(
                ref, checked=True, **kw)
        else:  # the check is skipped only when asked to be
            assert TC.encode_pyramid(pyr, checked=False, **kw) == RC.encode_pyramid(
                ref, checked=False, **kw)


def test_inverse_transform_runs_2d_and_names_what_is_not_ported():
    """Every container kind inverts where the reference inverts it: the
    2-D and (since the volume engine was ported) the N-D kind, with
    nothing left to name as not ported."""
    rp, tp, _ = _pyramids("2d", "97m", "paper", seed=13)
    dec = TC.decode_pyramid(RC.encode_pyramid(rp, scheme="97m"), device="cpu")
    np.testing.assert_array_equal(TC.inverse_transform(dec).numpy(),
                                  np.asarray(RC.inverse_transform(RC.decode_pyramid(
                                      RC.encode_pyramid(rp, scheme="97m")))))
    rp, _, _ = _pyramids("3d", "cdf53", "paper", seed=14)
    blob = RC.encode_pyramid(rp)
    np.testing.assert_array_equal(
        TC.inverse_transform(TC.decode_pyramid(blob, device="cpu")).numpy(),
        np.asarray(RC.inverse_transform(RC.decode_pyramid(blob))))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_1d_inverse_transform_equals_the_reference(scheme, mode):
    """A 1-D container decoded by the port and inverted on the CPU gives
    the reference's reconstruction, which is the input, for every scheme;
    the blobs are the reference's (both ways)."""
    rng = np.random.default_rng(19 + len(scheme))
    x = rng.integers(-4096, 4096, (3, 1003)).astype(np.int32)
    rp = RK.dwt_fwd(jnp.asarray(x), levels=4, mode=mode, scheme=scheme)
    blob = RC.encode_pyramid(rp, scheme=scheme, mode=mode)
    tp = TK.dwt_fwd(torch.from_numpy(x), levels=4, mode=mode, scheme=scheme)
    assert TC.encode_pyramid(tp, scheme=scheme, mode=mode) == blob
    got = TC.inverse_transform(TC.decode_pyramid(blob, device="cpu"))
    want = np.asarray(RC.inverse_transform(RC.decode_pyramid(blob)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x)


def test_batch_containers_equal_the_reference():
    rp, tp, _ = _pyramids("2d", "haar", "paper", seed=15)
    want = RC.encode_batch(rp, scheme="haar")
    assert TC.encode_batch(tp, scheme="haar") == want
    rows, rrows = TC.decode_batch(want, device="cpu"), RC.decode_batch(want)
    assert len(rows) == len(rrows) == 2
    for g, w in zip(rows, rrows):
        _assert_same_pyramid(g, w)
    single = TL.Pyramid2D(ll=tp.ll[0], details=tuple(tuple(b[0] for b in lvl) for lvl in tp.details))
    with pytest.raises(ValueError, match="leading batch dim"):
        TC.encode_batch(single)
    with pytest.raises(ValueError, match="not a batch container"):
        TC.decode_batch(TC.encode_pyramid(single), device="cpu")


# ---------------------------------------------------------------------------
# Progressive tiers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parity", [False, True])
def test_progressive_tiers_read_what_the_reference_reads(parity):
    rng = np.random.default_rng(16)
    x = jnp.asarray(rng.integers(-500, 500, (2, 32, 24)), jnp.int32)
    rp = RK.dwt_fwd_2d_multi(x, levels=3, scheme="cdf53", mode="jpeg2000")
    blob = RC.encode_batch(rp, mode="jpeg2000", parity=parity)
    r, t = RP.CountingReader(blob), TP.CountingReader(blob)
    want, got = RP.decode_lowband(r), TP.decode_lowband(t, device="cpu")
    np.testing.assert_array_equal(got.band.numpy(), np.asarray(want.band))
    assert (r.bytes_read, r.reads) == (t.bytes_read, t.reads) and t.bytes_read < len(blob)
    for lv in range(4):
        r, t = RP.CountingReader(blob), TP.CountingReader(blob)
        want, got = RP.decode_progressive(r, lv), TP.decode_progressive(t, lv, device="cpu")
        assert (r.bytes_read, r.reads) == (t.bytes_read, t.reads)
        assert got.levels == want.levels == lv and got.band_status == want.band_status
        _assert_same_pyramid(got.pyramid, want.pyramid)
        np.testing.assert_array_equal(TP.reconstruct(got).numpy(),
                                      np.asarray(RP.reconstruct(want)))
    for i in range(len(RP.read_header(blob).blob_lens)):
        np.testing.assert_array_equal(TP.decode_band(blob, i, device="cpu").band.numpy(),
                                      np.asarray(RP.decode_band(blob, i).band))
    assert TP.band_byte_ranges(TP.read_header(blob)) == RP.band_byte_ranges(RP.read_header(blob))
    # a damaged refinement band: heal, quarantine, raise — as the reference
    h = RP.read_header(blob)
    off, _ = RP.band_byte_ranges(h)[5]
    bad = RINJ.flip_byte(blob, off + 2)
    for kw in (dict(heal=True), dict(heal=False, partial=True), dict(heal=False)):
        assert _outcome(lambda: TP.decode_progressive(bad, 3, device="cpu", **kw)) == _outcome(
            lambda: RP.decode_progressive(bad, 3, **kw))
    np.testing.assert_array_equal(TP.decode_lowband(bad, heal=False, device="cpu").band.numpy(),
                                  np.asarray(RP.decode_lowband(bad, heal=False).band))


# ---------------------------------------------------------------------------
# Streams.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["cdf53", "haar"])
def test_2d_stream_bytes_equal_the_reference(scheme):
    rng = np.random.default_rng(17)
    img = rng.integers(-2000, 2000, (19, 12)).astype(np.int32)
    want = b"".join(RS.encode_volume(img, slab=8, levels=2, scheme=scheme))
    got = b"".join(TS.encode_volume(img, slab=8, levels=2, scheme=scheme, device="cpu"))
    assert got == want
    np.testing.assert_array_equal(TS.decode_volume(want, device="cpu").numpy(), img)
    np.testing.assert_array_equal(RS.decode_volume(got), img)
    chunks = [rng.integers(-99, 99, (2, 9, 13)).astype(np.int32) for _ in range(2)]
    enc_r = RS.StreamEncoder(levels=3, scheme=scheme, ndim=2)
    enc_t = TS.StreamEncoder(levels=3, scheme=scheme, ndim=2, device="cpu")
    data = b"".join(enc_r.encode(chunks))
    assert b"".join(enc_t.encode(chunks)) == data
    for a, b in zip(TS.decode_stream(data, device="cpu"), chunks):
        np.testing.assert_array_equal(a.numpy(), b)
    assert list(TS.iter_frames(data)) == list(RS.iter_frames(data))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_1d_stream_bytes_equal_the_reference(scheme):
    """WZRS streams of 1-D chunks (levels clamped per chunk, leading dims
    batched) are the reference's byte for byte, and each decodes in the
    other package to its chunk."""
    rng = np.random.default_rng(23)
    chunks = [rng.integers(-3000, 3000, shape).astype(np.int32)
              for shape in ((2, 64), (3, 37), (1, 5), (200,))]
    enc_r = RS.StreamEncoder(levels=3, scheme=scheme, mode="jpeg2000", ndim=1)
    enc_t = TS.StreamEncoder(levels=3, scheme=scheme, mode="jpeg2000", ndim=1, device="cpu")
    want = b"".join(enc_r.encode(chunks))
    got = b"".join(enc_t.encode(chunks))
    assert got == want
    for a, b in zip(TS.decode_stream(want, device="cpu"), chunks):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(RS.decode_stream(got), chunks):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_stream_errors_and_unported_dimensions():
    img = np.random.default_rng(18).integers(-99, 99, (4, 8)).astype(np.int32)
    data = b"".join(RS.encode_volume(img, slab=2, levels=1))
    with pytest.raises(TCODEC.TruncatedStreamError):
        list(TS.decode_stream(data[:-6], device="cpu"))
    with pytest.raises(TCODEC.CorruptHeaderError, match="magic"):
        list(TS.decode_stream(b"XXXX" + data[4:], device="cpu"))
    with pytest.raises(TypeError, match="integer"):
        TS.StreamEncoder(levels=1, device="cpu").encode_frame(np.ones((8, 8), np.float32))
    with pytest.raises(ValueError, match="ndim"):
        TS.StreamEncoder(levels=1, ndim=0, device="cpu")
    for ndim in (1, 3):  # 1-D and N-D frames are ported
        TS.StreamEncoder(levels=1, ndim=ndim, device="cpu")


def test_package_exports_match_the_reference():
    import repro.codec as R

    assert sorted(TCODEC.__all__) == sorted(R.__all__)
    assert TCODEC.BLOCK_VALUES == R.BLOCK_VALUES
    for name in ("CodecError", "CorruptBandError", "CorruptHeaderError",
                 "TruncatedStreamError", "UnsupportedVersionError"):
        assert issubclass(getattr(TCODEC, name), ValueError)
