"""The port's tensor-codec math (``repro_torch.core.compression``) against
the reference ``repro.core.compression``.

The same seeded float32 inputs (numpy) go through both packages on the
CPU (the kernels' plain versions on the port's side); every integer
output must be equal, every dequantized float32 output equal with
``assert_array_equal``, every byte count equal.  ``_band_shift`` follows
the exact rule (the smallest ``sh`` with ``fl32(max(amax, 1) / limit) <=
2**sh``) held here by a numpy mirror; the reference's
``ceil(log2(.))`` agrees with it wherever XLA's ``log2`` is correctly
rounded (ROADMAP.md Queue 3, "Decisions in force").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as RC
from repro_torch.core import compression as TC

LEVELS = 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(0.01, 3.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# Quantization.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4097,), (33, 7), (4, 5, 6)])
def test_quantize_dequantize_and_scale_equal_the_reference(shape):
    g = _inputs(shape, seed=len(shape))
    rs, ts = RC.tensor_scale(jnp.asarray(g)), TC.tensor_scale(_t(g))
    _eq(ts, rs)
    rq, tq = RC.quantize(jnp.asarray(g), rs), TC.quantize(_t(g), ts)
    _eq(tq, rq)
    _eq(TC.dequantize(tq, ts), RC.dequantize(rq, rs))
    # a Python-float scale takes the same float32 division
    _eq(TC.quantize(_t(g), float(rs)), RC.quantize(jnp.asarray(g), float(rs)))
    # the certificate clamp (97m at depth narrows the limit)
    for scheme, levels in (("cdf53", 3), ("97m", 6)):
        _eq(TC.quantize(_t(g * 1e4), ts, scheme=scheme, levels=levels),
            RC.quantize(jnp.asarray(g * 1e4), rs, scheme=scheme, levels=levels))


def test_quantize_divides_like_the_reference_where_the_reciprocal_does_not():
    """x / scale is a float32 division by the float32 scale: the reciprocal
    form (how a CUDA divide by a Python scalar runs) differs here."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(1 << 20) * 7).astype(np.float32)
    scale = np.float32(np.abs(x).max() / 32767)
    want = np.round(x / scale)
    got = TC.divide_f32(_t(x), float(scale)).round().numpy()
    np.testing.assert_array_equal(got, want)
    recip = np.round(x * (np.float32(1) / scale))
    assert (recip != want).sum() > 0  # the form the port must not take


# ---------------------------------------------------------------------------
# _band_shift: the exact rule.
# ---------------------------------------------------------------------------


def _exact_shift(amax: np.ndarray, limit: int) -> np.ndarray:
    """numpy mirror: smallest sh in 0..30 with fl32(fl32(max(amax,1)) /
    limit) <= 2**sh (30 if none)."""
    q = np.maximum(amax.astype(np.float32), np.float32(1)) / np.float32(limit)
    fits = q[:, None] <= (np.float32(2) ** np.arange(31, dtype=np.float32))[None, :]
    return np.where(fits.any(axis=1), fits.argmax(axis=1), 30).astype(np.int32)


def _boundary_amax(limit: int) -> np.ndarray:
    """Every integer within 300 of limit * 2**k (k = 0..30) that fits int32."""
    vals = set()
    for k in range(31):
        c = limit * 2**k
        vals.update(v for v in range(c - 300, c + 301) if 0 <= v < 2**31)
    return np.array(sorted(vals), np.int64)


@pytest.mark.parametrize("limit", [127, 32767])
def test_band_shift_is_exact_at_every_power_of_two_boundary(limit):
    amax = _boundary_amax(limit)
    want = _exact_shift(amax, limit)
    # bands whose max |value| is amax, either sign
    bands = np.stack([amax, -amax // 3], axis=1).astype(np.int32)
    got = np.array([int(TC._band_shift(torch.from_numpy(b), limit)) for b in bands])
    np.testing.assert_array_equal(got, want)
    # the reference on the same bands: it takes one less wherever XLA's
    # log2 rounds a quotient just above 2**sh down to sh (1,181 of these
    # 13,938 values at limit 127, 587 of 10,217 at 32767, vmapped), and
    # nowhere else
    ref = np.asarray(jax.vmap(lambda b: RC._band_shift(b, limit))(jnp.asarray(bands)))
    off = ref != want
    np.testing.assert_array_equal(want[off], ref[off] + 1)
    q = np.maximum(amax.astype(np.float32), np.float32(1)) / np.float32(limit)
    above = q[off].astype(np.float64) / 2.0 ** ref[off] - 1
    assert np.all((above > 0) & (above < 2.0**-16)), above.max()


def test_band_shift_equals_the_reference_on_seeded_bands():
    rng = np.random.default_rng(11)
    amax = np.concatenate([rng.integers(0, 2**31 - 1, 20000),
                           rng.integers(0, 70000, 20000)]).astype(np.int64)
    bands = np.stack([amax, -(amax // 2)], axis=1).astype(np.int32)
    for limit in (127, 32767):
        ref = np.asarray(jax.vmap(lambda b: RC._band_shift(b, limit))(jnp.asarray(bands)))
        want = _exact_shift(amax, limit)
        keep = ref == want  # away from XLA's misrounded values
        assert keep.mean() > 0.999
        got = torch.stack([TC._band_shift(torch.from_numpy(b), limit)
                           for b in bands[keep][:4000]]).numpy()
        np.testing.assert_array_equal(got, ref[keep][:4000])


# ---------------------------------------------------------------------------
# The codecs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["cdf53", "haar"])
def test_lowband_codec_equals_the_reference(scheme):
    g = _inputs((2, 24, 40), seed=3)
    rs, ts = RC.tensor_scale(jnp.asarray(g)), TC.tensor_scale(_t(g))
    rb = RC.compress_lowband(jnp.asarray(g), rs, LEVELS, scheme=scheme)
    tb = TC.compress_lowband(_t(g), ts, LEVELS, scheme=scheme)
    _eq(tb.low, rb.low)
    assert (tb.n, tb.levels) == (rb.n, rb.levels)
    _eq(TC.decompress_lowband(tb, g.shape, scheme=scheme),
        RC.decompress_lowband(rb, g.shape, scheme=scheme))
    _eq(TC.lossy_roundtrip(_t(g), LEVELS, scheme=scheme),
        RC.lossy_roundtrip(jnp.asarray(g), LEVELS, scheme=scheme))
    for shape in [(100,), (33, 7), (4, 5, 6)]:
        assert TC.compression_ratio(shape, 3) == RC.compression_ratio(shape, 3)


@pytest.mark.parametrize("mode", ["paper", "jpeg2000"])
def test_band_quantized_codec_equals_the_reference(mode):
    g = _inputs((3, 100), seed=4)
    rs, ts = RC.tensor_scale(jnp.asarray(g)), TC.tensor_scale(_t(g))
    ra, rd, rn = RC.forward_bands(jnp.asarray(g), rs, LEVELS, mode)
    ta, td, tn = TC.forward_bands(_t(g), ts, LEVELS, mode)
    _eq((ta, td), (ra, rd))
    assert tn == rn
    rsh, tsh = RC.band_shifts(ra, rd), TC.band_shifts(ta, td)
    _eq(tsh, rsh)
    rq = RC.compress_bands(jnp.asarray(g), rs, LEVELS, mode)
    tq = TC.compress_bands(_t(g), ts, LEVELS, mode)
    _eq((tq.approx, tq.details, tq.approx_shift, tq.detail_shifts),
        (rq.approx, rq.details, rq.approx_shift, rq.detail_shifts))
    _eq(TC.decompress_bands(tq, g.shape, mode), RC.decompress_bands(rq, g.shape, mode))
    # caller-supplied shifts and summed int32 bands (the pod sync's form)
    big = (jnp.asarray(np.array(rsh[0]) + 2), tuple(s + 1 for s in rsh[1]))
    tbig = (torch.tensor(int(big[0]), dtype=torch.int32),
            tuple(torch.tensor(int(s), dtype=torch.int32) for s in big[1]))
    rq2 = RC.compress_bands(jnp.asarray(g), rs, LEVELS, mode, shifts=big)
    tq2 = TC.compress_bands(_t(g), ts, LEVELS, mode, shifts=tbig)
    _eq((tq2.approx, tq2.details), (rq2.approx, rq2.details))
    r_sum = rq2.approx.astype(jnp.int32) * 2
    t_sum = tq2.approx.to(torch.int32) * 2
    _eq(TC.decompress_bands(tq2, g.shape, mode, approx_i32=t_sum),
        RC.decompress_bands(rq2, g.shape, mode, approx_i32=r_sum))
    _eq(TC.band_quantized_roundtrip(_t(g), LEVELS, mode),
        RC.band_quantized_roundtrip(jnp.asarray(g), LEVELS, mode))


@pytest.mark.parametrize("shape", [(3, 100), (5,), ()])
def test_last_axis_codec_equals_the_reference(shape):
    g = _inputs(shape, seed=5) if shape else np.float32(1.25)
    levels = 1 if shape == () else LEVELS
    if shape == ():
        with pytest.raises(ValueError):
            TC.forward_bands_nd(_t(g), TC.tensor_scale(_t(g)), levels)
        return
    rs, ts = RC.tensor_scale(jnp.asarray(g)), TC.tensor_scale(_t(g))
    rp = RC.forward_bands_nd(jnp.asarray(g), rs, levels)
    tp = TC.forward_bands_nd(_t(g), ts, levels)
    _eq((tp.approx, tp.details), (rp.approx, rp.details))
    rsh, tsh = RC.pyramid_shifts(rp), TC.pyramid_shifts(tp)
    _eq(tsh, rsh)
    ra, rd = RC.quantize_pyramid(rp, rsh)
    ta, td = TC.quantize_pyramid(tp, tsh)
    _eq((ta, td), (ra, rd))
    _eq(TC.decompress_bands_nd(ta.to(torch.int32), tuple(d.to(torch.int32) for d in td),
                               tsh, ts, g.shape),
        RC.decompress_bands_nd(ra.astype(jnp.int32), tuple(d.astype(jnp.int32) for d in rd),
                               rsh, rs, g.shape))


@pytest.mark.parametrize("scheme", ["cdf53", "97m"])
def test_2d_codec_equals_the_reference(scheme):
    g = _inputs((2, 24, 40), seed=6)
    rs, ts = RC.tensor_scale(jnp.asarray(g)), TC.tensor_scale(_t(g))
    rp = RC.forward_pyramid_2d(jnp.asarray(g), rs, LEVELS, scheme=scheme)
    tp = TC.forward_pyramid_2d(_t(g), ts, LEVELS, scheme=scheme)
    _eq((tp.ll, tp.details), (rp.ll, rp.details))
    rsh, tsh = RC.pyramid2d_shifts(rp), TC.pyramid2d_shifts(tp)
    _eq(tsh, rsh)
    _eq(TC.quantize_pyramid_2d(tp, tsh), RC.quantize_pyramid_2d(rp, rsh))
    _eq(TC.band_quantized_roundtrip_2d(_t(g), LEVELS, scheme=scheme),
        RC.band_quantized_roundtrip_2d(jnp.asarray(g), LEVELS, scheme=scheme))


@pytest.mark.parametrize("scheme", ["cdf53", "cdf22"])
def test_nd_codec_equals_the_reference(scheme):
    g = _inputs((2, 8, 12, 16), seed=7)
    rs, ts = RC.tensor_scale(jnp.asarray(g)), TC.tensor_scale(_t(g))
    rp = RC.forward_pyramid_nd(jnp.asarray(g), rs, LEVELS, scheme=scheme)
    tp = TC.forward_pyramid_nd(_t(g), ts, LEVELS, scheme=scheme)
    _eq((tp.approx, tp.details), (rp.approx, rp.details))
    rsh, tsh = RC.pyramid_nd_shifts(rp), TC.pyramid_nd_shifts(tp)
    _eq(tsh, rsh)
    _eq(TC.quantize_pyramid_nd(tp, tsh), RC.quantize_pyramid_nd(rp, rsh))
    _eq(TC.band_quantized_roundtrip_nd(_t(g), LEVELS, scheme=scheme),
        RC.band_quantized_roundtrip_nd(jnp.asarray(g), LEVELS, scheme=scheme))


def test_analytic_band_bytes_equal_the_reference():
    for n in (1, 7, 4096, 65536, 65537, 300000):
        for levels in (1, 2, 3):
            assert TC.band_bytes(n, levels) == RC.band_bytes(n, levels)
    for h, w in ((24, 40), (7, 9), (2048, 5632)):
        assert TC.band_bytes_2d(h, w, 2) == RC.band_bytes_2d(h, w, 2)
    for shape in ((8, 12, 16), (2048, 32, 64), (5, 9, 4)):
        assert TC.band_bytes_nd(shape, 2) == RC.band_bytes_nd(shape, 2)


def test_encoded_bytes_and_ratios_equal_the_reference():
    g1 = _inputs((3, 100), seed=8)
    g2 = _inputs((2, 24, 40), seed=9)
    g3 = _inputs((2, 8, 12, 16), seed=10)
    assert TC.encoded_bytes(_t(g1), LEVELS) == RC.encoded_bytes(jnp.asarray(g1), LEVELS)
    assert TC.encoded_bytes_last_axis(_t(g1), LEVELS) == RC.encoded_bytes_last_axis(
        jnp.asarray(g1), LEVELS)
    assert TC.encoded_bytes_2d(_t(g2), LEVELS) == RC.encoded_bytes_2d(jnp.asarray(g2), LEVELS)
    assert TC.encoded_bytes_nd(_t(g3), LEVELS) == RC.encoded_bytes_nd(jnp.asarray(g3), LEVELS)
    assert TC.encoded_ratio(_t(g1), LEVELS) == RC.encoded_ratio(jnp.asarray(g1), LEVELS)
    assert TC.encoded_ratio_2d(_t(g2), LEVELS) == RC.encoded_ratio_2d(jnp.asarray(g2), LEVELS)
    assert TC.encoded_ratio_nd(_t(g3), LEVELS) == RC.encoded_ratio_nd(jnp.asarray(g3), LEVELS)


def test_codec_keeps_bfloat16_leaves_in_their_dtype():
    g = (np.random.default_rng(12).standard_normal((24, 40)) * 0.02).astype(np.float32)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    rb = jnp.asarray(g).astype(jnp.bfloat16)
    th, tres = TC.band_quantized_roundtrip_2d(gb, LEVELS)
    rh, rres = RC.band_quantized_roundtrip_2d(rb, LEVELS)
    assert th.dtype == torch.bfloat16
    np.testing.assert_array_equal(th.to(torch.float32).numpy(),
                                  np.asarray(rh.astype(jnp.float32)))
    _eq(tres, rres)


# ---------------------------------------------------------------------------
# Gradient-sync accounting (``train/grad_compress.py``).
# ---------------------------------------------------------------------------


def _grad_tree():
    return {
        "embed": _inputs((64, 96), seed=20),
        "layers": {"w": _inputs((2, 16, 8, 8), seed=21), "ln": _inputs((2, 64), seed=22)},
        "bias": _inputs((100,), seed=23),
        "conv": _inputs((6, 24, 24), seed=24),
    }


def _cfgs(RG, TG):
    for codec in ("bands", "lowband", "none"):
        for s2, s3 in ((False, False), (True, False), (False, True), (True, True)):
            if codec != "bands" and (s2 or s3):
                continue
            kw = dict(codec=codec, spatial_2d=s2, spatial_3d=s3, min_size=128)
            yield RG.WaveletSyncConfig(**kw), TG.WaveletSyncConfig(**kw)


def test_pod_byte_accounting_equals_the_reference():
    from repro.train import grad_compress as RG
    from repro_torch import tree as TTREE
    from repro_torch.train import grad_compress as TG

    tree = _grad_tree()
    rtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = TTREE.map_leaves(_t, tree)
    for rcfg, tcfg in _cfgs(RG, TG):
        assert [TG.leaf_route(p, tcfg) for p in TTREE.leaves(ttree)] == [
            RG.leaf_route(p, rcfg) for p in jax.tree_util.tree_leaves(rtree)]
        assert TG.pod_collective_bytes(ttree, tcfg) == RG.pod_collective_bytes(rtree, rcfg)
        assert TG.pod_encoded_bytes(ttree, tcfg) == RG.pod_encoded_bytes(rtree, rcfg)
    err = TG.init_error_feedback(ttree)
    assert [tuple(e.shape) for e in TTREE.leaves(err)] == [
        p.shape for p in jax.tree_util.tree_leaves(tree)]
    assert all(e.dtype == torch.float32 and not e.any() for e in TTREE.leaves(err))
    assert TG._can_2d(ttree["embed"], 6) == RG._can_2d(rtree["embed"], 6)
    assert TG._can_nd(ttree["conv"], 2) == RG._can_nd(rtree["conv"], 2)
