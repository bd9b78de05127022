"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Kernels written in CUDA have no CPU mode, so every test here is marked
``cuda`` and skips without a card.  This file imports no JAX (the card's
machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest names the reference's warning
classes, which import JAX).  ``chip_smoke.py`` runs the same comparisons
at the serve path's real sizes.
"""
import numpy as np
import pytest
import torch

from repro_torch import codec as TCODEC
from repro_torch import kernels as TK
from repro_torch.codec import rice as TR
from repro_torch.core import schemes as TS
from repro_torch.kernels import fused2d as TF
from repro_torch.kernels import tiled2d as TT
from repro_torch.serve import (
    ProgressiveServeRoute,
    TransformRequest,
    WaveletServeEngine,
    crop_result,
)

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)


@pytest.fixture
def cuda_device():
    """The card, or a skip: kernels written in CUDA have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there (chip_smoke.py)")
    return torch.device("cuda")


def _img(rng, shape, lo=-1000, hi=1000):
    return rng.integers(lo, hi, shape).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_cuda_kernels_match_plain_versions(name, mode, cuda_device):
    rng = np.random.default_rng(7)
    sch = TS.get_scheme(name)
    for hw in [(2, 2), (3, 3), (7, 9), (257, 383), (512, 512)]:
        for kind in ("rand", "min", "max"):
            x = _img(rng, (2,) + hw) if kind == "rand" else np.full(
                (2,) + hw, I32.min if kind == "min" else I32.max, np.int32)
            xt = torch.from_numpy(x).to(cuda_device)
            want = TF._fwd2d_math(xt, mode, name)
            for a, b in zip(TF.fwd2d_whole_cuda(xt, mode, name), want):
                assert torch.equal(a, b)
            assert torch.equal(TF.inv2d_whole_cuda(*want, mode, name),
                               TF._inv2d_math(*want, mode, name))
            if sch.can_window(hw[0]) and sch.can_window(hw[1]):
                for th, tw in ((4, 6), (64, 64)):
                    for a, b in zip(TT.fwd2d_tiled_cuda(xt, mode, th, tw, name),
                                    TT.fwd2d_tiled_plain(xt, mode, th, tw, name)):
                        assert torch.equal(a, b)
                    assert torch.equal(TT.inv2d_tiled_cuda(*want, mode, th, tw, name),
                                       TT.inv2d_tiled_plain(*want, mode, th, tw, name))
    torch.cuda.synchronize(cuda_device)


def _shifted(t, shift):
    """``t``, or a contiguous copy whose data starts 4 bytes past a 16-byte
    boundary (forcing the kernels' 4-byte loads and stores)."""
    if not shift:
        return t
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["cdf53", "97m", "haar"])
def test_cuda_tiled_kernel_branches_match_plain_versions(name, mode, cuda_device):
    """Every branch of csrc/tiled2d.cu: 16-byte and 4-byte loads and stores
    (W % 8 == 0, W % 4 == 0 only, odd W, tw % 8 != 0, pointers off a
    16-byte boundary), edge and interior tiles (3 x 3 tiles and more),
    tiny forced tiles, the default tile, and int32 extremes."""
    from repro_torch.kernels import backend as TB

    rng = np.random.default_rng(31)
    sch = TS.get_scheme(name)
    shapes = [(5, 8), (9, 12), (17, 16), (33, 20), (64, 64), (100, 132), (600, 520),
              (517, 389), (258, 264)]
    for hw in shapes:
        if not (sch.can_window(hw[0]) and sch.can_window(hw[1])):
            continue
        default = TB.pick_tile(*hw, sch.halo, cuda_device)
        for kind in ("rand", "min", "max"):
            x = _img(rng, (2,) + hw) if kind == "rand" else np.full(
                (2,) + hw, I32.min if kind == "min" else I32.max, np.int32)
            x[:, 1::5, ::3] = 7
            xt = torch.from_numpy(x).to(cuda_device)
            want = TF._fwd2d_math(xt, mode, name)
            for th, tw in {(4, 6), (4, 4), (6, 12), (16, 8), (64, 64), default}:
                for shift in (False, True):
                    got = TT.fwd2d_tiled_cuda(_shifted(xt, shift), mode, th, tw, name)
                    for a, b in zip(got, TT.fwd2d_tiled_plain(xt, mode, th, tw, name)):
                        assert torch.equal(a, b), (hw, kind, th, tw, shift)
                    bands = [_shifted(b, shift) for b in want]
                    assert torch.equal(TT.inv2d_tiled_cuda(*bands, mode, th, tw, name),
                                       TT.inv2d_tiled_plain(*want, mode, th, tw, name)), (
                        hw, kind, th, tw, shift)
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", [("cdf53", "jpeg2000"), ("97m", "paper")])
@pytest.mark.parametrize("side", [1024, 2048])
def test_cuda_tiled_serve_batches_match_plain_versions(name, mode, side, cuda_device):
    """The serve route's 8-slot batches at the default tile, and a level of
    their pyramids through the dispatcher."""
    from repro_torch.kernels import backend as TB

    sch = TS.get_scheme(name)
    xt = torch.randint(-(1 << 15), 1 << 15, (8, side, side), dtype=torch.int32,
                       device=cuda_device)
    th, tw = TB.pick_tile(side, side, sch.halo, cuda_device)
    assert tw == 128
    # the plain version crops the tiled bands: views
    want = [b.contiguous() for b in TT.fwd2d_tiled_plain(xt, mode, th, tw, name)]
    for a, b in zip(TT.fwd2d_tiled_cuda(xt, mode, th, tw, name), want):
        assert torch.equal(a, b)
    assert torch.equal(TT.inv2d_tiled_cuda(*want, mode, th, tw, name), xt)
    assert TK.plan_2d(side, side, cuda_device, name) == "tiled-cuda"
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
def test_cuda_pyramid_launches_every_kernel(cuda_device):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_img(rng, (2, 512, 512), -128, 128)).to(cuda_device)
    TK.launches.reset()
    pyr = TK.dwt_fwd_2d_multi(x, levels=3, scheme="cdf53", mode="jpeg2000")
    y = TK.dwt_inv_2d_multi(pyr, scheme="cdf53", mode="jpeg2000")
    assert torch.equal(y, x)
    counts = TK.launches.snapshot()
    assert all(counts.get(k, 0) > 0 for k in
               ("tiled2d_fwd", "tiled2d_inv", "whole2d_fwd", "whole2d_inv")), counts


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_cuda_whole2d_chain_matches_plain_versions(name, mode, cuda_device):
    """The whole-image cluster kernels over chains of 1-3 levels at every
    cluster size a chain admits (and the plan's own, and the two passes
    for one level): 2 x 2, 3 x 3, odd sizes, H < 2c, B from 1 to 8, int32
    extremes, and an image whose rows start 4 bytes past a 16-byte
    boundary."""
    rng = np.random.default_rng(31)
    sch = TS.get_scheme(name)
    shapes = [(1, 2, 2), (2, 3, 3), (3, 7, 9), (8, 128, 128), (1, 130, 3), (2, 33, 17),
              (4, 64, 5), (5, 40, 41)]
    seen = set()
    for shp in shapes:
        bsz, h, w = shp
        for kind in ("rand", "min", "max") if shp in ((2, 3, 3), (2, 33, 17)) else ("rand",):
            x = _img(rng, shp) if kind == "rand" else np.full(
                shp, I32.min if kind == "min" else I32.max, np.int32)
            xt = torch.from_numpy(x).to(cuda_device)
            hh, ww, levels = h, w, 0
            while hh >= 2 and ww >= 2 and levels < 3:
                levels, hh, ww = levels + 1, (hh + 1) // 2, (ww + 1) // 2
            for n in range(1, levels + 1):
                ll, details = TF.fwd2d_chain_plain(xt, n, mode, name)
                sizes = [None] + [c for c in range(0 if n == 1 else 1, 17)
                                  if c == 0 or TF.chain_fits(h, w, n, c, cuda_device)]
                for c in sizes:
                    for shift in (0, 1) if c is None else (0,):
                        src = _shifted(xt, shift)
                        fplan, iplan = (TF._chain_plan(bsz, h, w, n, sch, mode, inv,
                                                       xt.device, c) for inv in (False, True))
                        got_ll, got = TF._run_fwd(src, fplan)
                        assert torch.equal(got_ll, ll), (shp, kind, n, c)
                        for g, want in zip(got, details):
                            assert all(torch.equal(a, b) for a, b in zip(g, want)), (shp, n, c)
                        back = TF._run_inv(ll, details[::-1], iplan)
                        assert torch.equal(back, xt), (shp, kind, n, c)
                        seen.add(c)
    torch.cuda.synchronize(cuda_device)
    assert seen >= set(range(17)) | {None}


@pytest.mark.cuda
def test_cuda_whole2d_refuses_what_it_cannot_run(cuda_device):
    """A cluster size the chain or the card cannot take raises; nothing
    falls back to fewer blocks or to the plain version.  A 3 x 60001
    cdf22 image (rows longer than a block's shared memory) keeps the two
    passes; a 60001 x 3 one splits its rows over 16 blocks."""
    from repro_torch.kernels import _build

    sch = TS.get_scheme("cdf53")

    def forced(t, levels, c):
        plan = TF._chain_plan(*t.shape, levels, sch, "paper", False, t.device, c)
        return TF._run_fwd(t, plan)

    x = torch.zeros((1, 5, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(_build.KernelLaunchError):  # 16 blocks, 3 row groups
        forced(x, 1, 16)
    with pytest.raises(_build.KernelLaunchError):  # 2 levels: groups of 4 rows, 2 of them
        forced(x, 2, 3)
    with pytest.raises(_build.KernelLaunchError):
        forced(x, 1, 17)
    big = torch.zeros((1, 300, 1000), dtype=torch.int32, device=cuda_device)
    with pytest.raises(_build.KernelLaunchError):  # shares of 600,000 bytes
        forced(big, 1, 2)
    assert not TF.chain_fits(300, 1000, 1, 2, cuda_device)
    assert all(TF.chain_fits(128, 128, 2, c, cuda_device) for c in TF.CLUSTER_SIZES)
    rng = np.random.default_rng(37)
    for shp, runs in (((1, 3, 60001), ((1, 0),)), ((1, 60001, 3), ((1, 16),))):
        assert TF.chain_launches(*shp, 1, cuda_device) == runs
        xt = torch.from_numpy(_img(rng, shp)).to(cuda_device)
        want = TF._fwd2d_math(xt, "paper", "cdf22")
        TK.launches.reset()
        for a, b in zip(TF.fwd2d_whole_cuda(xt, "paper", "cdf22"), want):
            assert torch.equal(a, b)
        assert torch.equal(TF.inv2d_whole_cuda(*want, "paper", "cdf22"), xt)
        assert TK.launches.snapshot() == {"whole2d_fwd": 1, "whole2d_inv": 1}
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name,side,levels,whole,launches", [
    ("cdf53", 1024, 5, 2, 1), ("cdf53", 2048, 5, 1, 1), ("cdf53", 256, 5, 4, 1),
    ("cdf22", 1024, 5, 5, 2),  # level 1 past 16 blocks: two passes, then one chain
])
def test_cuda_pyramid_runs_its_whole_levels_in_one_launch(name, side, levels, whole, launches,
                                                          cuda_device):
    """Every maximal run of whole-image levels is one launch each way (a
    level no cluster holds one more), bit-equal to the plain pyramid."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy(_img(rng, (2, side, side), -128, 128)).to(cuda_device)
    assert sum(TK.plan_2d(side >> k, side >> k, cuda_device, name) == "whole-cuda"
               for k in range(levels)) == whole
    TK.launches.reset()
    pyr = TK.dwt_fwd_2d_multi(x, levels=levels, scheme=name, mode="jpeg2000")
    assert TK.launches.snapshot()["whole2d_fwd"] == launches
    want = TF._lift.dwt_fwd_2d_multi(x, levels=levels, scheme=name, mode="jpeg2000",
                                     checked=False)
    assert torch.equal(pyr.ll, want.ll)
    for a, b in zip(pyr.details, want.details):
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    TK.launches.reset()
    assert torch.equal(TK.dwt_inv_2d_multi(pyr, scheme=name, mode="jpeg2000"), x)
    assert TK.launches.snapshot()["whole2d_inv"] == launches


@pytest.mark.cuda
def test_cuda_engine_serves_what_the_cpu_engine_serves(cuda_device):
    rng = np.random.default_rng(9)
    images = [_img(rng, s, -128, 128) for s in [(300, 300), (256, 256), (200, 280), (64, 64)]]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = WaveletServeEngine(buckets=[(64, 64), (300, 300)], batch_slots=2, levels=3,
                                 device=dev)
        done = eng.run([TransformRequest(uid=i, image=im) for i, im in enumerate(images)])
        out[dev] = sorted(done, key=lambda r: r.uid)
    for c, g in zip(out["cpu"], out["cuda"]):
        for a, b in zip([c.pyramid.ll] + [t for lvl in c.pyramid.details for t in lvl],
                        [g.pyramid.ll] + [t for lvl in g.pyramid.details for t in lvl]):
            assert torch.equal(a, b.cpu())
        xr = crop_result(TK.dwt_inv_2d_multi(g.pyramid), g)
        assert torch.equal(xr.cpu(), torch.from_numpy(g.image))


def _rice_bands(rng):
    tie = np.concatenate([np.full(128, -1), np.full(128, 1)])
    return {
        "zeros": np.zeros(1000), "const7": np.full(513, 7), "min": np.full(300, I32.min),
        "max": np.full(300, I32.max), "one": np.array([0]), "ramp": np.arange(-640, 640),
        "ties": np.tile(tie, 3)[:700], "partial": rng.integers(-3000, 3000, 3 * 256 + 77),
        "full_range": rng.integers(I32.min, I32.max, 5000, dtype=np.int64),
        "long": rng.integers(-40, 40, 4096 * 256 + 5),
    }


def _check_rice_decode(coded, x, dev):
    """Decode one band's coding with the kernel and the plain version:
    both must give back the input exactly."""
    out = TR.decode_band(*coded, x.numel(), device=dev)
    assert torch.equal(out, x)
    if x.numel():
        plain = TR.decode_band_plain(coded[0], coded[1].astype(np.int64),
                                     coded[2].astype(np.int64), x.numel(), device=dev)
        assert torch.equal(plain[: x.numel()], x)


@pytest.mark.cuda
def test_cuda_rice_kernels_match_plain_versions(cuda_device):
    rng = np.random.default_rng(10)
    bands = {name: torch.from_numpy(np.asarray(vals).astype(np.int32)).to(cuda_device)
             for name, vals in _rice_bands(rng).items()}
    for name, x in bands.items():
        want = TR.encode_band_plain(x.cpu())
        payload, tables = TR.rice_encode_cuda([x])
        offs, ks, lens = TR.tables_to_host(tables, 1)
        assert list(offs) == [0, len(want[0])], name
        assert payload[: offs[-1]].cpu().numpy().tobytes() == want[0], name
        assert np.array_equal(ks, want[1]) and np.array_equal(lens, want[2]), name
        got = TR.encode_band(x)
        assert got[0] == want[0], name
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2]), name
        _check_rice_decode(got, x, cuda_device)
    # every band at once, with empty bands among them: one launch
    listed = [torch.zeros(0, dtype=torch.int32, device=cuda_device)] + list(bands.values())
    listed.insert(4, listed[0])
    TK.launches.reset()
    got = TR.encode_bands(listed)
    assert TK.launches.snapshot() == {"rice_encode": 1}
    for g, x in zip(got, listed):
        want = TR.encode_band_plain(x.cpu())
        assert g[0] == want[0]
        assert np.array_equal(g[1], want[1]) and np.array_equal(g[2], want[2])
        _check_rice_decode(g, x, cuda_device)
    TK.launches.reset()
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    assert TR.encode_band(empty)[0] == b""  # no block: no launch
    coded = TR.encode_bands([empty, empty])
    assert [c[0] for c in coded] == [b"", b""] and all(c[1].size == c[2].size == 0 for c in coded)
    assert TK.launches.snapshot().get("rice_encode", 0) == 0
    assert TR.decode_band(b"", np.zeros(0, np.uint8), np.zeros(0, np.uint16), 0,
                          device=cuda_device).numel() == 0
    torch.cuda.synchronize(cuda_device)


def _plain_bands(blob, dev):
    """Every band of a container decoded by the plain version on ``dev``."""
    from repro_torch.codec import container as TC

    h = TC._parse_header(blob)
    blobs, _ = TC._band_blobs(blob, h)
    shapes = TC._expected_band_shapes(h.kind, h.shape, h.levels)
    out = []
    for b, shp in zip(blobs, shapes):
        c = TC._band_coding(b, TC._band_count(h, shp))
        out.append(TR.decode_band_plain(c.payload, c.ks, c.lens, c.count, device=dev)[: c.count])
    return out


def _leaves(pyr):
    if hasattr(pyr, "ll"):
        return [pyr.ll] + [b for lvl in pyr.details for b in lvl]
    return [pyr.approx] + [b for lvl in pyr.details for b in lvl]


@pytest.mark.cuda
def test_cuda_rice_decode_is_one_launch_a_container_equal_to_the_plain_version(cuda_device):
    from repro_torch.codec import stream as TSTREAM

    rng = np.random.default_rng(13)
    x2 = torch.from_numpy(_img(rng, (4, 256, 256), -128, 128)).to(cuda_device)
    x3 = torch.from_numpy(_img(rng, (2, 16, 64, 64), -2048, 2048)).to(cuda_device)
    for pyr, kw in ((TK.dwt_fwd_2d_multi(x2, levels=5, mode="jpeg2000"), {}),
                    (TK.dwt_fwd_nd(x3, levels=3, mode="jpeg2000"), dict(ndim=3))):
        blob = TCODEC.encode_batch(pyr, mode="jpeg2000", **kw)
        TK.launches.reset()
        dec = TCODEC.decode_pyramid(blob, device=cuda_device)
        assert TK.launches.snapshot() == {"rice_decode": 1}
        for got, plain, band in zip(_leaves(dec.pyramid), _plain_bands(blob, cuda_device),
                                    _leaves(pyr)):
            assert torch.equal(got.reshape(-1), plain) and torch.equal(got, band)
    vol = _img(rng, (12, 40, 36), -2048, 2048)
    data = b"".join(TSTREAM.encode_volume(vol, slab=4, levels=2, device=cuda_device))
    frames = list(TSTREAM.iter_frames(data))
    TK.launches.reset()
    got = list(TSTREAM.decode_stream(data, device=cuda_device))
    assert TK.launches.snapshot().get("rice_decode") == len(frames) == 3
    for frame in frames:
        dec = TCODEC.decode_pyramid(frame, device=cuda_device)
        for band, plain in zip(_leaves(dec.pyramid), _plain_bands(frame, cuda_device)):
            assert torch.equal(band.reshape(-1), plain)
    assert torch.equal(torch.cat(got).cpu(), torch.from_numpy(vol))


def _malformed_blocks(rng):
    """(bytes, k) of blocks no encoder writes whose tables pass the host
    checks: all escapes, under 5 bytes, 65,535 bytes of garbage, codes
    running past the bytes, random bytes at every k."""
    ff = b"\xff"
    blocks = [(ff * 1280, 3), (ff * 200, 0)] + [(ff * n, 5) for n in range(5)]
    blocks += [(rng.bytes(n), int(rng.integers(TR.K_MAX + 1))) for n in range(1, 5)]
    garbage = rng.bytes(65535)
    blocks += [(garbage, 0), (garbage, 7), (rng.bytes(40), TR.K_MAX), (ff * 6 + bytes(3), 0)]
    return blocks + [(rng.bytes(int(rng.integers(1, 1400))), k) for k in range(TR.K_MAX + 1)]


@pytest.mark.cuda
def test_cuda_rice_decode_of_malformed_blocks_equals_the_serial_decode(cuda_device):
    rng = np.random.default_rng(14)
    blocks = _malformed_blocks(rng)
    groups = [[b] for b in blocks] + [blocks]
    items = [(b"".join(b for b, _ in g), np.array([k for _, k in g], np.uint8),
              np.array([len(b) for b, _ in g], np.uint16), 256 * len(g) - 17 * (len(g) > 1))
             for g in groups]
    TK.launches.reset()
    got = TR.decode_bands(items, device=cuda_device)
    assert TK.launches.snapshot() == {"rice_decode": 1}
    for g, it, v in zip(groups, items, got):
        want = np.concatenate([TR.decode_block_serial(b, k) for b, k in g])[: it[3]]
        np.testing.assert_array_equal(v.cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_rice_decode_quarantines_a_band_and_decodes_the_rest(cuda_device):
    from repro_torch.codec import container as TC

    rng = np.random.default_rng(15)
    x = torch.from_numpy(_img(rng, (2, 64, 64), -128, 128)).to(cuda_device)
    pyr = TK.dwt_fwd_2d_multi(x, levels=3)
    blob = bytearray(TCODEC.encode_pyramid(pyr, version=1, checksum=False))
    h = TC._parse_header(bytes(blob))
    bad = 2
    blob[h.body_off + sum(h.blob_lens[:bad])] = 200  # band 2's first k: past K_MAX
    TK.launches.reset()
    dec = TCODEC.decode_pyramid_partial(bytes(blob), device=cuda_device)
    assert TK.launches.snapshot() == {"rice_decode": 1}
    assert dec.band_status[bad] == "corrupt"
    assert [s for i, s in enumerate(dec.band_status) if i != bad] == ["ok"] * (len(h.blob_lens) - 1)
    for i, (got, want) in enumerate(zip(_leaves(dec.pyramid), _leaves(pyr))):
        assert torch.equal(got, torch.zeros_like(want) if i == bad else want), i


@pytest.mark.cuda
def test_cuda_encoded_engine_serves_what_the_cpu_engine_serves(cuda_device):
    rng = np.random.default_rng(11)
    images = [_img(rng, s, -128, 128) for s in [(300, 300), (256, 256), (200, 280), (64, 64),
                                                 (50, 60)]]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = WaveletServeEngine(buckets=[(64, 64), (300, 300)], batch_slots=2, levels=3,
                                 device=dev, encode_response=True)
        eng.warmup()
        TK.launches.reset()
        done = eng.run([TransformRequest(uid=i, image=im) for i, im in enumerate(images)])
        out[dev] = sorted(done, key=lambda r: r.uid)
    assert TK.launches.snapshot().get("rice_encode", 0) > 0
    assert "rice_compact" not in TK.launches.snapshot()
    route = ProgressiveServeRoute(device=cuda_device)
    for c, g in zip(out["cpu"], out["cuda"]):
        assert g.error is None and g.encoded == c.encoded and g.batch_index == c.batch_index
        row = TCODEC.decode_batch(g.encoded, device=cuda_device)[g.batch_index]
        xr = crop_result(TK.dwt_inv_2d_multi(row, mode="paper"), g)
        assert torch.equal(xr.cpu(), torch.from_numpy(g.image))
        route.store(g)
        assert torch.equal(route.full(g.uid).cpu(), torch.from_numpy(g.image))
        assert torch.equal(route.thumbnail(g.uid).cpu(),
                           g.pyramid.ll.cpu()[tuple(slice(0, s) for s in
                                                    route.tiers(g.uid)[0])])
    assert TK.launches.snapshot().get("rice_decode", 0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_cuda_1d_kernels_match_plain_versions(name, mode, cuda_device):
    """Windowed 1-D kernels and the row pass against their plain versions
    (n = 2..40 and long odd lines, int32 extremes, forced tiny tiles)."""
    from repro_torch.kernels import dwt53 as TD

    rng = np.random.default_rng(12)
    sch = TS.get_scheme(name)
    for n in list(range(2, 41)) + [1001, 65537]:
        for kind in ("rand", "min", "max"):
            x = _img(rng, (3, n)) if kind == "rand" else np.full(
                (3, n), I32.min if kind == "min" else I32.max, np.int32)
            xt = torch.from_numpy(x).to(cuda_device)
            s0, d0 = TS.lift_fwd_axis(xt, sch, axis=-1, mode=mode)
            for a, b in zip(TD.rows_fwd_cuda(xt, mode, name), (s0, d0)):
                assert torch.equal(a, b), (n, kind)
            assert torch.equal(TD.rows_inv_cuda(s0, d0, mode, name),
                               TS.lift_inv_axis(s0, d0, sch, axis=-1, mode=mode))
            if not sch.can_window(n):
                continue
            for rb, bp in ((1, 1), (2, 3), (3, 1024)):
                for a, b in zip(TD.lift_fwd_windows_cuda(xt, mode, rb, bp, name),
                                TD.lift_fwd_windows_plain(xt, mode, bp, name)):
                    assert torch.equal(a, b), (n, kind, rb, bp)
                assert torch.equal(TD.lift_inv_windows_cuda(s0, d0, mode, rb, bp, name),
                                   TD.lift_inv_windows_plain(s0, d0, mode, bp, name))
    torch.cuda.synchronize(cuda_device)


def _misaligned(t):
    """A copy of ``t`` whose storage starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    off = (-(flat.data_ptr() // 4) % 4 + 1) % 4
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


# a symmetric scheme of six terms a step: its runs take the kernels'
# generic term loop (lift_terms) instead of the unrolled one
WIDE = TS.scheme_from_spec("wide", [("predict", ((-1, 1), (0, 3), (1, 3), (2, 1)), 3, -1),
                                    ("update", ((-2, 1), (-1, 3), (0, 3), (1, 1)), 4, 1)])
# an antisymmetric scheme of three steps, one of three taps (offsets -1 to
# 2): its runs are policy runs at every length, through the generic loop
ASYM = TS.scheme_from_spec("asym", [("predict", ((0, 1), (1, 1)), 1, -1),
                                    ("update", ((0, 1),), 1, 1),
                                    ("predict", ((2, 1), (-1, -1), (1, 3)), 2, 1, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["cdf53", "97m", "haar", "wide", "cdf22", "asym"])
def test_cuda_1d_run_kernels_match_plain_versions(name, mode, cuda_device):
    """The run kernels (one launch a run of levels) against the run's
    plain versions: runs of 1-6 levels, n = 16-40, 1001, 4099 and
    65,537, at the plan's tile, at forced tiles of 2^L and 3 x 2^L
    samples with 1-3 rows a block, on tensors 4 bytes past a 16-byte
    boundary, and at int32 extremes; ``wide`` (six terms a step) takes the
    generic term loop, the registered schemes the unrolled one.  cdf22,
    ``asym`` and haar on odd lengths are policy runs (a rewrite after
    every step at the line ends), the others windowed runs."""
    from repro_torch.kernels import dwt53 as TD

    rng = np.random.default_rng(22)
    sch = {"wide": WIDE, "asym": ASYM}.get(name) or TS.get_scheme(name)
    for n in list(range(16, 41)) + [1001, 4099, 65537]:
        for levels in range(1, 7):
            lens = TD.run_lengths(n, levels)
            if lens[-1] < 2:
                continue
            unit = 1 << levels
            for kind in ("rand", "min", "max") if n <= 1001 else ("rand",):
                x = _img(rng, (3, n), -(1 << 20), 1 << 20) if kind == "rand" else np.full(
                    (3, n), I32.min if kind == "min" else I32.max, np.int32)
                xt = torch.from_numpy(x).to(cuda_device)
                s0, d0 = TD.lift_fwd_run_plain(xt, levels, mode, sch)
                s0, d0 = s0.contiguous(), [d.contiguous() for d in d0]
                for tile, rb, mis in ((None, None, False), (None, None, True), (unit, 1, False),
                                      (3 * unit, 3, False), (3 * unit, 2, True)):
                    xin = _misaligned(xt) if mis else xt
                    s1, d1 = TD.lift_fwd_run_cuda(xin, levels, mode, sch, tile=tile,
                                                  block_rows=rb)
                    case = (n, levels, kind, tile, rb, mis)
                    assert torch.equal(s1, s0), case
                    assert all(torch.equal(a, b) for a, b in zip(d1, d0)), case
                    sin = _misaligned(s0) if mis else s0
                    din = [_misaligned(d) for d in d0] if mis else d0
                    assert torch.equal(TD.lift_inv_run_cuda(sin, din, mode, sch, tile=tile,
                                                            block_rows=rb), xt), case
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
def test_cuda_1d_library_and_codec_paths(cuda_device):
    from repro_torch.codec import stream as TSTREAM

    rng = np.random.default_rng(13)
    x = torch.from_numpy(_img(rng, (2, 3, 4099), -30000, 30000)).to(cuda_device)
    short = torch.from_numpy(_img(rng, (5, 13), -30000, 30000)).to(cuda_device)
    TK.launches.reset()
    for name in SCHEMES:
        pyr = TK.dwt_fwd(x, levels=4, scheme=name, checked=True)
        want = TK.dwt_fwd(x.cpu(), levels=4, scheme=name)
        for a, b in zip((pyr.approx,) + pyr.details, (want.approx,) + want.details):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(TK.dwt_inv(pyr, scheme=name, checked=True), x)
        blob = TCODEC.encode_pyramid(pyr, scheme=name, checked=True)
        assert blob == TCODEC.encode_pyramid(want, scheme=name)
        dec = TCODEC.decode_pyramid(blob, device=cuda_device)
        assert torch.equal(TCODEC.inverse_transform(dec), x)
        # a line under 8 pairs takes the row pass
        s, d = TK.dwt_fwd_1d(short, scheme=name, checked=True)
        for a, b in zip((s, d), TK.dwt_fwd_1d(short.cpu(), scheme=name)):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(TK.dwt_inv_1d(s, d, scheme=name, checked=True), short)
    counts = TK.launches.snapshot()
    assert all(counts.get(k, 0) > 0 for k in
               ("lift1d_fwd", "lift1d_inv", "rows1d_fwd", "rows1d_inv")), counts
    # an unchecked multi-level pyramid of lines of 8 pairs or more at every
    # level is one run, windowed or policy: one lift1d launch each way
    for name, n in (("cdf53", 65536), ("97m", 65536), ("haar", 65536), ("cdf22", 65536),
                    ("haar", 65537), ("cdf22", 4099)):
        xl = torch.from_numpy(_img(rng, (64, n), -32768, 32768)).to(cuda_device)
        TK.launches.reset()
        pyr = TK.dwt_fwd(xl, levels=4, scheme=name, checked=False)
        assert TK.launches.snapshot() == {"lift1d_fwd": 1}
        want = TK.dwt_fwd(xl.cpu(), levels=4, scheme=name)
        for a, b in zip((pyr.approx,) + pyr.details, (want.approx,) + want.details):
            assert torch.equal(a.cpu(), b), (name, n)
        assert torch.equal(TK.dwt_inv(pyr, scheme=name, checked=False), xl)
        assert TK.launches.snapshot() == {"lift1d_fwd": 1, "lift1d_inv": 1}
    with pytest.raises(OverflowError):
        TK.dwt_fwd(torch.full((1, 64), int(I32.max), dtype=torch.int32, device=cuda_device),
                   levels=2, checked=True)
    chunks = [_img(rng, (2, 300)), _img(rng, (7,))]
    enc = TSTREAM.StreamEncoder(levels=3, ndim=1, device=cuda_device)
    data = b"".join(enc.encode(chunks))
    cpu = b"".join(TSTREAM.StreamEncoder(levels=3, ndim=1, device="cpu").encode(chunks))
    assert data == cpu
    for a, b in zip(TSTREAM.decode_stream(data, device=cuda_device), chunks):
        assert torch.equal(a.cpu(), torch.from_numpy(b))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_cuda_3d_kernels_match_plain_versions(name, mode, cuda_device):
    """Both 3-D kernels against their plain versions: the one-block
    whole-volume path, the three-pass path (volumes past one block), and
    depth slabs at the picked and at forced depths."""
    from repro_torch.kernels import backend as TB
    from repro_torch.kernels import fused3d as T3

    rng = np.random.default_rng(17)
    sch = TS.get_scheme(name)
    shapes = [(2, 2, 2), (3, 5, 7), (5, 9, 7), (17, 33, 31), (16, 64, 64), (33, 130, 129)]
    for shp in shapes:
        for kind in ("rand", "min", "max") if shp == (3, 5, 7) else ("rand",):
            x = _img(rng, (2,) + shp) if kind == "rand" else np.full(
                (2,) + shp, I32.min if kind == "min" else I32.max, np.int32)
            xt = torch.from_numpy(x).to(cuda_device)
            want = T3.fwd3d_whole_plain(xt, mode, name)
            for a, b in zip(T3.fwd3d_whole_cuda(xt, mode, name), want):
                assert torch.equal(a, b), (shp, kind)
            assert torch.equal(T3.inv3d_whole_cuda(want, mode, name),
                               T3.inv3d_whole_plain(want, mode, name)), (shp, kind)
            if not sch.can_window(shp[0]):
                continue
            for td in {2, 4, TB.pick_slab(*shp, sch.halo, cuda_device)}:
                for a, b in zip(T3.fwd3d_slab_cuda(xt, mode, td, name), want):
                    assert torch.equal(a, b), (shp, kind, td)
                assert torch.equal(T3.inv3d_slab_cuda(want, mode, td, name),
                                   T3.inv3d_slab_plain(want, mode, td, name)), (shp, kind, td)
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_cuda_whole3d_cluster_path_matches_plain_versions(name, mode, cuda_device):
    """The whole-volume kernels at every cluster size a shape admits (and
    the geometry's own, and the three passes): H odd, H < 2c (the last
    block one row), H = 2, B from 1 to 9, int32 extremes."""
    from repro_torch.kernels import fused3d as T3

    rng = np.random.default_rng(29)
    shapes = [(1, 2, 2, 2), (2, 3, 3, 7), (3, 2, 7, 33), (4, 8, 64, 64), (5, 4, 15, 16),
              (6, 3, 31, 9), (7, 2, 130, 3), (8, 5, 17, 40), (9, 2, 32, 32), (2, 5, 2, 64)]
    seen = set()
    for shp in shapes:
        bsz, d, h, w = shp
        for kind in ("rand", "min", "max") if shp in ((2, 3, 3, 7), (5, 4, 15, 16)) else ("rand",):
            x = _img(rng, shp) if kind == "rand" else np.full(
                shp, I32.min if kind == "min" else I32.max, np.int32)
            xt = torch.from_numpy(x).to(cuda_device)
            want = T3.fwd3d_whole_plain(xt, mode, name)
            back = T3.inv3d_whole_plain(want, mode, name)
            for a, b in zip(T3.fwd3d_whole_cuda(xt, mode, name), want):
                assert torch.equal(a, b), (shp, kind)
            assert torch.equal(T3.inv3d_whole_cuda(want, mode, name), back), (shp, kind)
            plans = [T3._whole_plan(bsz, d, h, w, TS.get_scheme(name), mode, inverse, xt.device)
                     for inverse in (False, True)]
            for c in (0,) + T3.CLUSTER_SIZES:
                if c and not T3.cluster_fits(d, h, w, c, cuda_device):
                    continue
                fwd, inv = (T3._at_cluster(p, c) for p in plans)
                for a, b in zip(T3._whole_fwd(xt, fwd), want):
                    assert torch.equal(a, b), (shp, kind, c)
                assert torch.equal(T3._whole_inv(want, inv), back), (shp, kind, c)
                seen.add(c)
    torch.cuda.synchronize(cuda_device)
    assert seen == {0, 1, 2, 4, 8, 16}


@pytest.mark.cuda
def test_cuda_whole3d_refuses_what_it_cannot_run(cuda_device):
    """A cluster size the shape or the card cannot take raises; nothing
    falls back to fewer blocks or to the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused3d as T3

    def forced(t, c):
        plan = T3._whole_plan(*t.shape, TS.get_scheme("cdf53"), "paper", False, t.device)
        return T3._whole_fwd(t, T3._at_cluster(plan, c))

    TK.launches.reset()
    x = torch.zeros((1, 2, 5, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(_build.KernelLaunchError):  # 16 blocks, 3 row pairs
        forced(x, 16)
    big = torch.zeros((1, 30, 32, 1000), dtype=torch.int32, device=cuda_device)
    with pytest.raises(_build.KernelLaunchError):  # shares of 240,000 bytes
        forced(big, 16)
    with pytest.raises(_build.KernelLaunchError):
        forced(x, 17)
    assert not T3.cluster_fits(30, 32, 1000, 16, cuda_device)
    assert all(T3.cluster_fits(8, 64, 64, c, cuda_device) for c in T3.CLUSTER_SIZES)
    assert T3.volume_geometry(*big.shape, cuda_device)["cluster"] == 0
    for a, b in zip(T3.fwd3d_whole_cuda(big, "paper", "cdf53"),
                    T3.fwd3d_whole_plain(big, "paper", "cdf53")):
        assert torch.equal(a, b)
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCHEMES)
def test_cuda_slab_plane_pass_branches_match_plain_versions(name, cuda_device):
    """The depth-slab kernels on the shapes that force each branch of the
    plane pass: windows taller than the slice (H of 2, 3, 5), odd H and W
    (4-byte copies), W % 8 == 0 (16-byte copies), several strips of rows
    with a ragged last one, and the row and column passes (haar at odd H,
    rows too wide for a block); slab depths 2, 4 and the picked one."""
    from repro_torch.kernels import backend as TB
    from repro_torch.kernels import fused3d as T3

    rng = np.random.default_rng(23)
    sch = TS.get_scheme(name)
    shapes = [(4, 2, 16), (6, 3, 8), (5, 5, 24), (7, 13, 40), (4, 20, 9), (8, 9, 16),
              (3, 101, 1000), (3, 77, 1001), (2, 5, 60001)]
    seen = set()
    for shp in shapes:
        if not sch.can_window(shp[0]):
            continue
        xt = torch.from_numpy(_img(rng, (2,) + shp)).to(cuda_device)
        for td in {2, 4, TB.pick_slab(*shp, sch.halo, cuda_device)}:
            # the plain version crops the slab bands along depth: views
            want = [b.contiguous() for b in T3.fwd3d_slab_plain(xt, "jpeg2000", td, name)]
            for a, b in zip(T3.fwd3d_slab_cuda(xt, "jpeg2000", td, name), want):
                assert torch.equal(a, b), (shp, td)
            assert torch.equal(T3.inv3d_slab_cuda(want, "jpeg2000", td, name),
                               T3.inv3d_slab_plain(want, "jpeg2000", td, name)), (shp, td)
            seen.add(T3.slab_geometry(2, *shp, td, name, False, cuda_device)["passes"])
    torch.cuda.synchronize(cuda_device)
    assert seen == (set() if name == "cdf22" else {2, 3})


@pytest.mark.cuda
def test_cuda_3d_library_serve_and_codec_paths(cuda_device):
    from repro_torch.codec import stream as TSTREAM

    rng = np.random.default_rng(19)
    x = torch.from_numpy(_img(rng, (2, 33, 70, 66), -2048, 2048)).to(cuda_device)
    TK.launches.reset()
    for name in SCHEMES:
        pyr = TK.dwt_fwd_nd(x, levels=3, scheme=name, checked=True)
        want = TK.dwt_fwd_nd(x.cpu(), levels=3, scheme=name)
        for a, b in zip([pyr.approx] + [b for lvl in pyr.details for b in lvl],
                        [want.approx] + [b for lvl in want.details for b in lvl]):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(TK.dwt_inv_nd(pyr, scheme=name, checked=True), x)
        blob = TCODEC.encode_pyramid(pyr, scheme=name, ndim=3)
        assert blob == TCODEC.encode_pyramid(want, scheme=name, ndim=3)
        assert torch.equal(TCODEC.inverse_transform(TCODEC.decode_pyramid(blob, device=cuda_device)),
                           x)
    counts = TK.launches.snapshot()
    assert all(counts.get(k, 0) > 0 for k in
               ("whole3d_fwd", "whole3d_inv", "slab3d_fwd", "slab3d_inv")), counts
    vol = _img(rng, (11, 40, 36), -2048, 2048)
    data = b"".join(TSTREAM.encode_volume(vol, slab=4, levels=2, device=cuda_device))
    assert data == b"".join(TSTREAM.encode_volume(vol, slab=4, levels=2, device="cpu"))
    assert torch.equal(TSTREAM.decode_volume(data, device=cuda_device).cpu(),
                       torch.from_numpy(vol))
    eng = WaveletServeEngine(buckets=[(8, 32, 32)], batch_slots=2, levels=2,
                             device=str(cuda_device), encode_response=True)
    reqs = [TransformRequest(uid=i, image=_img(rng, (8, 32, 32) if i else (5, 30, 17)))
            for i in range(3)]
    for r in eng.run(reqs):
        row = TCODEC.decode_batch(r.encoded, device=cuda_device)[r.batch_index]
        xr = crop_result(TK.dwt_inv_nd(row), r)
        assert torch.equal(xr, torch.from_numpy(r.image).to(cuda_device))


# ---------------------------------------------------------------------------
# The tensor-codec math and the checkpoint codecs on the card.
# ---------------------------------------------------------------------------


def _numpy_wz_rule(arr32, lim):
    """The reference checkpoint's host quantization rule."""
    scale = max(float(np.max(np.abs(arr32)) or 1.0) / lim, 1e-12)
    return np.clip(np.round(arr32 / scale), -lim, lim).astype(np.int32), scale


@pytest.mark.cuda
def test_cuda_quantization_equals_the_numpy_rule_and_the_cpu(cuda_device):
    from repro_torch.ckpt import checkpoint as TCK
    from repro_torch.core import compression as TCM

    rng = np.random.default_rng(23)
    for s in (0.02, 3.0):
        x = (rng.standard_normal((1 << 20,)) * s).astype(np.float32)
        xc = torch.from_numpy(x).to(cuda_device)
        for lim in (255.0, 4095.0, 32767.0):
            q, scale = TCK._quantize_for_wz(xc, lim)
            q_np, scale_np = _numpy_wz_rule(x, lim)
            assert scale == scale_np
            assert torch.equal(q.cpu(), torch.from_numpy(q_np))
        ts = TCM.tensor_scale(xc)
        assert torch.equal(ts.cpu(), TCM.tensor_scale(torch.from_numpy(x)))
        assert torch.equal(TCM.quantize(xc, ts).cpu(), TCM.quantize(torch.from_numpy(x), ts.cpu()))
    # the band shift's exact rule, on the card as on the CPU
    amax = np.array([v for k in range(31) for c in (127 * 2**k, 32767 * 2**k)
                     for v in range(c - 40, c + 41) if 0 <= v < 2**31], np.int64)
    for limit in (127, 32767):
        for a in amax[:: 7]:
            band = torch.tensor([int(a), -int(a) // 3], dtype=torch.int32)
            assert int(TCM._band_shift(band.to(cuda_device), limit)) == int(
                TCM._band_shift(band, limit))


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["raw", "z", "wz", "wz2d", "wz3d", "wz-rice"])
def test_cuda_checkpoint_leaf_bytes_equal_their_cpu_copies(codec, cuda_device, tmp_path):
    import json

    from repro_torch import tree as TTREE
    from repro_torch.ckpt import CheckpointManager

    rng = np.random.default_rng(29)
    cpu = {
        "vec": torch.from_numpy(rng.standard_normal(300).astype(np.float32)),
        "mat": torch.from_numpy(rng.standard_normal((96, 130)).astype(np.float32)),
        "stack": torch.from_numpy((rng.standard_normal((3, 8, 40, 64)) * 0.02).astype(
            np.float32)).to(torch.bfloat16),
        "s": torch.tensor(2.5),
    }
    card = TTREE.map_leaves(lambda t: t.to(cuda_device), cpu)
    for scheme in ("cdf53", "cdf22"):
        outs = {}
        for where, tree in (("cpu", cpu), ("card", card)):
            d = tmp_path / f"{where}_{scheme}"
            mgr = CheckpointManager(d, codec=codec, wavelet_scheme=scheme, device=cuda_device)
            mgr.save(1, tree)
            step = d / "step_0000000001"
            man = json.loads((step / "manifest.json").read_text())
            outs[where] = (man, {n: (step / m["file"]).read_bytes()
                                 for n, m in man["leaves"].items()}, mgr.restore(template=tree)[1])
        assert outs["card"][0] == outs["cpu"][0]
        assert outs["card"][1] == outs["cpu"][1]
        for a, b in zip(TTREE.leaves(outs["card"][2]), TTREE.leaves(outs["cpu"][2])):
            assert a.is_cuda and torch.equal(a, b)
        cpu_mgr = CheckpointManager(tmp_path / f"card_{scheme}", device="cpu")
        for a, b in zip(TTREE.leaves(cpu_mgr.restore(template=cpu)[1]),
                        TTREE.leaves(outs["card"][2])):
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["raw", "wz-rice"])
def test_cuda_async_save_from_a_side_stream_writes_the_tree_as_it_was(codec, cuda_device, tmp_path):
    """The snapshot's clones wait behind a long kernel on the caller's side
    stream, the tree is changed in place there right after ``save``: the
    save thread still reads the clones only once they are written."""
    from repro_torch.ckpt import CheckpointManager

    rng = np.random.default_rng(31)
    side = torch.cuda.Stream(cuda_device)
    mgr = CheckpointManager(tmp_path / "async", codec=codec, device=cuda_device)
    with torch.cuda.stream(side):
        tree = {"w": torch.from_numpy(rng.standard_normal((1 << 22,)).astype(np.float32)).to(
                    cuda_device).reshape(512, 8192),
                "b": torch.ones(64, device=cuda_device)}
        want = {k: v.clone() for k, v in tree.items()}
        torch.cuda._sleep(1 << 30)  # about half a second of the card
        mgr.save(1, tree, blocking=False)
        tree["w"].add_(1.0)
        tree["b"].mul_(3.0)
    mgr.wait()
    torch.cuda.synchronize(cuda_device)
    ref = CheckpointManager(tmp_path / "ref", codec=codec, device=cuda_device)
    ref.save(1, want)
    for name in ("w", "b"):
        assert ((tmp_path / "async" / "step_0000000001" / f"{name}.bin").read_bytes()
                == (tmp_path / "ref" / "step_0000000001" / f"{name}.bin").read_bytes())
    got, exp = mgr.restore(template=want)[1], ref.restore(template=want)[1]
    assert all(torch.equal(got[k], exp[k]) for k in want)
    if codec == "raw":
        assert all(torch.equal(got[k], want[k]) for k in want)


FILTERBANK_LENGTHS = (3, 4, 5, 64, 255, 256, 65536)


@pytest.mark.cuda
@pytest.mark.parametrize("n", FILTERBANK_LENGTHS)
def test_cuda_filterbank_kernel_matches_plain_version(n, cuda_device):
    """The float (5,3) filter bank kernel is bit-equal to its plain version
    (each product and sum rounded once, in the same order): rows 1, 7 and
    1024, 8-bit values and int32 extremes, aligned and 4 bytes past a
    16-byte boundary."""
    from repro_torch.core import lifting as TL
    from repro_torch.kernels import filterbank as TFB

    rng = np.random.default_rng(37 + n)
    for rows in (1, 7, 1024):
        for kind in ("8-bit", "extremes"):
            if kind == "8-bit":
                x = rng.integers(0, 256, (rows, n), dtype=np.int32)
            else:
                x = rng.integers(I32.min, I32.max, (rows, n), dtype=np.int32, endpoint=True)
                x[:, ::3], x[:, 1::3] = I32.min, I32.max
            xt = torch.from_numpy(x).to(cuda_device)
            want = TL.filterbank53_fwd_float(xt)
            for shift in (0, 1):
                got = TFB.filterbank53_fwd_float_cuda(_shifted(xt, shift))
                for a, b in zip(got, want, strict=True):
                    assert a.dtype == torch.float32 and a.shape == b.shape
                    assert torch.equal(a, b)
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
def test_cuda_filterbank_wrapper_launches_the_kernel(cuda_device, monkeypatch):
    """A CUDA tensor goes to the kernel (the counter up by one, the plain
    version not called); narrow ints promote; what it cannot take raises."""
    from repro_torch.core import lifting as TL

    plain = TL.filterbank53_fwd_float
    calls = []
    monkeypatch.setattr(TL, "filterbank53_fwd_float", lambda x: calls.append(x) or plain(x))
    x = torch.from_numpy(np.random.default_rng(41).integers(-32768, 32767, (2, 3, 257))
                         .astype(np.int16)).to(cuda_device)
    before = TK.launches.snapshot().get("filterbank53_float", 0)
    s, d = TK.filterbank53_fwd_float(x)
    torch.cuda.synchronize(cuda_device)
    assert TK.launches.snapshot()["filterbank53_float"] == before + 1
    assert not calls
    assert s.is_cuda and s.shape == (2, 3, 129) and d.shape == (2, 3, 128)
    for a, b in zip((s, d), plain(x.to(torch.int32)), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TK.filterbank53_fwd_float(x[..., :2])
    with pytest.raises(TypeError):
        TK.filterbank53_fwd_float(x.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 0), (0, 0), (3, 0), (1, 0, 4, 4), (2, 4, 4, 0)], ids=str)
def test_cuda_zero_length_axes_at_levels_0(shape, cuda_device):
    """A zero-length axis at ``levels=0``: the identity pyramid on the
    card, as on the CPU (the port once raised on a ``reshape(-1, 0)``)."""
    x = torch.zeros(shape, dtype=torch.int32, device=cuda_device)
    for checked in (False, True):
        pyr = TK.dwt_fwd(x, levels=0, checked=checked)
        assert pyr.details == () and torch.equal(pyr.approx, x)
        assert torch.equal(TK.dwt_inv(pyr, checked=checked), x)
        if len(shape) >= 3:
            p3 = TK.dwt_fwd_nd(x, levels=0, checked=checked)
            assert p3.details == () and torch.equal(TK.dwt_inv_nd(p3, checked=checked), x)


@pytest.fixture
def nccl_world(cuda_device, tmp_path):
    """A one-rank NCCL world on the card (one GPU admits one NCCL rank)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,mode", [("cdf53", "jpeg2000"), ("97m", "paper"),
                                         ("haar", "paper")])
def test_cuda_sharded_one_rank_nccl_equals_the_single_device_pyramid(scheme, mode, nccl_world):
    from torch.distributed.tensor import DTensor

    from repro_torch.collectives import AxisComm
    from repro_torch.launch.mesh import make_mesh_compat

    mesh = make_mesh_compat((1,), ("data",))
    assert AxisComm(mesh, "data").route(torch.device("cuda")) == "nccl"
    x = torch.from_numpy(_img(np.random.default_rng(8), (2, 256, 200))).cuda()
    TK.launches.reset()
    pyr = TK.dwt_fwd_2d_sharded(x.cpu(), mesh, levels=3, mode=mode, scheme=scheme,
                                timeout_s=60.0)
    back = TK.dwt_inv_2d_sharded(pyr, mesh, mode=mode, scheme=scheme)
    counts = TK.launches.snapshot()
    assert counts.get("whole2d_fwd", 0) + counts.get("tiled2d_fwd", 0) >= 3, counts
    want = TK.dwt_fwd_2d_multi(x, levels=3, mode=mode, scheme=scheme)
    got = [pyr.ll] + [b for lvl in pyr.details for b in lvl]
    for g, w in zip(got, [want.ll] + [b for lvl in want.details for b in lvl]):
        assert isinstance(g, DTensor) and g.to_local().is_cuda
        assert torch.equal(g.full_tensor(), w)
    assert torch.equal(back.full_tensor(), x)


@pytest.mark.cuda
def test_cuda_pod_sync_one_rank_nccl_equals_the_cpu_codec(nccl_world):
    """With one pod the sync is the codec's round trip: the card's synced
    leaves and error feedback equal the same math on the CPU."""
    from repro_torch.core import compression as TCMP
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train import grad_compress as TG

    mesh = make_mesh_compat((1,), ("pod",))
    rng = np.random.default_rng(9)
    tree = {"w": rng.normal(size=(64, 96)), "act": rng.normal(size=(6, 16, 24)),
            "v": rng.normal(size=(8000,)), "b": rng.normal(size=(100,))}
    tree = {k: torch.from_numpy(v.astype(np.float32)) for k, v in tree.items()}
    cfg = TG.WaveletSyncConfig(n_pods=1, min_size=256, spatial_2d=True, spatial_3d=True)
    dev = {k: v.cuda() for k, v in tree.items()}
    synced, err = TG.pod_sync_tree(dev, TG.init_error_feedback(dev), cfg, mesh=mesh)
    assert {k: TG.leaf_route(v, cfg) for k, v in tree.items()} == {
        "w": "2d", "act": "3d", "v": "1d", "b": "raw"}
    want = {"w": TCMP.band_quantized_roundtrip_2d(tree["w"], 2)[0],
            "act": TCMP.band_quantized_roundtrip_nd(tree["act"], 2)[0],
            "b": tree["b"]}
    for k, w in want.items():
        assert torch.equal(synced[k].cpu(), w), k
    assert torch.equal(err["b"].cpu(), torch.zeros(100))
    v = tree["w"]  # the 2-D leaf's error feedback, by the CPU codec's steps
    scale = TCMP.tensor_scale(v)
    pyr = TCMP.forward_pyramid_2d(v, scale, 2)
    shifts = TCMP.pyramid2d_shifts(pyr)
    ll_q, det_q = TCMP.quantize_pyramid_2d(pyr, shifts)
    own = TCMP.reconstruct_pyramid_2d(ll_q.to(torch.int32), TCMP._as_i32(det_q), shifts)
    assert torch.equal(err["w"].cpu(), TCMP.residual_fused(v, own, scale))


# ---------------------------------------------------------------------------
# The LM stack on the card (models, ServeEngine, data pipeline)
# ---------------------------------------------------------------------------

LM_FAMILIES = ("granite-3-8b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b", "recurrentgemma-2b",
               "musicgen-medium", "internvl2-26b")


def _lm_close(got, want, bound):
    """max |got - want| <= bound x max(1, max |want|)."""
    want = want.float().cpu()
    scale = max(1.0, want.abs().max().item())
    assert got.shape == want.shape
    assert (got.float().cpu() - want).abs().max().item() <= bound * scale


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_cuda_reduced_family_matches_cpu(arch, cuda_device):
    """A reduced config of each family, float32 on the card against the
    same functions on the CPU from the same parameters: forward, prefill
    and 3 decode steps within 2e-4 of the logits' scale (3e-2 for the
    hybrid: its RG-LRU cancels in sqrt(1 - a^2), tests/test_torch_models.py)."""
    from repro_torch import tree as TTREE
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as TF

    cfg = reduced(get_config(arch))
    bound = 3e-2 if cfg.family == "hybrid" else 2e-4
    on_card = ML.init_params(TF.model_defs(cfg), 3, device=cuda_device)
    on_cpu = TTREE.map_leaves(lambda t: t.cpu(), on_card)
    rng = np.random.default_rng(3)

    def inputs(s):
        if cfg.input_mode == "tokens":
            return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s),
                                                            dtype=np.int32))}
        return {"embeds": torch.from_numpy(rng.standard_normal((2, s, cfg.d_model),
                                                               dtype=np.float32))}

    prompt, steps = inputs(32), [inputs(1) for _ in range(3)]
    outs = {}
    for where, params, dev in (("card", on_card, cuda_device), ("cpu", on_cpu, "cpu")):
        def to(kw):
            return {k: v.to(dev) for k, v in kw.items()}
        logits, aux = TF.forward(params, cfg, **to(prompt))
        got = [logits, aux]
        lg, caches = TF.prefill(params, cfg, **to(prompt))
        got.append(lg)
        for x in steps:
            lg, caches = TF.decode_step(params, cfg, caches, **to(x))
            got.append(lg)
        assert caches["len"].device.type == torch.device(dev).type
        got += [v for k, v in sorted(caches.items()) if k != "len"]
        outs[where] = got
    for g, w in zip(outs["card"], outs["cpu"]):
        _lm_close(g, w, bound)


@pytest.mark.cuda
def test_cuda_serve_engine_matches_cpu(cuda_device):
    """Greedy tokens of the engine on the card equal the CPU engine's on
    the same float32 parameters; the engine's caches stay on the card."""
    from repro_torch import tree as TTREE
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as TF
    from repro_torch.serve import Request, ServeEngine

    cfg = reduced(get_config("granite-3-8b"))
    on_card = ML.init_params(TF.model_defs(cfg), 4, device=cuda_device)
    on_cpu = TTREE.map_leaves(lambda t: t.cpu(), on_card)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (3, 7, 1, 5, 2)]
    runs = {}
    for where, params, dev in (("card", on_card, cuda_device), ("cpu", on_cpu, "cpu")):
        eng = ServeEngine(cfg, params, 3, 8, device=dev)
        done = eng.run([Request(uid=i, prompt=p, max_new=4 + i) for i, p in enumerate(prompts)])
        assert all(t.device.type == torch.device(dev).type for t in eng.caches.values())
        runs[where] = [(r.uid, r.out_tokens) for r in done]
    assert runs["card"] == runs["cpu"]
    eng = ServeEngine(cfg, on_card, 2, 8, temperature=0.7, seed=11, device=cuda_device)
    a = eng.run([Request(uid=0, prompt=prompts[0], max_new=6)])[0].out_tokens
    eng = ServeEngine(cfg, on_card, 2, 8, temperature=0.7, seed=11, device=cuda_device)
    assert eng.run([Request(uid=0, prompt=prompts[0], max_new=6)])[0].out_tokens == a


@pytest.mark.cuda
def test_cuda_band_split_launches_lift1d_and_no_plain_version(cuda_device, monkeypatch):
    from repro_torch.core import lifting as CL
    from repro_torch.data.pipeline import WaveletBandSplit
    from repro_torch.kernels import dwt53 as TD

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"plain version {name} ran on the card's path")
        return fn

    rng = np.random.default_rng(5)
    x = rng.integers(-32768, 32768, (8, 4096), dtype=np.int32)
    want = CL.dwt_fwd(torch.from_numpy(x).to(cuda_device), levels=2, mode="paper",
                      scheme="cdf53")
    for name in ("lift_fwd_run_plain", "lift_fwd_windows_plain"):
        monkeypatch.setattr(TD, name, refuse(name))
    TK.launches.reset()
    bands = WaveletBandSplit(levels=2, mode="paper", scheme="cdf53", device=cuda_device)(x)
    assert TK.launches.snapshot() == {"lift1d_fwd": 1}
    np.testing.assert_array_equal(bands["approx"], want.approx.cpu().numpy())
    for i, d in enumerate(want.details):
        np.testing.assert_array_equal(bands[f"detail_{i}"], d.cpu().numpy())


@pytest.mark.cuda
def test_cuda_params_from_numpy_lands_on_the_card(cuda_device):
    """The default device is the card (without one it raises:
    tests/test_torch_lm_serve.py); bfloat16 bits are kept."""
    from repro_torch.models import layers as ML

    bits = np.arange(-5, 5, dtype=np.int16)
    got = ML.params_from_numpy({"a": {"b": np.ones(3, np.float32)}, "c": bits})
    assert got["a"]["b"].is_cuda and got["c"].is_cuda
    t = torch.from_numpy(bits).view(torch.bfloat16)
    moved = ML.params_from_numpy({"x": t})["x"]
    assert moved.is_cuda and moved.dtype == torch.bfloat16
    assert torch.equal(moved.cpu().view(torch.int16), torch.from_numpy(bits))


# ---------------------------------------------------------------------------
# Training on the card (train.optim, train.train_step, remat, launch.train)
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-3


def _train_inputs(cfg, device):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import batch_to_device

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))
    return batch_to_device(cfg, data.batch(0), device)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One plain step of a reduced stablelm in float32 on the card against
    the same step on the CPU from the same state: gradients within 2e-4
    of each leaf's scale, the loss within 1e-4 relative, parameters within
    3 lr (the first AdamW step is sign-like) and within 1e-4 of the leaf's
    scale at 99.9% of the elements; the new state stays on the card."""
    from repro_torch import tree as TTREE
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import init_train_state
    from repro_torch.train import optim as TO
    from repro_torch.train import train_step as TSTEP

    cfg = reduced(get_config("stablelm-1.6b"))
    card = init_train_state(cfg, 5, cuda_device)
    cpu = TTREE.map_leaves(lambda t: t.cpu(), card)
    batch = _train_inputs(cfg, cuda_device)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    _, _, g_card = TSTEP._grads_of(cfg, 0)(card["params"], batch)
    _, _, g_cpu = TSTEP._grads_of(cfg, 0)(cpu["params"], cpu_batch)
    for a, b in zip(TTREE.leaves(g_card), TTREE.leaves(g_cpu)):
        assert a.is_cuda
        _lm_close(a, b, 2e-4)
    step = TSTEP.make_train_step(cfg, TO.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=6))
    p_card, o_card, m_card = step(card["params"], card["opt"], batch)
    p_cpu, _, m_cpu = step(cpu["params"], cpu["opt"], cpu_batch)
    assert abs(m_card["loss"].item() - m_cpu["loss"].item()) <= 1e-4 * abs(m_cpu["loss"].item())
    assert o_card.step.is_cuda and int(o_card.step) == 1
    for a, b in zip(TTREE.leaves(p_card), TTREE.leaves(p_cpu)):
        assert a.is_cuda and not a.requires_grad
        diff = (a.cpu() - b).abs()
        assert diff.max().item() <= 3 * TRAIN_LR
        scale = max(1.0, b.abs().max().item())
        assert (diff <= 1e-4 * scale).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_cuda_remat_grads_equal_no_remat(policy, cuda_device, monkeypatch):
    """Under deterministic algorithms, a remat step's gradients on the
    card are ``torch.equal`` to a step without remat."""
    import dataclasses

    from repro_torch import tree as TTREE
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import init_train_state
    from repro_torch.train import train_step as TSTEP

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    base = reduced(get_config("stablelm-1.6b"))
    params = init_train_state(base, 6, cuda_device)["params"]
    batch = _train_inputs(base, cuda_device)
    torch.use_deterministic_algorithms(True)
    try:
        runs = [TSTEP._grads_of(dataclasses.replace(base, remat=r, remat_policy=policy), 0)(
            params, batch) for r in (True, False)]
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(TTREE.leaves(runs[0][2]), TTREE.leaves(runs[1][2])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_train_driver_runs_on_the_card(cuda_device, tmp_path):
    """``launch.train.train`` defaults to the card: a reduced run there
    learns, checkpoints, and leaves its state on the card."""
    from repro_torch import tree as TTREE
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import train
    from repro_torch.train import optim as TO

    cfg = reduced(get_config("stablelm-1.6b"))
    out = train(cfg, steps=12, global_batch=4, seq_len=32, log_every=1000,
                ckpt_dir=tmp_path / "ck",
                opt_cfg=TO.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=12))
    assert out["final_loss"] < out["first_loss"]
    assert all(t.is_cuda for t in TTREE.leaves(out["state"]))


@pytest.mark.cuda
def test_cuda_quickstart_kernel_equals_plain(cuda_device, tmp_path, monkeypatch, capsys):
    """``examples/torch_quickstart.py`` on the card: every flag True,
    "kernel == plain?" included."""
    import importlib.util
    import pathlib

    monkeypatch.chdir(tmp_path)
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cuda"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln for ln in lines if ln.startswith("kernel == plain?")] == ["kernel == plain? True"]
    assert not any("False" in ln for ln in lines)


@pytest.mark.cuda
def test_cuda_decode_dry_run_counts_the_card_step(cuda_device):
    """A stablelm decode cell's dry run (``meta`` tensors) counts the FLOPs
    and bytes of the same step on the card, at reduced depth."""
    import dataclasses

    from repro_torch import tree as TTREE
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun as D
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as TMOD

    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2)
    cell = ShapeCell("d", 512, 4, "decode")
    art = D.run_cell("stablelm-1.6b", "d", False, save=False, cfg=cfg, cell=cell)
    assert art["status"] == "OK"
    fn, _, _ = D.build_cell(cfg, cell, D.make_mesh(False)[0], False)
    params = TL.init_params(TMOD.model_defs(cfg), 0, torch.bfloat16, device=cuda_device)
    caches = TMOD.init_caches(cfg, cell.global_batch, cell.seq_len, device=cuda_device)
    caches["len"] = torch.tensor(cell.seq_len, dtype=torch.int32, device=cuda_device)
    tokens = torch.zeros((cell.global_batch, 1), dtype=torch.int32, device=cuda_device)
    real = D.count_step(fn, (params, caches, {"tokens": tokens}))
    assert (real["flops"], real["bytes"]) == (art["trace"]["flops"], art["trace"]["bytes"])
    assert all(t.is_cuda for t in TTREE.leaves(caches))
