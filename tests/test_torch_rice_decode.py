"""The port's batched Rice decode (``repro_torch.codec.rice.decode_bands``)
against the reference ``repro.codec.rice.decode_band`` on the CPU.

The decode kernel (``csrc/rice.cu``) decodes every band of a container in
one launch, one warp per Rice block: the block's bits are cut into 32
lane segments and code boundaries are made exact by synchronising rounds.
It runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
here the same seeded bands go through the plain version and the
reference, compared exactly, a numpy mirror of the kernel's rounds is held
against the serial decode of one block on malformed blocks, and the host
staging is read back the way the kernel addresses it.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as RK
from repro.codec import rice as RR
from repro_torch.codec import container as TC
from repro_torch.codec import progressive as TP
from repro_torch.codec import rice as TR
from repro_torch.core import lifting as TL

I32 = np.iinfo(np.int32)
LANES = 32


def _smooth(rng, n):
    t = np.arange(n)
    return np.round(40 * np.sin(t / 37.0)) + rng.integers(-2, 3, n)


@functools.lru_cache(maxsize=None)
def _band(case):
    """One seeded band of ``case`` (int32 ndarray)."""
    rng = np.random.default_rng(30)
    vals = {
        "random8": lambda: rng.integers(-128, 128, 3000),
        "smooth8": lambda: _smooth(rng, 3000),
        "k0": lambda: np.zeros(600),  # every block codes at k = 0
        "k24": lambda: rng.integers(1 << 23, 1 << 25, 600) * rng.choice([-1, 1], 600),
        "escapes": lambda: np.tile([I32.min, I32.max, 0, -1], 150),
        "n1": lambda: np.array([-7]),
        "n255": lambda: rng.integers(-9, 9, 255),
        "n256": lambda: rng.integers(-999, 999, 256),
        "n257": lambda: rng.integers(-50, 50, 257),
        "n65537": lambda: rng.integers(-300, 300, 65537),
    }[case]()
    return np.asarray(vals).astype(np.int32)


CASES = ["random8", "smooth8", "k0", "k24", "escapes", "n1", "n255", "n256", "n257", "n65537"]


@pytest.mark.parametrize("case", CASES)
def test_decode_bands_equals_the_reference(case):
    x = _band(case)
    coded = TR.encode_band(torch.from_numpy(x))
    if case == "k0":
        assert set(coded[1].tolist()) == {0}
    if case == "k24":  # the last block, mostly its zero pad, codes at k = 0
        assert set(coded[1][:-1].tolist()) == {TR.K_MAX}
    if case == "escapes":  # half the codes of every full block escape
        assert (coded[2][:-1] >= TR.BLOCK_VALUES // 2 * TR.LMAX // 8).all()
    (got,) = TR.decode_bands([(*coded, x.size)], device="cpu")
    assert got.dtype == torch.int32 and got.shape == (x.size,)
    np.testing.assert_array_equal(got.numpy(), RR.decode_band(*coded, x.size))
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(TR.decode_band(*coded, x.size, device="cpu").numpy(), x)


@functools.lru_cache(maxsize=None)
def _container():
    """A 2 x 64 x 64 batch, 5 levels: a container of 16 bands."""
    rng = np.random.default_rng(31)
    x = jnp.asarray(rng.integers(-128, 128, (2, 64, 64)), jnp.int32)
    rp = RK.dwt_fwd_2d_multi(x, levels=5, mode="jpeg2000", scheme="cdf53")
    tp = TL.Pyramid2D.from_numpy(rp, device="cpu")
    return tp, TC._leaves(tp)


def test_decode_bands_of_a_16_band_container_equal_the_reference():
    _, bands = _container()
    assert len(bands) == 16
    coded = TR.encode_bands(bands)
    items = [(*c, b.numel()) for b, c in zip(bands, coded)]
    got = TR.decode_bands(items, device="cpu")
    for g, b, it in zip(got, bands, items):
        np.testing.assert_array_equal(g.numpy(), RR.decode_band(*it))
        np.testing.assert_array_equal(g.numpy(), b.reshape(-1).numpy())


def test_decode_bands_checks_every_band_and_skips_empty_ones():
    x = _band("n257")
    payload, ks, lens = TR.encode_band(torch.from_numpy(x))
    got = TR.decode_bands([(b"", np.zeros(0, np.uint8), np.zeros(0, np.uint16), 0),
                           (payload, ks, lens, x.size)], device="cpu")
    assert got[0].numel() == 0 and torch.equal(got[1], torch.from_numpy(x))
    assert TR.decode_bands([], device="cpu") == []
    bad_lens = lens.astype(np.int64)
    bad_lens[0] += 70000
    bad_lens[1] -= 70000
    for args, match in [((payload, ks, lens, x.size + 256), "geometry"),
                        ((payload[:-1], ks, lens, x.size), "truncated"),
                        ((payload, np.array([3, -1]), lens, x.size), "negative k"),
                        ((payload, ks, bad_lens, x.size), "byte length")]:
        with pytest.raises(ValueError, match=match):
            TR.decode_bands([(payload, ks, lens, x.size), args], device="cpu")


def test_container_quarantines_a_band_by_its_tables_and_decodes_the_rest():
    tp, bands = _container()
    blob = bytearray(TC.encode_pyramid(tp, mode="jpeg2000", version=1, checksum=False))
    h = TC._parse_header(bytes(blob))
    bad = 5
    blob[h.body_off + sum(h.blob_lens[:bad])] = 200  # band 5's first k: past K_MAX
    dec = TC.decode_pyramid_partial(bytes(blob), device="cpu")
    assert dec.band_status == tuple("corrupt" if i == bad else "ok" for i in range(16))
    for i, (got, want) in enumerate(zip(TC._leaves(dec.pyramid), bands)):
        assert torch.equal(got, torch.zeros_like(want) if i == bad else want), i
    with pytest.raises(TC.CorruptBandError):
        TC.decode_pyramid(bytes(blob), device="cpu")
    prog = TP.decode_progressive(bytes(blob), 3, partial=True, device="cpu")
    assert prog.band_status == tuple("corrupt" if i == bad else "ok" for i in range(10))
    with pytest.raises(TC.CorruptBandError, match=f"band {bad}"):
        TP.decode_progressive(bytes(blob), 3, device="cpu")


# ---------------------------------------------------------------------------
# A numpy mirror of the kernel's synchronising rounds.
# ---------------------------------------------------------------------------


def _bits(block):
    """The kernel's view of a block: its first BYTES_CAP bytes as bits,
    then zero bits."""
    data = np.frombuffer(bytes(block[: TR.BYTES_CAP]) + bytes(16), np.uint8)
    return np.unpackbits(data), 8 * min(len(block), TR.BYTES_CAP)


def _code(bits, p, k):
    """(zigzag value, length) of the code at bit p."""
    ones = 0
    while ones < TR.Q_MAX and bits[p + ones]:
        ones += 1
    if ones == TR.Q_MAX:
        return int("".join(map(str, bits[p + TR.Q_MAX: p + TR.LMAX])), 2), TR.LMAX
    rem = int("".join(map(str, bits[p + ones + 1: p + ones + 1 + k])), 2) if k else 0
    return (ones << k) | rem, ones + 1 + k


def warp_decode(block, k):
    """The decode kernel's warp on one block, lane by lane.  The bits are
    cut into 32 segments of ceil(8 len / 32) bits; each round, each lane
    walks from its start (at first its segment's own, a guess but for lane
    0) to the first code start at or past its segment's end, which is the
    next lane's start in the next round; until no start moves (lanes past
    the bits aside).  Then a scan of the counts and the value walk, the
    first 256 codes kept, the others left 0.  Returns (values, rounds)."""
    bits, nbits = _bits(block)
    seg = -(-nbits // LANES)
    seg0 = [min(lane * seg, nbits) for lane in range(LANES)]
    seg1 = [min(s + seg, nbits) for s in seg0]
    start, rounds = list(seg0), 0
    while True:
        rounds += 1
        ends, counts = [], []
        for lane in range(LANES):
            p, n = start[lane], 0
            while p < seg1[lane]:
                p += _code(bits, p, k)[1]
                n += 1
            ends.append(p)
            counts.append(n)
        nxt = [0] + ends[:-1]
        moved = any(nxt[i] != start[i] and seg0[i] < nbits for i in range(LANES))
        start = nxt
        if not moved:
            break
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.zeros(TR.BLOCK_VALUES, np.int64)
    for lane in range(LANES):
        p, i = start[lane], int(first[lane])
        while p < seg1[lane] and i < TR.BLOCK_VALUES:
            u, n = _code(bits, p, k)
            out[i] = u
            p, i = p + n, i + 1
    return TR.unzigzag(torch.from_numpy(out)).numpy(), rounds


def _malformed(rng):
    """(name, bytes, k): blocks no encoder writes whose tables pass the
    host checks."""
    ff = b"\xff"
    garbage = rng.bytes(65535)
    return [("all_escapes", ff * 1280, 3), ("all_escapes_short", ff * 200, 0),
            *[(f"ones_{n}", ff * n, 5) for n in range(5)],
            *[(f"random_{n}", rng.bytes(n), int(rng.integers(TR.K_MAX + 1))) for n in range(1, 5)],
            ("garbage_65535", garbage, 0), ("garbage_65535_k7", garbage, 7),
            ("past_its_bytes", rng.bytes(40), TR.K_MAX),
            ("escape_past_its_bytes", ff * 6 + bytes(3), 0),
            ("escapes_every_5_bytes", bytes(b if j % 5 else 255
                                            for j, b in enumerate(rng.bytes(161))), 2)]


@pytest.mark.parametrize("name", [m[0] for m in _malformed(np.random.default_rng(32))])
def test_warp_rounds_equal_the_serial_decode_on_malformed_blocks(name):
    block, k = {m[0]: m[1:] for m in _malformed(np.random.default_rng(32))}[name]
    got, rounds = warp_decode(block, k)
    want = TR.decode_block_serial(block, k)
    np.testing.assert_array_equal(got, want)
    assert 1 <= rounds <= LANES
    # the reference reads the same zero tail where its row is wider than
    # the block (a power-of-two row of at least 8 bytes)
    if len(block) < 8 or len(block) & (len(block) - 1):
        ref = RR.decode_band(block, np.array([k]), np.array([len(block)]), TR.BLOCK_VALUES)
        np.testing.assert_array_equal(want, ref)


def test_warp_rounds_equal_the_serial_decode_on_well_formed_blocks():
    rounds = []
    for case in ("random8", "smooth8", "k0", "k24", "escapes"):
        x = _band(case)
        payload, ks, lens = TR.encode_band(torch.from_numpy(x))
        offs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
        for b in range(len(ks)):
            block = payload[offs[b]: offs[b + 1]]
            got, r = warp_decode(block, int(ks[b]))
            want = TR.decode_block_serial(block, int(ks[b]))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(want[: x.size - 256 * b], x[256 * b: 256 * (b + 1)])
            rounds.append(r)
    # Rice codes resynchronise slowly: a lane that starts mid-code often
    # walks its whole segment of ~8 codes off the true boundaries
    assert max(rounds) <= LANES and 3 <= np.median(rounds) <= 5


def test_staged_bytes_read_back_as_the_kernel_reads_them():
    """The host half of the decode on the card: the staged buffer and
    table, read back the kernel's way (a block's band by binary search
    over the first blocks, its length and k at its global index, its
    bytes at the sum of every earlier length, its values at 256 x its
    index, the band's last block cut at its count)."""
    _, bands = _container()
    bands = bands + [torch.from_numpy(_band(c)) for c in ("n1", "n257", "escapes")]
    coded = TR.encode_bands(bands)
    checked = [TR.check_band(*c, b.numel()) for b, c in zip(bands, coded)]
    host, table, nb = TR.stage_bands(checked)
    raw = host.numpy()
    lens_at, ks_at, pay_at = table[: TR.TABLE_HEAD]
    nbands = len(bands)
    firsts = table[TR.TABLE_HEAD: TR.TABLE_HEAD + nbands + 1]
    counts = table[TR.TABLE_HEAD + nbands + 1:]
    assert len(counts) == nbands and firsts[-1] == nb and pay_at % 16 == 0
    assert raw.size >= pay_at + sum(len(c[0]) for c in coded) + 16
    lens = raw[lens_at: lens_at + 2 * nb].view(np.uint16)
    offs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
    out = np.zeros(nb * TR.BLOCK_VALUES, np.int32)
    for g in range(nb):
        band = int(np.searchsorted(firsts, g, side="right")) - 1
        block = raw[pay_at + offs[g]: pay_at + offs[g + 1]].tobytes()
        vals = TR.decode_block_serial(block, int(raw[ks_at + g]))
        valid = min(TR.BLOCK_VALUES, counts[band] - (g - firsts[band]) * TR.BLOCK_VALUES)
        out[g * TR.BLOCK_VALUES: g * TR.BLOCK_VALUES + valid] = vals[:valid]
    for i, b in enumerate(bands):
        at = firsts[i] * TR.BLOCK_VALUES
        np.testing.assert_array_equal(out[at: at + b.numel()], b.reshape(-1).numpy())
