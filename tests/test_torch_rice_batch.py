"""The port's batched Rice encode (``repro_torch.codec.rice.encode_bands``)
against the reference ``repro.codec.rice`` on the CPU.

The encode kernel (``csrc/rice.cu``) codes every band of a pyramid in one
launch and prices each candidate k from the block's values binned by bit
length.  It runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here the same seeded bands go through the plain
version and the reference, bytes compared with ``==``, and a numpy mirror
of the kernel's cost form is held against the exhaustive costs.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import kernels as RK
from repro.codec import container as RC
from repro.codec import rice as RR
from repro_torch.codec import container as TC
from repro_torch.codec import rice as TR
from repro_torch.core import lifting as TL

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


@functools.lru_cache(maxsize=None)
def _pyramid(case):
    """(reference pyramid, the port's copy, encode kwargs) of ``case``."""
    rng = np.random.default_rng(21)
    if case == "2d":  # a 2 x 64 x 64 batch, 3 levels: 10 bands, some ending mid-block
        x = jnp.asarray(rng.integers(-128, 128, (2, 64, 64)), jnp.int32)
        rp = RK.dwt_fwd_2d_multi(x, levels=3, mode="jpeg2000", scheme="cdf53")
        return rp, TL.Pyramid2D.from_numpy(rp, device="cpu"), dict(mode="jpeg2000")
    x = jnp.asarray(rng.integers(-2048, 2048, (2, 8, 16, 16)), jnp.int32)  # 2 x (8, 16, 16), 2 levels
    rp = RK.dwt_fwd_nd(x, levels=2, mode="jpeg2000", scheme="cdf53", ndim=3)
    return rp, TL.PyramidND.from_numpy(rp, device="cpu"), dict(mode="jpeg2000", ndim=3)


def _bands(case):
    if case in ("2d", "3d"):
        return TC._leaves(_pyramid(case)[1])
    rng = np.random.default_rng(22)
    vals = [np.zeros(0), np.array([-7]), rng.integers(-3000, 3000, 257),
            np.full(300, I32_MIN), rng.integers(-5, 5, 3 * 256 + 1)]
    return [torch.from_numpy(v.astype(np.int32)) for v in vals]


def _assert_coded_equal(got, want):
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["2d", "3d", "edges"])
def test_encode_bands_equals_per_band_and_the_reference(case):
    bands = _bands(case)
    got = TR.encode_bands(bands)
    assert len(got) == len(bands)
    for g, band in zip(got, bands):
        _assert_coded_equal(g, TR.encode_band(band))
        _assert_coded_equal(g, RR.encode_band(band.numpy()))


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_encode_pyramid_bytes_equal_the_reference(case):
    rp, tp, kw = _pyramid(case)
    for fmt in (dict(version=1, checksum=True), dict(version=2, parity=True)):
        assert TC.encode_pyramid(tp, **kw, **fmt) == RC.encode_pyramid(rp, **kw, **fmt)


@pytest.mark.parametrize("case", ["2d", "3d", "edges"])
def test_kernel_tables_split_into_each_bands_coding(case):
    """The host half of the encode on the card: tables laid out as the
    kernel writes them (each band's first byte offset and the total as
    int64, then every block's uint16 byte length, then its uint8 k)
    beside one payload split back into each band's coding."""
    bands = [b for b in _bands(case) if b.numel()]  # empty bands never reach the kernel
    want = [TR.encode_band_plain(b.reshape(-1)) for b in bands]
    offs = np.concatenate([[0], np.cumsum([len(w[0]) for w in want])]).astype(np.int64)
    raw = np.concatenate([offs.view(np.uint8)]
                         + [np.concatenate([w[2] for w in want]).astype(np.uint16).view(np.uint8)]
                         + [np.concatenate([w[1] for w in want])])
    payload = np.frombuffer(b"".join(w[0] for w in want), np.uint8)
    got_offs, ks, lens = TR.split_tables(raw, len(bands))
    np.testing.assert_array_equal(got_offs, offs)
    got = TR.split_bands(payload, got_offs, ks, lens, [b.numel() for b in bands])
    for g, w in zip(got, want):
        _assert_coded_equal(g, w)


# ---------------------------------------------------------------------------
# The kernel's cost form.
# ---------------------------------------------------------------------------


def _exhaustive_costs(u: np.ndarray) -> np.ndarray:
    """Exact Rice cost of every k for one block of zigzag values, as
    ``_encode_chunk`` prices them: 25 passes over the values."""
    out = []
    for k in range(TR.K_MAX + 1):
        q = u >> k
        out.append(int(np.where(q >= TR.Q_MAX, TR.LMAX, q + 1 + k).sum()))
    return np.array(out)


def _bit_length_costs(u: np.ndarray):
    """The encode kernel's cost form (``csrc/rice.cu`` ``bin_entry`` /
    ``block_cost``) in numpy: every value adds ``1 | t1 << 9 | (2 t1 +
    t2) << 18`` to the bin of its bit length (28 and up share one bin),
    t1 and t2 the two bits below its top bit; lane k prices k from the
    count of values of bit length >= k + 4 and the bins k + 1 .. k + 3.
    Returns (the 25 costs, the kernel's k, its bit count)."""
    b = sum(((u >> i) > 0).astype(np.int64) for i in range(32))
    t1 = np.where(b >= 2, (u >> np.maximum(b - 2, 0)) & 1, 0)
    t12 = np.where(b >= 3, (u >> np.maximum(b - 3, 0)) & 3, 0)
    bins = np.zeros(32, np.int64)
    np.add.at(bins, np.minimum(b, 28), 1 | (t1 << 9) | (t12 << 18))
    ge = np.cumsum((bins & 511)[::-1])[::-1]  # values of bit length >= index
    costs = []
    for k in range(TR.K_MAX + 1):
        ge4, p1, p2, p3 = ge[k + 4], bins[k + 1], bins[k + 2], bins[k + 3]
        quot = (p1 & 511) + 2 * (p2 & 511) + ((p2 >> 9) & 511) + 4 * (p3 & 511) + (p3 >> 18)
        costs.append(int(TR.LMAX * ge4 + (1 + k) * (TR.BLOCK_VALUES - ge4) + quot))
    best = min((c << 5) | k for k, c in enumerate(costs))
    return np.array(costs), best & 31, best >> 5


def _check_block(block: np.ndarray) -> None:
    u = TR.zigzag(torch.from_numpy(block.astype(np.int32))).numpy()
    costs, k, nbits = _bit_length_costs(u)
    want = _exhaustive_costs(u)
    np.testing.assert_array_equal(costs, want)
    assert k == int(np.argmin(want)) and nbits == int(want.min())
    _, plain_nbits, plain_k = TR._encode_chunk(torch.from_numpy(block.astype(np.int32))[None])
    assert (k, nbits) == (int(plain_k[0]), int(plain_nbits[0]))


_ADVERSARIAL_BLOCKS = {
    "zeros": np.zeros(256),
    "int32_min": np.full(256, I32_MIN),
    "int32_max": np.full(256, I32_MAX),
    "ties": np.concatenate([np.full(128, -1), np.full(128, 1)]),  # u = 1, 2: k = 0, 1, 2 tie
    "minmax": np.tile([I32_MIN, I32_MAX, 0, -1], 64),
}


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL_BLOCKS))
def test_bit_length_costs_equal_the_exhaustive_costs(name):
    _check_block(_ADVERSARIAL_BLOCKS[name].astype(np.int64))


@settings(deadline=None, max_examples=40)
@given(st.lists(st.integers(I32_MIN, I32_MAX), min_size=256, max_size=256))
def test_bit_length_costs_equal_the_exhaustive_costs_on_int32_blocks(vals):
    _check_block(np.array(vals, np.int64))


@settings(deadline=None, max_examples=40)
@given(st.integers(0, 31).flatmap(lambda bits: st.lists(
    st.integers(-(1 << bits), (1 << bits) - 1), min_size=256, max_size=256)))
def test_bit_length_costs_equal_the_exhaustive_costs_at_every_magnitude(vals):
    _check_block(np.array(vals, np.int64))
