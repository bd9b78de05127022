"""The whole-volume cluster path of the port (``csrc/whole3d.cu``) on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
against the plain versions there).  Here: the cluster size
``volume_geometry`` picks at the 3-D path's levels; a numpy mirror of the
kernel's H split (which block owns each row, and where each lifting read
lands); the wrapper's band views; and the plain whole-volume versions
against the reference's whole-volume Pallas kernels in interpret mode at
an H that splits into every cluster size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused3d as R3
from repro_torch import codec as TCODEC
from repro_torch import kernels as TK
from repro_torch.codec import rice as TR
from repro_torch.core import lifting as TL
from repro_torch.core import schemes as TS
from repro_torch.kernels import fused3d as T3

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
RNG = np.random.default_rng(1919)


# ---------------------------------------------------------------------------
# Geometry: the cluster size of each level, and nothing else moved.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,cluster",
    [
        ((4, 8, 64, 64), 16),  # level 4 of 4 x (64, 512, 512)
        ((4, 4, 64, 64), 16),  # levels 3-4 of the (16, 256, 256) bucket
        ((4, 2, 32, 32), 8),  # shares of 256 samples: no finer
        ((1, 2, 128, 128), 16),  # level 3 of a WZRS depth slab
        ((4, 16, 128, 128), 16),  # cdf22's level 3: 4.5 blocks' worth, now one cluster
        ((4, 64, 512, 512), 0),  # a slice's two rows exceed a block: three passes
        ((1, 7, 256, 512), 16),  # shares of 229,376 bytes need all 16
        ((1, 17, 256, 256), 0),  # past one block even at c = 16
        ((9, 8, 64, 64), 8),  # 9 x 16 blocks would pass the card's 132 SMs
        ((1, 3, 101, 1000), 16),
        ((1, 2, 2, 2), 1),  # one row pair: one block
        ((1, 60001, 3, 2), 0),  # the long lines keep their three-pass geometry
        ((1, 2, 2, 60001), 0),
    ],
)
def test_volume_geometry_picks_the_cluster(shape, cluster):
    g = T3.volume_geometry(*shape)
    assert g["cluster"] == cluster and g["fused"] == int(cluster > 0)
    bsz, d, h, w = shape
    if cluster:
        assert T3.cluster_fits(d, h, w, cluster)
        assert cluster == 1 or bsz * cluster <= TK.backend.budgets()["sms"]
    assert g == T3.volume_geometry(*shape, "cpu")  # cached, one answer per device


@pytest.mark.parametrize(
    "shape,refused,cluster",
    [
        ((4, 8, 64, 64), {16}, 8),  # the card refuses 16: capped at 8
        ((1, 7, 256, 512), {16}, 0),  # only 16 gives shares that fit: three passes
        ((4, 2, 32, 32), {8}, 4),  # doubling stops below a refused size
        ((1, 2, 2, 2), {1, 2, 4, 8, 16}, 0),
    ],
)
def test_volume_geometry_takes_only_what_the_card_admits(monkeypatch, shape, refused, cluster):
    """The cluster size comes from the card: a size it refuses at that
    share is never picked, and no size at all means the three passes."""
    calls = []

    def admits(c, nbytes, device):
        calls.append((c, nbytes))
        return c not in refused

    monkeypatch.setattr(T3, "_card_admits", admits)
    T3._volume_geometry.cache_clear()
    try:
        g = T3.volume_geometry(*shape, "cpu")
    finally:
        T3._volume_geometry.cache_clear()
    bsz, d, h, w = shape
    assert g["cluster"] == cluster and g["fused"] == int(cluster > 0)
    assert all(nbytes == 4 * T3.cluster_rows(h, c) * d * w for c, nbytes in calls)
    assert [T3.cluster_fits(d, h, w, c) for c in T3.CLUSTER_SIZES] == [
        c not in refused and c <= (h + 1) // 2
        and T3.cluster_rows(h, c) * d * w <= TK.backend.whole3d_budget_elems()
        for c in T3.CLUSTER_SIZES]


def test_whole_volume_wrappers_take_no_cluster_size():
    """The cluster size is the geometry's; only the private seam forces one."""
    import inspect

    for fn in (T3.fwd3d_whole_cuda, T3.inv3d_whole_cuda, T3.fwd3d_whole, T3.inv3d_whole):
        assert "cluster" not in inspect.signature(fn).parameters
    plan = T3._whole_plan(2, 3, 9, 7, TS.get_scheme("cdf22"), "paper", True, torch.device("cpu"))
    forced = T3._at_cluster(plan, 4)
    assert forced.geometry == dict(plan.geometry, cluster=4, fused=1)
    assert [i.value for i in forced.ints[:9]] == [2, 3, 9, 7, 4] + [
        plan.geometry[k] for k in ("rb", "row_global", "cw_h", "cw_d")]
    assert forced.ints[9:] == plan.ints[9:] and plan.geometry["cluster"] != 4


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
def test_plan_3d_is_unchanged_by_the_cluster_path(dhw, name, plan):
    """The slab / whole split still uses one block's budget: a volume
    that a cluster could hold but that can slab still slabs."""
    assert TK.plan_3d(*dhw, "cpu", name) == plan
    slab_budget = TK.backend.whole3d_budget_elems()
    assert (plan.startswith("slab")) == (
        TS.get_scheme(name).can_window(dhw[0]) and int(np.prod(dhw)) > slab_budget)


# ---------------------------------------------------------------------------
# A numpy mirror of the kernel's H split (whole3d.cu share_of, owner_of,
# first_row, lift_h).
# ---------------------------------------------------------------------------


def _share(h, c, rank):
    pairs = (h + 1) // 2
    y0 = 2 * (rank * pairs // c)
    return y0, min(2 * ((rank + 1) * pairs // c), h) - y0


def _owner(h, c, q):
    return ((q + 1) * c - 1) // ((h + 1) // 2)


def _reflect_entry(j, parity, n):
    """lift2d.cuh reflect_entry on an array of entries."""
    period = 2 * (n - 1)
    pos = np.mod(2 * j + parity, period)
    pos = np.where(pos > n - 1, period - pos, pos)
    return (pos - parity) // 2


@pytest.mark.parametrize("name", SCHEMES)
def test_h_split_owns_every_row_once_and_every_read_lands_in_the_cluster(name):
    steps = TS.resolved_steps(name, "paper")
    for h in range(2, 131):
        pairs = (h + 1) // 2
        for c in range(1, min(16, pairs) + 1):
            shares = [_share(h, c, r) for r in range(c)]
            owned = np.zeros(h, np.int64)
            for y0, rows in shares:
                assert y0 % 2 == 0 and 1 <= rows <= T3.cluster_rows(h, c)
                owned[y0:y0 + rows] += 1
            assert (owned == 1).all(), (h, c)
            ys = np.arange(h)
            rank_of_row = np.repeat(np.arange(c), [rows for _, rows in shares])
            np.testing.assert_array_equal(_owner(h, c, ys // 2), rank_of_row)
            for st in steps:
                tpar = int(st.kind == "predict")
                spar = 1 - tpar
                slen = (h + 1 - spar) // 2
                # each block lifts the targets of its own rows: its count
                # of them is the kernel's (rows + 1 - tpar) // 2
                i = np.arange((h + 1 - tpar) // 2)
                np.testing.assert_array_equal(
                    np.bincount(rank_of_row[2 * i + tpar], minlength=c),
                    [(rows + 1 - tpar) // 2 for _, rows in shares])
                for off, _w in st.taps:
                    j = i + off
                    j = np.where((j < 0) | (j >= slen), _reflect_entry(j, spar, h), j)
                    y = 2 * j + spar
                    assert ((y >= 0) & (y < h) & (y % 2 == spar)).all(), (h, c)
                    o = _owner(h, c, j)
                    assert ((o >= 0) & (o < c)).all(), (h, c)
                    first = 2 * (o * pairs // c)
                    assert ((y >= first) & (y < first + T3.cluster_rows(h, c))).all()
                    np.testing.assert_array_equal(o, rank_of_row[y])


# ---------------------------------------------------------------------------
# The wrapper's bands: views of one allocation.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 8, 64, 64), (3, 5, 9, 7), (1, 2, 2, 2), (2, 6, 10, 13)])
def test_band_views_are_contiguous_aligned_and_shaped(shape):
    bsz, d, h, w = shape
    ref = torch.zeros(shape, dtype=torch.int32)
    plan = T3._whole_plan(bsz, d, h, w, TS.get_scheme("cdf53"), "paper", False, ref.device)
    bands = T3.whole_bands(ref, plan)
    assert [tuple(b.shape) for b in bands] == [(bsz,) + dim for dim in T3._band_dims_3d(d, h, w)]
    base = bands[0].untyped_storage().data_ptr()
    spans = []
    for b in bands:
        assert b.is_contiguous() and b.data_ptr() % 16 == 0
        assert b.untyped_storage().data_ptr() == base  # one allocation
        spans.append((b.data_ptr(), b.data_ptr() + 4 * b.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no two overlap


@pytest.mark.parametrize("name", ["cdf53", "cdf22"])
def test_codec_takes_band_views_unchanged(name):
    """``encode_bands`` and the containers code the views exactly as they
    code the same bands allocated one by one."""
    x = torch.from_numpy(RNG.integers(-2048, 2048, (2, 6, 10, 13), dtype=np.int32))
    bsz, d, h, w = x.shape
    want = T3.fwd3d_whole_plain(x, "paper", name)
    plan = T3._whole_plan(bsz, d, h, w, TS.get_scheme(name), "paper", False, x.device)
    views = T3.whole_bands(x, plan)
    for v, b in zip(views, want):
        v.copy_(b)
    copies = [b.clone() for b in want]
    assert TR.encode_bands(views) == TR.encode_bands(copies)
    pyr_v = TL.PyramidND(approx=views[0], details=(tuple(views[1:]),))
    pyr_c = TL.PyramidND(approx=copies[0], details=(tuple(copies[1:]),))
    blob = TCODEC.encode_pyramid(pyr_v, scheme=name, ndim=3)
    assert blob == TCODEC.encode_pyramid(pyr_c, scheme=name, ndim=3)
    back = TCODEC.inverse_transform(TCODEC.decode_pyramid(blob, device="cpu"))
    np.testing.assert_array_equal(back.numpy(), x.numpy())


# ---------------------------------------------------------------------------
# The plain versions against the reference's whole-volume kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,mode", [(32, "paper"), (33, "jpeg2000")])
@pytest.mark.parametrize("name", SCHEMES)
def test_plain_whole_volume_matches_reference_at_every_cluster_split(name, h, mode):
    """H = 32 and 33 split into every cluster size from 1 to 16 (16 and
    17 row pairs); the plain versions the card's cluster kernel is held
    against equal the reference's whole-volume Pallas kernels."""
    x = RNG.integers(-(1 << 20), 1 << 20, (2, 3, h, 5), dtype=np.int32)
    assert all(T3.cluster_fits(3, h, 5, c) for c in T3.CLUSTER_SIZES)
    sch = TS.get_scheme(name)
    got = T3.fwd3d_whole(torch.from_numpy(x), mode, name)
    want = R3._fwd3d_pallas(jnp.asarray(x), scheme=sch.name, mode=mode, interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = T3.inv3d_whole(got, mode, name)
    ref = R3._inv3d_pallas(tuple(want), scheme=sch.name, mode=mode, interpret=True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(back.numpy(), x)
