"""The whole-image cluster path of the port (``csrc/whole2d.cu``) on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
against the plain versions there).  Here: a numpy mirror of the kernel's
row ownership across the levels of a chain and of where every H-lifting
read lands; the grouping of a pyramid's whole-image levels into runs
against ``plan_2d``; the launches a run takes; the plan cache and its one
allocation; the launcher calls and launch counts of a chained call (with
the C launcher replaced by a recorder); and the chained plain path
against the reference's Pallas kernels in interpret mode.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as RK
from repro_torch import kernels as TK
from repro_torch.core import schemes as TS
from repro_torch.kernels import _build
from repro_torch.kernels import backend as TB
from repro_torch.kernels import fused2d as TF
from repro_torch.kernels import fused3d as T3

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
RNG = np.random.default_rng(2121)


def _img(shape, lo=-1000, hi=1000):
    return RNG.integers(lo, hi, shape).astype(np.int32)


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# A numpy mirror of the kernel's rows across a chain (whole2d.cu level_of,
# owner_of, first_row, lift_h, the LL hand-over between levels).
# ---------------------------------------------------------------------------


def _shares(h0, levels, k, c):
    """(y0, rows) of each block at level k of a chain of ``levels`` levels
    of an h0-row image split over c blocks."""
    groups, shift, hk = _cdiv(h0, 1 << levels), levels - k, _cdiv(h0, 1 << k)
    out = []
    for r in range(c):
        y0 = (r * groups // c) << shift
        out.append((y0, min(((r + 1) * groups // c) << shift, hk) - y0))
    return out


def _reflect_entry(j, parity, n):
    """lift2d.cuh reflect_entry on an array of entries."""
    period = 2 * (n - 1)
    pos = np.mod(2 * j + parity, period)
    pos = np.where(pos > n - 1, period - pos, pos)
    return (pos - parity) // 2


# every (target parity, tap offset) any registered scheme's steps take
_TAPS = sorted({(int(st.kind == "predict"), off)
                for name in SCHEMES for st in TS.resolved_steps(name, "paper")
                for off, _w in st.taps})


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_chain_rows_and_every_h_read_land_in_the_cluster(levels):
    """For H = 2-260, every cluster size up to 16 that the chain's row
    groups allow, at every level of the chain: each row is owned once by
    a run that starts on an even row and fits the largest share; a
    block's rows at level k + 1 are the halves of its even rows at level
    k (its LL stays with it); every H-lifting read, reflections included,
    lands on a row of the block ``owner_of`` names, within that block's
    rows; and each level's region lies inside the block's shared memory
    (``chain_share``) without overlapping the levels it is live with."""
    for h0 in range(2, 261):
        if _cdiv(h0, 1 << (levels - 1)) < 2:
            continue
        groups = TF.chain_groups(h0, levels)
        assert groups == _cdiv(h0, 1 << levels)
        w0 = h0
        for c in range(1, min(16, groups) + 1):
            per = _cdiv(groups, c)
            share = TF.chain_share(h0, w0, levels, c)
            base_odd = (per << levels) * w0
            for k in range(levels):
                hk, wk, shift = _cdiv(h0, 1 << k), _cdiv(w0, 1 << k), levels - k
                shares = _shares(h0, levels, k, c)
                owned = np.zeros(hk, np.int64)
                for y0, rows in shares:
                    assert y0 % 2 == 0 and 1 <= rows <= per << shift, (h0, levels, c, k)
                    owned[y0:y0 + rows] += 1
                assert (owned == 1).all(), (h0, levels, c, k)
                base = base_odd if k % 2 else 0
                assert base + (per << shift) * wk <= share
                if k % 2 == 0:
                    assert (per << shift) * wk <= base_odd or levels == 1
                if k + 1 < levels:
                    for (y0, rows), (n0, nrows) in zip(shares, _shares(h0, levels, k + 1, c)):
                        assert (n0, nrows) == (y0 // 2, _cdiv(rows, 2)), (h0, levels, c, k)
                rank_of_row = np.repeat(np.arange(c), [rows for _, rows in shares])
                ys = np.arange(hk)
                np.testing.assert_array_equal(
                    (((ys >> shift) + 1) * c - 1) // groups, rank_of_row)
                firsts = np.array([y0 for y0, _ in shares])
                for tpar, off in _TAPS:
                    spar = 1 - tpar
                    slen = (hk + 1 - spar) // 2
                    i = np.arange((hk + 1 - tpar) // 2)
                    np.testing.assert_array_equal(
                        np.bincount(rank_of_row[2 * i + tpar], minlength=c),
                        [(rows + 1 - tpar) // 2 for _, rows in shares])
                    j = i + off
                    j = np.where((j < 0) | (j >= slen), _reflect_entry(j, spar, hk), j)
                    y = 2 * j + spar
                    assert ((y >= 0) & (y < hk)).all(), (h0, levels, c, k)
                    o = (((y >> shift) + 1) * c - 1) // groups
                    np.testing.assert_array_equal(o, rank_of_row[y])
                    assert ((y >= firsts[o]) & (y < firsts[o] + (per << shift))).all()


# ---------------------------------------------------------------------------
# Runs of whole-image levels, and the launches each takes.
# ---------------------------------------------------------------------------


def _parent_rule(h, w, sch, forced):
    """plan_2d's rule as it stood before chains: tiled where the scheme
    windows both axes and the tile is forced or the image exceeds one
    block's shared memory."""
    return sch.can_window(h) and sch.can_window(w) and (forced or h * w > 232448 // 4)


_PYRAMIDS = [(2048, 2048, 5), (1024, 1024, 5), (300, 300, 4), (257, 383, 3), (129, 65, 4),
             (20, 28, 5), (24, 20, 4), (33, 17, 3), (512, 130, 5), (241, 241, 5)]


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("name", SCHEMES)
def test_level_runs_group_the_whole_levels_plan_2d_names(name, forced, monkeypatch):
    """Each maximal run of consecutive levels ``plan_2d`` sends to the
    whole-image path is one run, in both directions, and ``plan_2d``
    answers as it did before chains (with ``REPRO_DWT_TILE`` forced too,
    where a haar level of odd size is whole between tiled ones)."""
    if forced:
        monkeypatch.setenv("REPRO_DWT_TILE", "4")
    sch = TS.get_scheme(name)
    for h, w, levels in _PYRAMIDS:
        dims = TF._level_dims(h, w, levels)
        tiled = [TK.plan_2d(a, b, "cpu", name) == "tiled-torch" for a, b in dims]
        assert tiled == [_parent_rule(a, b, sch, forced) for a, b in dims]
        for order in (dims, dims[::-1]):
            runs = TF.level_runs(order, sch, "cpu")
            flat = [t for t, n in runs for _ in range(n)]
            assert flat == [TK.plan_2d(a, b, "cpu", name) == "tiled-torch" for a, b in order]
            assert all(n == 1 for t, n in runs if t)
            assert all(a[0] or b[0] for a, b in zip(runs, runs[1:]))  # whole runs are maximal
    if forced and name == "haar":
        runs = TF.level_runs(TF._level_dims(20, 28, 5), sch, "cpu")
        assert runs == [(True, 1), (True, 1), (False, 2), (True, 1)]


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("name", ["cdf53", "haar", "cdf22"])
def test_pyramid_calls_one_chain_per_run(name, forced, monkeypatch):
    """``dwt_fwd_2d_multi`` / ``dwt_inv_2d_multi`` hand each run of whole
    levels to one chain call, with the run's length."""
    if forced:
        monkeypatch.setenv("REPRO_DWT_TILE", "4")
    calls = []
    fwd, inv = TF.fwd2d_chain, TF.inv2d_chain
    monkeypatch.setattr(TF, "fwd2d_chain", lambda x, n, *a: calls.append(("f", n)) or fwd(x, n, *a))
    monkeypatch.setattr(TF, "inv2d_chain",
                        lambda ll, d, *a: calls.append(("i", len(d))) or inv(ll, d, *a))
    x = _img((1, 20, 28))
    sch = TS.get_scheme(name)
    dims = TF._level_dims(20, 28, 5)
    pyr = TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=5, scheme=name)
    np.testing.assert_array_equal(TK.dwt_inv_2d_multi(pyr, scheme=name).numpy(), x)
    whole = [n for t, n in TF.level_runs(dims, sch, "cpu") if not t]
    assert calls == [("f", n) for n in whole] + [("i", n) for n in whole[::-1]]


@pytest.mark.parametrize(
    "shape,levels,name,launches",
    [
        ((8, 128, 128), 1, "cdf53", ((1, 16),)),  # 2048^2 level 5
        ((8, 128, 128), 2, "cdf53", ((2, 8),)),  # 1024^2 levels 4-5: one launch
        ((1, 128, 128), 2, "cdf53", ((2, 16),)),  # the client's 1024^2 inverse
        ((9, 64, 64), 1, "cdf53", ((1, 8),)),  # 9 x 16 blocks would pass 132 SMs
        ((16, 128, 128), 2, "cdf53", ((2, 4),)),  # 16 x 8 x 2 would pass them
        ((8, 128, 128), 3, "cdf53", ((3, 8),)),  # a chain counts each image twice
        ((1, 8, 8), 1, "cdf53", ((1, 1),)),  # shares of 64 samples: one block
        ((1, 2, 2), 1, "haar", ((1, 1),)),
        ((2, 257, 383), 1, "cdf22", ((1, 16),)),  # past one block, now one cluster
        ((1, 60001, 3), 1, "cdf22", ((1, 16),)),  # a long column split over 16 blocks
        ((1, 3, 60001), 1, "cdf22", ((1, 0),)),  # rows past a block: the two passes
        ((1, 1024, 1024), 5, "cdf22", ((1, 0), (4, 16))),  # level 1 past 16 blocks
        ((1, 241, 241), 5, "haar", ((5, 8),)),
    ],
)
def test_chain_launches_pick_the_longest_chain_and_the_cluster(shape, levels, name, launches):
    assert TF.chain_launches(*shape, levels) == launches
    assert TF.chain_launches(*shape, levels, "cpu") == launches
    bsz, h, w = shape
    k = 0
    for n, c in launches:
        hk, wk = TF._level_dims(h, w, levels)[k]
        if c:
            assert TF.chain_fits(hk, wk, n, c) and (c == 1 or bsz * c * min(n, 2) <= 132)
            assert not any(TF._pick_cluster(bsz, hk, wk, m, None)
                           for m in range(n + 1, levels - k + 1))
        else:
            assert n == 1 and not TF._pick_cluster(bsz, hk, wk, 1, None)
        k += n
    assert k == levels


@pytest.mark.parametrize(
    "refused,launches",
    [
        ({16}, ((2, 8),)),  # the card refuses 16: capped at 8
        ({1, 2, 4, 8, 16}, ((1, 0), (1, 0))),  # nothing admitted: two passes a level
        ({2}, ((2, 1),)),  # doubling stops below a refused size
    ],
)
def test_chain_launches_take_only_what_the_card_admits(monkeypatch, refused, launches):
    calls = []

    def admits(c, nbytes, device):
        calls.append((c, nbytes))
        return c not in refused

    monkeypatch.setattr(TF, "_card_admits", admits)
    TF._chain_launches.cache_clear()
    try:
        got = TF.chain_launches(1, 128, 128, 2, "cpu")
    finally:
        TF._chain_launches.cache_clear()
    assert got == launches
    assert calls and all(nbytes % 4 == 0 for _, nbytes in calls)


@pytest.mark.parametrize("lib,admits", [("whole2d", lambda c, n, d: TF._card_admits(c, n, d)),
                                         ("whole3d", lambda c, n, d: T3._card_admits(c, n, d))])
def test_a_failed_cluster_query_raises_and_is_asked_again(monkeypatch, lib, admits):
    """A CUDA error of the card's occupancy query is no refusal: it raises,
    and nothing is cached, so the next query asks the card again; only the
    card's answer of no room says no."""
    answers = [(1, 0), (0, 3), (0, 0)]  # (rc, room)

    class Lib:
        def repro_error_string(self, rc):
            return b"invalid value"

    def room_query(index, c, nbytes, room):
        rc, n = answers.pop(0)
        ctypes.c_int.from_address(room).value = n
        return rc

    fake = Lib()
    setattr(fake, f"repro_{lib}_cluster_room", room_query)
    monkeypatch.setattr(_build, "library", lambda name: fake)
    TF._cluster_room.cache_clear()
    try:
        with pytest.raises(_build.KernelLaunchError,
                           match=f"repro_{lib}_cluster_room: CUDA error 1"):
            admits(4, 4096, "cuda:0")
        assert admits(4, 4096, "cuda:0")  # asked again: room for 3 clusters
        assert admits(4, 4096, "cuda:0")  # cached now
        assert not admits(8, 4096, "cuda:0")  # no room: refused
    finally:
        TF._cluster_room.cache_clear()
    assert not answers


# ---------------------------------------------------------------------------
# The plan: cached, one allocation, the launcher's arguments.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,levels,name", [((8, 128, 128), 2, "cdf53"),
                                               ((3, 33, 17), 3, "97m"),
                                               ((1, 1024, 1024), 5, "cdf22")])
def test_plan_is_cached_with_one_aligned_allocation(shape, levels, name):
    bsz, h, w = shape
    sch, dev = TS.get_scheme(name), torch.device("cpu")
    plan = TF._chain_plan(bsz, h, w, levels, sch, "paper", False, dev)
    assert plan is TF._chain_plan(bsz, h, w, levels, sch, "paper", False, dev)
    assert [(ln.n, ln.cluster) for ln in plan.launches] == list(TF.chain_launches(*shape, levels))
    spans = []
    for k, lv in enumerate(plan.bands):
        want = TF._band_shapes(*plan.dims[k])
        for code, v in enumerate(lv):
            last = any(ln.k0 + ln.n - 1 == k for ln in plan.launches)
            assert (v is None) == (code == 0 and not last)
            if v is not None:
                (b, hh, ww), strides, off = v
                assert (b, hh, ww) == (bsz,) + want[code] and strides == (hh * ww, ww, 1)
                assert off % 4 == 0
                spans.append((off, off + b * hh * ww))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= plan.total
    for ln, offs in zip(plan.launches, plan.offsets):
        if ln.cluster:
            assert [i.value for i in ln.ints[:5]] == [bsz, *plan.dims[ln.k0], ln.n, ln.cluster]
            assert len(offs) == 4 * ln.n
            for i, k in enumerate(range(ln.k0, ln.k0 + ln.n)):
                assert list(offs[4 * i + 1:4 * i + 4]) == [4 * plan.bands[k][c][2]
                                                            for c in (1, 2, 3)]
            assert offs[-4] == 4 * plan.bands[ln.k0 + ln.n - 1][0][2]
        else:
            assert offs is None and ln.geometry == TF.whole_geometry(bsz, *plan.dims[ln.k0])
    inv = TF._chain_plan(bsz, h, w, levels, sch, "paper", True, dev)
    assert [v[0] for v in inv.images] == [(bsz,) + plan.dims[ln.k0] for ln in plan.launches]
    forced = TF._chain_plan(bsz, h, w, 1, sch, "paper", False, dev, 0)
    assert [(ln.n, ln.cluster) for ln in forced.launches] == [(1, 0)]
    with pytest.raises(ValueError, match="one level"):
        TF._chain_plan(bsz, h, w, 2, sch, "paper", False, dev, 0)


class _Recorder:
    """Stands in for the C launchers: records each call with the band
    addresses it was handed."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(_build, "check_tensors", lambda label, ts, dtypes=None: 0)
        monkeypatch.setattr(_build, "current_stream_handle", lambda dev: 0)
        monkeypatch.setattr(_build, "call", self.call)

    def call(self, name, fn, args):
        assert name == "whole2d"
        ptrs = None
        if fn.startswith("repro_whole2d_cluster"):
            n = 4 * args[6].value
            addr = args[2] if fn.endswith("fwd") else args[1]
            ptrs = list(np.ctypeslib.as_array((ctypes.c_int64 * n).from_address(addr)))
        self.calls.append((fn, ptrs, args))


@pytest.mark.parametrize("shape,levels,name,fns", [
    ((2, 128, 128), 2, "cdf53", ["repro_whole2d_cluster"]),
    ((1, 1024, 1024), 5, "cdf22", ["repro_whole", "repro_whole2d_cluster"]),
])
def test_chained_call_is_one_launch_a_chain(shape, levels, name, fns, monkeypatch):
    """A chained call makes one launcher call and one count per launch of
    its plan, and hands each cluster launch every band's address in code
    order (the last level's ll included)."""
    rec = _Recorder(monkeypatch)
    x = torch.zeros(shape, dtype=torch.int32)
    TK.launches.reset()
    ll, details = TF.fwd2d_chain_cuda(x, levels, "paper", name)
    assert [f for f, _, _ in rec.calls] == [f + "_fwd" for f in fns]
    assert TK.launches.snapshot() == {"whole2d_fwd": len(fns)}
    fn, ptrs, args = rec.calls[-1]
    n = args[6].value
    first = levels - n
    want = []
    for k in range(first, levels):
        lh, hl, hh = details[k]
        want += [ll.data_ptr() if k == levels - 1 else hl.data_ptr(), hl.data_ptr(),
                 lh.data_ptr(), hh.data_ptr()]
    assert ptrs == want
    rec.calls.clear()
    TK.launches.reset()
    out = TF.inv2d_chain_cuda(ll, details[::-1], "paper", name)
    assert tuple(out.shape) == shape
    assert [f for f, _, _ in rec.calls] == [f + "_inv" for f in fns[::-1]]
    assert TK.launches.snapshot() == {"whole2d_inv": len(fns)}
    fn, ptrs, args = rec.calls[0]
    assert ptrs[-4] == ll.data_ptr() and ptrs[1:4] == [details[first][1].data_ptr(),
                                                        details[first][0].data_ptr(),
                                                        details[first][2].data_ptr()]
    TK.launches.reset()


def test_flat_keeps_a_contiguous_int32_band():
    a = torch.zeros((2, 5, 7), dtype=torch.int32)
    assert TF._flat(a, (2,)) is a
    b = torch.zeros((2, 3, 5, 7), dtype=torch.int16)
    f = TF._flat(b, (2, 3))
    assert f.dtype == torch.int32 and tuple(f.shape) == (6, 5, 7)
    t = torch.zeros((2, 7, 5), dtype=torch.int32).transpose(1, 2)
    assert TF._flat(t, (2,)).is_contiguous()


# ---------------------------------------------------------------------------
# The chained plain path against the reference's whole-image kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_chained_plain_path_matches_reference_interpret(name, mode):
    """Runs of 1, 2 and 3 whole levels (every level of a (2, 13, 9)
    batch is whole) through the port's pyramid entry points equal the
    reference's Pallas pyramid in interpret mode, both ways."""
    x = _img((2, 13, 9))
    for levels in (1, 2, 3):
        assert TF.level_runs(TF._level_dims(13, 9, levels), TS.get_scheme(name), "cpu") == [
            (False, levels)]
        got = TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=levels, mode=mode, scheme=name)
        want = RK.dwt_fwd_2d_multi(jnp.asarray(x), levels=levels, mode=mode, scheme=name,
                                   backend="interpret")
        np.testing.assert_array_equal(got.ll.numpy(), np.asarray(want.ll))
        for a, b in zip(got.details, want.details):
            for p, q in zip(a, b):
                np.testing.assert_array_equal(p.numpy(), np.asarray(q))
        y = TK.dwt_inv_2d_multi(got, mode=mode, scheme=name)
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(RK.dwt_inv_2d_multi(want, mode=mode, scheme=name,
                                                      backend="interpret")))
        np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("mode", MODES)
def test_haar_run_between_tiled_levels_matches_reference(mode, monkeypatch):
    """With ``REPRO_DWT_TILE`` forced, haar's odd-size levels of a (1, 20,
    28) pyramid are a run of two whole levels between tiled ones."""
    monkeypatch.setenv("REPRO_DWT_TILE", "4")
    x = _img((1, 20, 28))
    got = TK.dwt_fwd_2d_multi(torch.from_numpy(x), levels=5, mode=mode, scheme="haar")
    want = RK.dwt_fwd_2d_multi(jnp.asarray(x), levels=5, mode=mode, scheme="haar",
                               backend="interpret")
    np.testing.assert_array_equal(got.ll.numpy(), np.asarray(want.ll))
    for a, b in zip(got.details, want.details):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    y = TK.dwt_inv_2d_multi(got, mode=mode, scheme="haar")
    np.testing.assert_array_equal(y.numpy(), x)
    assert TB.tile_forced()
