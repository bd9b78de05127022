"""Runs of windowed 1-D levels (``csrc/lift1d.cu``) on the CPU.

The run kernels need the card (``tests/test_torch_cuda.py`` holds them
against the plain versions there).  Here: the run's plain versions
against ``repro`` (its oracle chain under jit, as its own tests run it);
a numpy mirror of the run's tile geometry — each tile's window at every
level, the entries it reads and the reflected sources it rewrites at the
line ends — driven through the interior-only lifting math and held
against the per-level plain versions at forced tiny tiles; the grouping
of a pyramid's levels into runs; the tile picked from the card's budget;
and the launches a run takes, with the C launcher replaced by a recorder.
"""
import numpy as np
import pytest
import torch

import repro.kernels as RK
from repro_torch import kernels as TK
from repro_torch.core import schemes as TS
from repro_torch.kernels import _build
from repro_torch.kernels import backend as TB
from repro_torch.kernels import dwt53 as TD
from repro_torch.kernels import ops as TO

WINDOWED = ("cdf53", "97m", "haar")
MODES = ("paper", "jpeg2000")
RNG = np.random.default_rng(2222)


def _line(shape, lo=-(1 << 20), hi=1 << 20):
    return RNG.integers(lo, hi, shape).astype(np.int32)


def _eq(got, want) -> None:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _round4(v):
    return -(-v // 4) * 4


def _run_len(sch, n, levels):
    """The longest windowed run from a length-n line, up to ``levels``."""
    count = 0
    for v in TD.run_lengths(n, levels):
        if not (sch.can_window(v) and v // 2 >= TO._MIN_KERNEL_PAIRS):
            break
        count += 1
    return count


# ---------------------------------------------------------------------------
# The run's plain versions against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", WINDOWED)
@pytest.mark.parametrize("rows,n", [(2, 4099), (1, 60001), (1, 65537), (2, 60000)])
def test_run_plain_versions_equal_the_reference(name, mode, rows, n):
    """For every run of 1-6 windowed levels from the line: the run's
    plain forward gives the reference's last approximation and every
    level's detail, and its inverse the line back; the port's 6-level
    ``dwt_fwd`` / ``dwt_inv`` (runs and row passes) equal ``repro``'s."""
    sch = TS.get_scheme(name)
    x = _line((rows, n))
    chain, a = [], x
    for _ in range(6):  # the reference one level at a time: 6 compiles a shape
        s, d = RK.dwt_fwd_1d(a, mode=mode, scheme=name)
        chain.append((np.asarray(s), np.asarray(d)))
        a = np.asarray(s)
    longest = _run_len(sch, n, 6)
    for levels in range(1, longest + 1):
        s, ds = TD.lift_fwd_run_plain(torch.from_numpy(x), levels, mode, sch)
        _eq(s, chain[levels - 1][0])
        for k, d in enumerate(ds):
            _eq(d, chain[k][1])
        _eq(TD.lift_inv_run_plain(s, ds, mode, sch), x)
    pyr = TK.dwt_fwd(torch.from_numpy(x), levels=6, mode=mode, scheme=name)
    want = RK.dwt_fwd(x, levels=6, mode=mode, scheme=name)
    _eq(pyr.approx, want.approx)
    for g, w in zip(pyr.details, want.details):
        _eq(g, w)
    _eq(TK.dwt_inv(pyr, mode=mode, scheme=name), np.asarray(RK.dwt_inv(want, mode=mode,
                                                                        scheme=name)))


# ---------------------------------------------------------------------------
# A numpy mirror of the run's tiles (lift1d.cu run_fwd_kernel /
# run_inv_kernel): which entries each tile's window holds at each level,
# and the in-window source of every entry it rewrites at the line ends.
# ---------------------------------------------------------------------------


def _reflect_index(pos, n):
    """lift2d.cuh reflect_index on an array of positions."""
    period = 2 * (n - 1)
    q = np.mod(pos, period)
    return np.where(q > n - 1, period - q, q)


def _reflect_entry(p, parity, n):
    return (_reflect_index(2 * p + parity, n) - parity) // 2


def fwd_windows(n, levels, tile, margin, rewrite=True):
    """Per level k, a (tiles, W_k) int array: level 0, the sample of x
    each window entry reads; level k >= 1, the index into the previous
    level's valid s entries (pairs [m, m + W_k) of its window) each entry
    takes — its own, or at the line ends the entry that level's
    reflection names, where the window holds it."""
    ext, _ = TB.run_exts(levels, margin, 0)
    lens = TD.run_lengths(n, levels)
    t = np.arange(-(-n // tile))[:, None]
    out = []
    for k in range(levels):
        tk = tile >> k
        width = tk + 2 * ext[k]
        start = t * tk - ext[k]
        j = np.arange(width)[None, :]
        q = start + j
        if k == 0:
            out.append(_reflect_index(q, n))
            continue
        src = np.broadcast_to(j, q.shape).copy()
        if rewrite:
            r = _reflect_index(q, lens[k]) - start
            hit = ((q < 0) | (q >= lens[k])) & (r >= 0) & (r < width)
            src[hit] = r[hit]
        out.append(src)
    return out


def inv_windows(n, levels, tile, margin, rewrite=True):
    """Per level k (coarsest first in execution, listed finest first), a
    pair of (tiles, Wp_k) int arrays: the d entry each window pair reads,
    and for the s entry either the coarsest band's entry (k = levels-1)
    or the index into level k+1's merged samples it takes (its own, or at
    the ends the entry level k's reflection names, where held)."""
    _, ext = TB.run_exts(levels, 0, margin)
    lens = TD.run_lengths(n, levels)
    t = np.arange(-(-n // tile))[:, None]
    out = []
    for k in range(levels):
        half = (tile >> k) // 2
        e = t * half - ext[k] + np.arange(half + 2 * ext[k])[None, :]
        d_src = _reflect_entry(e, 1, lens[k])
        if k == levels - 1:
            out.append((d_src, _reflect_entry(e, 0, lens[k])))
            continue
        base = 2 * (t * ((tile >> (k + 1)) // 2) - ext[k + 1])  # level k+1's sample at [0]
        idx = e - base
        if rewrite:
            r = _reflect_entry(e, 0, lens[k]) - base
            width = 2 * ((tile >> (k + 1)) // 2 + 2 * ext[k + 1])
            hit = ((e < 0) | (e >= lens[k + 1])) & (r >= 2 * margin) & (r < width - 2 * margin)
            idx[hit] = r[hit]
        out.append((d_src, idx - 2 * margin))  # into the merged samples' valid core
    return out


def _gather(a, idx):
    """a (rows, ...) gathered along its last axis by a (tiles, W) map,
    per tile: (rows, tiles, W)."""
    idx = torch.as_tensor(idx)
    if a.ndim == 2:
        return a[:, idx]
    return torch.gather(a, 2, idx[None].expand(a.shape[0], -1, -1))


def mirror_fwd(x, levels, tile, mode, sch, rewrite=True):
    """The kernel's forward run on the mirror's windows."""
    rows, n = x.shape
    m = sch.fwd_margin
    ext, _ = TB.run_exts(levels, m, 0)
    lens = TD.run_lengths(n, levels)
    ds, cur = [], x
    for k, idx in enumerate(fwd_windows(n, levels, tile, m, rewrite)):
        s_c, d_c = TS.lift_fwd_axis_ext(_gather(cur, idx), sch, axis=-1, mode=mode)
        off, half = ext[k] // 2 - m, (tile >> k) // 2
        ds.append(d_c[:, :, off:off + half].reshape(rows, -1)[:, :lens[k] // 2])
        cur = s_c
    last = lens[-1] - lens[-1] // 2
    return s_c[:, :, :(tile >> (levels - 1)) // 2].reshape(rows, -1)[:, :last], ds


def mirror_inv(s, ds, levels, tile, mode, sch, rewrite=True):
    rows = s.shape[0]
    n = TD.run_input_len(s, ds)
    maps = inv_windows(n, levels, tile, sch.inv_margin, rewrite)
    merged = None
    for k in range(levels - 1, -1, -1):
        d_src, s_src = maps[k]
        sw = _gather(s, s_src) if k == levels - 1 else _gather(merged, s_src)
        merged = TS.lift_inv_axis_ext(sw, _gather(ds[k], d_src), sch, axis=-1, mode=mode)
    return merged.reshape(rows, -1)[:, :n]


LENGTHS = list(range(16, 41)) + [63, 64, 65, 100, 257, 1001, 4099]


@pytest.mark.parametrize("name", WINDOWED)
def test_tile_mirror_equals_the_per_level_plain_versions(name):
    """At forced tiles of 2^L, 3 x 2^L and 5 x 2^L level-0 samples (every
    tile an end tile, windows many tiles wide), runs of 1-6 levels, n =
    16-40 and up to 4099, both modes: the mirror's forward and inverse
    equal the per-level plain versions.  Without the line-end rewrite the
    mirror goes wrong, so the rewrite is what makes the run exact."""
    sch = TS.get_scheme(name)
    cases = broken = 0
    for n in LENGTHS:
        x = torch.from_numpy(_line((2, n)))
        for levels in range(1, 7):
            lens = TD.run_lengths(n, levels)
            if lens[-1] < 2 or not all(sch.can_window(v) for v in lens):
                continue
            for mode in MODES:
                s0, d0 = TD.lift_fwd_run_plain(x, levels, mode, sch)
                for q in (1, 3, 5):
                    tile = q << levels
                    s1, d1 = mirror_fwd(x, levels, tile, mode, sch)
                    _eq(s1, s0)
                    for a, b in zip(d1, d0):
                        _eq(a, b)
                    _eq(mirror_inv(s0, d0, levels, tile, mode, sch), x)
                    cases += 1
                    if levels > 1 and q == 1:
                        s2, d2 = mirror_fwd(x, levels, tile, mode, sch, rewrite=False)
                        xi = mirror_inv(s0, d0, levels, tile, mode, sch, rewrite=False)
                        broken += not (torch.equal(s2, s0) and torch.equal(xi, x)
                                       and all(torch.equal(a, b) for a, b in zip(d2, d0)))
    assert cases > 200
    assert broken > 0 or sch.halo == 0  # haar reads nothing past a line's end


@pytest.mark.parametrize("levels", [1, 2, 4, 6])
def test_mirror_windows_fit_the_rows_shared_memory(levels):
    """Each level's window, as an even and an odd plane, fits the buffer
    ``backend.run_row_bytes`` gives it.  Forward: two load buffers of the
    level-0 window, the even levels' windows in the current one, the odd
    levels' in buffer B.  Inverse: two load regions of every level's d
    plane and the coarsest s plane, the even levels' s planes in buffer
    A, the odd levels' in B."""
    for name in WINDOWED:
        sch = TS.get_scheme(name)
        fm, im = sch.fwd_margin, sch.inv_margin
        for tile in (1 << levels, 3 << levels, 4096 // (1 << levels) * (1 << levels)):
            planes = [w.shape[1] // 2 for w in fwd_windows(1 << 14, levels, tile, fm)]
            need_f = 4 * _round4(max(planes[0::2])) + 2 * _round4(max(planes[1::2], default=0))
            pairs = [d.shape[1] for d, _ in inv_windows(1 << 14, levels, tile, im)]
            region = sum(_round4(p) for p in pairs) + _round4(pairs[-1])
            need_i = 2 * region + _round4(max(pairs[0::2])) + _round4(max(pairs[1::2], default=0))
            assert 4 * max(need_f, need_i) == TB.run_row_bytes(tile, levels, fm, im)


# ---------------------------------------------------------------------------
# Runs in a pyramid, the tile from the budget, the launches.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cdf53", "97m", "haar", "cdf22"])
@pytest.mark.parametrize("n", [16, 33, 100, 4099, 60000, 65537])
def test_level_runs_split_at_the_first_level_that_does_not_window(name, n):
    """``level_runs_1d`` groups consecutive levels of 8 pairs or more
    (``_in_run``), windowed or policy, whatever the scheme, and gives
    every shorter level alone, in level order; each level's ``plan_1d``
    agrees: ``windowed-torch`` where the scheme windows the length,
    ``policy-torch`` where it does not (cdf22 always, haar on odd
    lengths), ``rows-torch`` under 8 pairs."""
    sch = TS.get_scheme(name)
    levels = 6
    runs = TO.level_runs_1d(n, levels, sch)
    assert sum(c for _, c in runs) == levels
    flat = [w for w, c in runs for _ in range(c)]
    lens = TD.run_lengths(n, levels)
    assert flat == [TO._in_run(v) for v in lens] == [v >= 16 for v in lens]
    plans = [TO.plan_1d(v, "cpu", name) for v in lens]
    assert flat == [p != "rows-torch" for p in plans]
    for w, v, p in zip(flat, lens, plans):
        if w:
            assert p == ("windowed-torch" if sch.can_window(v) else "policy-torch")
    for (w1, _), (w2, _) in zip(runs, runs[1:]):
        assert not (w1 and w2)  # maximal runs
    assert all(c == 1 for w, c in runs if not w)
    if name == "cdf22":
        assert all(p != "windowed-torch" for p in plans)
    if name == "haar":
        assert all((p == "policy-torch") == (v % 2 == 1 and v >= 16)
                   for v, p in zip(lens, plans))


def test_level_runs_of_the_repo_configs():
    assert TO.level_runs_1d(65536, 4, "cdf53") == [(True, 4)]
    assert TO.level_runs_1d(65536, 4, "haar") == [(True, 4)]
    assert TO.level_runs_1d(4099, 4, "haar") == [(True, 4)]
    assert TO.level_runs_1d(65536, 4, "cdf22") == [(True, 4)]
    assert TO.level_runs_1d(2048 * 5632, 4, "cdf22") == [(True, 4)]
    assert TO.level_runs_1d(100, 4, "97m") == [(True, 3), (False, 1)]
    assert TO.level_runs_1d(100, 4, "cdf22") == [(True, 3), (False, 1)]
    assert TO.level_runs_1d(15, 2, "cdf53") == [(False, 1), (False, 1)]


def test_run_tile_comes_from_the_card_budget(monkeypatch):
    """Tiles of 4096 samples at the repo's shapes; a line that is not a
    whole number of them is cut evenly (4099 into two of 2064); short
    lines take one tile and stack rows; every pick fits a quarter of an
    SM; a smaller card gets smaller tiles; a run too deep for its reach is
    refused (and ``run_launches`` shortens it)."""
    share = TB.H100_SMEM_PER_SM // 4 - 1024
    for name in WINDOWED:
        sch = TS.get_scheme(name)
        fm, im = sch.fwd_margin, sch.inv_margin
        assert TB.run_tile(64, 65536, 4, fm, im) == (4096, 1)
        assert TB.run_tile(1, 11534336, 4, fm, im) == (4096, 1)
        assert TB.run_tile(3, 4099, 4, fm, im) == (2064, 1)
        assert TD.run_launches(1024, 65536, 4, name) == ((4, 4096, 1),)
        tile, rb = TB.run_tile(10 ** 6, 64, 2, fm, im)
        assert (tile, rb) == (64, 4)
        for rows, n, levels in ((1, 16, 1), (7, 100, 3), (2048, 40, 1), (3, 4099, 6)):
            tile, rb = TB.run_tile(rows, n, levels, fm, im)
            assert tile % (1 << levels) == 0 and tile <= max(4096, 1 << levels)
            assert tile < n + (1 << levels) and 1 <= rb <= min(rows, 4)
            assert rb * TB.run_row_bytes(tile, levels, fm, im) <= share
    assert TB.run_tile(1, 1 << 20, 12, 1, 1) is None
    launches = TD.run_launches(1, 1 << 20, 12, "cdf53")
    assert sum(c for c, _, _ in launches) == 12 and len(launches) == 2
    small = {"smem_per_block": 49152, "smem_per_sm": 65536, "sms": 16}
    monkeypatch.setattr(TB, "budgets", lambda device=None: dict(small))
    tile, rb = TB.run_tile(64, 65536, 4, 1, 1)
    assert tile < 4096 and TB.run_row_bytes(tile, 4, 1, 1) <= 65536 // 4 - 1024


class _Recorder:
    """Stands in for the C launchers: records each call's function and
    arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, fn, args):
        self.calls.append((name, fn, args))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "call", rec)
    monkeypatch.setattr(_build, "check_tensors", lambda label, ts, dtypes=None: 0)
    monkeypatch.setattr(_build, "current_stream_handle", lambda dev: 0)
    TK.launches.reset()
    return rec


def test_forward_run_is_one_launch_with_every_band_address(recorder):
    """One ``repro_lift1d_run_fwd`` call for a 4-level run: the input,
    then levels + 1 band addresses (d_0 .. d_3, s_3) in the one
    allocation, each 16-byte aligned and each band's views the shapes a
    forward level gives; one ``lift1d_fwd`` count."""
    x = torch.from_numpy(_line((3, 4099)))
    s, ds = TD.lift_fwd_run_cuda(x, 4, "paper", "cdf53")
    assert [c[1] for c in recorder.calls] == ["repro_lift1d_run_fwd"]
    _, _, args = recorder.calls[0]
    assert args[1] == x.data_ptr()
    lens = TD.run_lengths(4099, 4)
    assert [tuple(d.shape) for d in ds] == [(3, v // 2) for v in lens]
    assert tuple(s.shape) == (3, lens[-1] - lens[-1] // 2)
    ints = [v.value for v in args[3:9]]
    assert ints == [3, 4099, 4, 2064, 1, 1]
    assert TK.launches.snapshot() == {"lift1d_fwd": 1}
    plan = TD._run_plan(3, 4099, 4, TS.get_scheme("cdf53"), "paper", False, x.device)
    assert all(v[2] % 4 == 0 for v in plan.views)
    base = ds[0].data_ptr()
    assert list(plan.offsets[0] + base) == [t.data_ptr() for t in list(ds) + [s]]


def test_inverse_run_is_one_launch_reading_every_band(recorder):
    x = torch.from_numpy(_line((2, 65536)))
    s, ds = TD.lift_fwd_run_plain(x, 4, "jpeg2000", "97m")
    s, ds = s.contiguous(), [d.contiguous() for d in ds]
    out = TD.lift_inv_run_cuda(s, ds, "jpeg2000", "97m")
    assert [c[1] for c in recorder.calls] == ["repro_lift1d_run_inv"]
    assert tuple(out.shape) == (2, 65536)
    args = recorder.calls[0][2]
    assert args[2] == out.data_ptr()
    assert [v.value for v in args[3:9]] == [2, 65536, 4, 4096, 1, 2]
    assert TK.launches.snapshot() == {"lift1d_inv": 1}


def test_forced_blocks_are_a_run_of_one_level(recorder):
    """``lift_fwd_windows_cuda(x, mode, rb, bp)`` keeps its signature: one
    level at tiles of 2 x bp samples and rb rows a block."""
    x = torch.from_numpy(_line((5, 77)))
    TD.lift_fwd_windows_cuda(x, "paper", 2, 3, "cdf53")
    s, d = TD.lift_fwd_windows_plain(x, "paper", 3, "cdf53")
    TD.lift_inv_windows_cuda(s.contiguous(), d.contiguous(), "paper", 3, 1, "cdf53")
    fwd, inv = (c[2] for c in recorder.calls)
    assert [v.value for v in fwd[3:9]] == [5, 77, 1, 6, 2, 1]
    assert [v.value for v in inv[3:9]] == [5, 77, 1, 2, 3, 1]
    assert TK.launches.snapshot() == {"lift1d_fwd": 1, "lift1d_inv": 1}


@pytest.mark.parametrize("name,n,runs", [("cdf53", 65536, 1), ("haar", 65536, 1),
                                         ("97m", 65536, 1), ("haar", 4099, 1),
                                         ("cdf22", 65536, 1), ("haar", 65537, 1),
                                         ("cdf22", 4099, 1)])
def test_unchecked_pyramid_launches_once_a_run(recorder, monkeypatch, name, n, runs):
    """An unchecked ``dwt_fwd(levels=4)`` / ``dwt_inv`` of a line whose
    levels all have 8 pairs or more launches ``lift1d_fwd`` /
    ``lift1d_inv`` once each: windowed runs (the ``LARGE`` configs) and
    policy runs (cdf22; haar at 4099 and 65,537, odd levels) alike, and
    no row pass."""
    monkeypatch.setattr(TB, "on_cuda", lambda t: True)
    monkeypatch.setattr(TD, "rows_fwd_cuda", lambda x, mode, scheme: TS.lift_fwd_axis(
        x, scheme, axis=-1, mode=mode))
    monkeypatch.setattr(TD, "rows_inv_cuda", lambda s, d, mode, scheme: TS.lift_inv_axis(
        s, d, scheme, axis=-1, mode=mode))
    x = torch.from_numpy(_line((2, n)))
    pyr = TK.dwt_fwd(x, levels=4, scheme=name, checked=False)
    TK.dwt_inv(pyr, scheme=name, checked=False)
    assert TK.launches.snapshot() == {"lift1d_fwd": runs, "lift1d_inv": runs}
    assert [c[1] for c in recorder.calls] == ["repro_lift1d_run_fwd", "repro_lift1d_run_inv"]
