"""Policy runs of the 1-D run kernels (``csrc/lift1d.cu``) on the CPU.

A level whose scheme does not commute with whole-point reflection on its
length (cdf22 at every length, haar on odd lengths) follows the band
policy: the reference reflects the current streams at every lifting
step.  The run kernels do the same in a policy run: a tile whose window
crosses a line end rewrites the step's target after every step.  The
kernels need the card (``tests/test_torch_cuda.py``); here: a numpy
mirror of that dataflow — each tile's window, the per-step rewrites, the
level transitions — held against the band-policy oracle at forced tiny
tiles and the plan's tile, and shown to go wrong without the per-step
rule or without the policy run's extra pair of margin; the port's 1-D
transforms, checked and not, and its 1-D containers and streams against
``repro`` on the same seeded arrays; and the launches a policy run takes,
with the C launcher replaced by a recorder.
"""
import numpy as np
import pytest
import torch

import repro.kernels as RK
from repro.codec import container as RC
from repro.codec import stream as RS
from repro_torch import kernels as TK
from repro_torch.codec import container as TC
from repro_torch.codec import stream as TSTREAM
from repro_torch.core import schemes as TS
from repro_torch.kernels import _build
from repro_torch.kernels import backend as TB
from repro_torch.kernels import dwt53 as TD

POLICY = ("cdf22", "haar")
MODES = ("paper", "jpeg2000")
RNG = np.random.default_rng(2323)


def _line(shape, lo=-(1 << 20), hi=1 << 20):
    return RNG.integers(lo, hi, shape).astype(np.int32)


def _eq(got, want) -> None:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# A numpy mirror of a policy run (lift1d.cu run_fwd_kernel<true> /
# run_inv_kernel<true>): every tile's window as an even and an odd plane,
# the interior-only cascade with its valid ranges, the rewrite of the
# target's out-of-range entries after every step, and the rewrite of the
# next level's window at each level transition.
# ---------------------------------------------------------------------------


def _reflect_index(pos, n):
    """lift2d.cuh reflect_index on an array of positions."""
    period = 2 * (n - 1)
    q = np.mod(pos, period)
    return np.where(q > n - 1, period - q, q)


def _reflect_entry(p, parity, n):
    return (_reflect_index(2 * p + parity, n) - parity) // 2


def _gather(a, idx):
    """(rows, tiles, W) gathered along its last axis per tile by a
    (tiles, K) index map."""
    idx = torch.as_tensor(idx)
    return torch.gather(a, 2, idx[None].expand(a.shape[0], -1, -1))


def _cascade(planes, steps, base, n, inverse, per_step):
    """lift1d.cu lift_row over every tile's planes; ``base`` (tiles, 1):
    the stream entry of each plane's entry 0; ``per_step``: the policy
    run's rewrite (reflect_plane) after every step."""
    pext = planes[0].shape[-1]
    lo, hi = [0, 0], [pext, pext]
    for st in reversed(steps) if inverse else steps:
        tp = 1 if st.kind == "predict" else 0
        sp = 1 - tp
        offs = [o for o, _ in st.taps]
        nlo, nhi = max(lo[tp], lo[sp] - min(offs)), min(hi[tp], hi[sp] - max(offs))
        reads = [planes[sp][..., nlo + o:nhi + o] for o in offs]
        tgt = planes[tp].clone()
        tgt[..., nlo:nhi] = TS._apply_taps(st, tgt[..., nlo:nhi], reads, inverse)
        if per_step:
            i = np.arange(nlo, nhi)[None, :]
            p = base + i
            length = n >> 1 if tp else (n + 1) >> 1
            r = _reflect_entry(p, tp, n) - base
            hit = ((p < 0) | (p >= length)) & (r >= nlo) & (r < nhi)
            tgt[..., nlo:nhi] = _gather(tgt, np.where(hit, r, np.broadcast_to(i, hit.shape)))
        planes[tp] = tgt
        lo[tp], hi[tp] = nlo, nhi
    return planes


def mirror_fwd(x, levels, tile, mode, sch, margin, per_step=True):
    """The forward run kernel on the mirror's windows, at forward margin
    ``margin`` (pairs): (last s, [d of each level])."""
    rows, n = x.shape
    steps = TS.resolved_steps(sch, mode)
    ext, _ = TB.run_exts(levels, margin, 0)
    lens = TD.run_lengths(n, levels)
    t = np.arange(-(-n // tile))[:, None]
    start, width = t * tile - ext[0], tile + 2 * ext[0]
    win = x[:, torch.as_tensor(_reflect_index(start + np.arange(width)[None], n))]
    ev, od = win[..., 0::2], win[..., 1::2]
    ds = []
    for k in range(levels):
        nk = lens[k]
        ev, od = _cascade([ev, od], steps, start // 2, nk, False, per_step)
        c0, half = ext[k] // 2, (tile >> k) // 2
        ds.append(od[..., c0:c0 + half].reshape(rows, -1)[:, :nk // 2])
        if k + 1 == levels:
            return ev[..., c0:c0 + half].reshape(rows, -1)[:, :nk - nk // 2], ds
        ne, w1, start1 = nk - nk // 2, half + 2 * ext[k + 1], start // 2 + margin
        j = np.arange(w1)[None, :]
        q = start1 + j
        r = _reflect_index(q, ne) - start1
        hit = ((q < 0) | (q >= ne)) & (r >= 0) & (r < w1)
        sv = _gather(ev[..., margin:margin + w1].contiguous(),
                     np.where(hit, r, np.broadcast_to(j, hit.shape)))
        ev, od, start = sv[..., 0::2], sv[..., 1::2], start1


def mirror_inv(s, ds, tile, mode, sch, margin, per_step=True):
    """The inverse run kernel on the mirror's windows, at inverse margin
    ``margin``: the (rows, n) level-0 signal."""
    rows, levels = s.shape[0], len(ds)
    n = TD.run_input_len(s, ds)
    steps = TS.resolved_steps(sch, mode)
    _, ext = TB.run_exts(levels, 0, margin)
    lens = TD.run_lengths(n, levels)
    t = np.arange(-(-n // tile))[:, None]
    k = levels - 1
    a = t * ((tile >> k) // 2) - ext[k]
    e = a + np.arange((tile >> k) // 2 + 2 * ext[k])[None]
    ev = s[:, torch.as_tensor(_reflect_entry(e, 0, lens[k]))]
    od = ds[k][:, torch.as_tensor(_reflect_entry(e, 1, lens[k]))]
    while True:
        ev, od = _cascade([ev, od], steps, a, lens[k], True, per_step)
        merged = torch.stack([ev, od], -1).reshape(rows, ev.shape[1], -1)
        if k == 0:
            return merged[..., 2 * margin:2 * margin + tile].reshape(rows, -1)[:, :n]
        n1, half1 = lens[k - 1], (tile >> (k - 1)) // 2
        a1 = t * half1 - ext[k - 1]
        e = a1 + np.arange(half1 + 2 * ext[k - 1])[None]
        rr = _reflect_entry(e, 0, n1) - 2 * a
        hit = ((e < 0) | (e >= lens[k])) & (rr >= 2 * margin) & (rr < 2 * ev.shape[-1] - 2 * margin)
        ev = _gather(merged, np.where(hit, rr, e - 2 * a))
        od = ds[k - 1][:, torch.as_tensor(_reflect_entry(e, 1, n1))]
        k, a = k - 1, a1


def _oracle(x, levels, mode, sch):
    """The band-policy reference, one level at a time (the port's oracle,
    ``schemes.lift_fwd_axis``)."""
    ds = []
    for _ in range(levels):
        x, d = TS.lift_fwd_axis(x, sch, axis=-1, mode=mode)
        ds.append(d)
    return x, ds


def _mirror_ok(x, s0, d0, levels, tile, mode, sch, fm, im, per_step=True) -> bool:
    s1, d1 = mirror_fwd(x, levels, tile, mode, sch, fm, per_step)
    xi = mirror_inv(s0, d0, tile, mode, sch, im, per_step)
    return (torch.equal(s1, s0) and all(torch.equal(a, b) for a, b in zip(d1, d0))
            and torch.equal(xi, x))


MIRROR_LENGTHS = list(range(16, 41)) + [4099, 60001]


def _policy_cases(name):
    """(n, levels) of the policy runs from MIRROR_LENGTHS, 1-6 levels."""
    sch = TS.get_scheme(name)
    for n in MIRROR_LENGTHS:
        for levels in range(1, 7):
            lens = TD.run_lengths(n, levels)
            if lens[-1] >= 2 and TD.run_policy(sch, n, levels):
                yield n, levels


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", POLICY)
def test_policy_mirror_equals_the_band_policy(name, mode):
    """cdf22, and haar wherever a level is odd, at n = 16-40, 4099 and
    60,001, runs of 1-6 levels: the mirror's forward and inverse with the
    per-step rewrite and the policy run's margins equal the band policy,
    at forced tiles of 2^L and 3 x 2^L level-0 samples (every tile an end
    tile, a last tile of one sample) and at the plan's tile."""
    sch = TS.get_scheme(name)
    fm, im = TD.run_margins(sch, True)
    cases = 0
    for n, levels in _policy_cases(name):
        x = torch.from_numpy(_line((2, n)))
        s0, d0 = _oracle(x, levels, mode, sch)
        unit = 1 << levels
        tiles = {unit, 3 * unit}
        pick = TB.run_tile(2, n, levels, fm, im)
        if pick is not None:
            tiles.add(pick[0])
        for tile in sorted(tiles):
            assert _mirror_ok(x, s0, d0, levels, tile, mode, sch, fm, im), (n, levels, tile)
            cases += 1
    assert cases > 150


@pytest.mark.parametrize("name", POLICY)
def test_per_level_rewrite_alone_is_not_the_band_policy(name):
    """The windowed runs' rule alone — reflect each level's window once,
    no rewrite after the steps — misses the band policy: the per-step
    rewrite is what makes a policy run exact."""
    sch = TS.get_scheme(name)
    fm, im = TD.run_margins(sch, True)
    broken = total = 0
    for n, levels in _policy_cases(name):
        if n > 4099:
            continue
        x = torch.from_numpy(_line((2, n)))
        s0, d0 = _oracle(x, levels, "paper", sch)
        total += 1
        broken += not _mirror_ok(x, s0, d0, levels, 1 << levels, "paper", sch, fm, im,
                                 per_step=False)
    assert total > 50 and broken > total // 2


@pytest.mark.parametrize("name", POLICY)
def test_policy_runs_need_one_more_pair_of_margin(name):
    """At the scheme's own margins the per-step rewrite is not enough: a
    last tile holding one in-range entry at some level (11,534,337 samples
    cut into tiles of 4096 leaves one) finds the source of its rewrite a
    pair before its core, outside the window.  One more pair is enough
    (the first test); the planner gives it (``run_margins``)."""
    sch = TS.get_scheme(name)
    assert TD.run_margins(sch, True) == (sch.fwd_margin + 1, sch.inv_margin + 1)
    assert TD.run_margins(sch, False) == (sch.fwd_margin, sch.inv_margin)
    broken = 0
    for n in (17, 19, 33, 4097):
        x = torch.from_numpy(_line((2, n)))
        for levels in (1, 2, 3):
            s0, d0 = _oracle(x, levels, "paper", sch)
            for tile in (1 << levels, 4096):
                broken += not _mirror_ok(x, s0, d0, levels, tile, "paper", sch,
                                         sch.fwd_margin, sch.inv_margin)
    assert broken > 0
    assert TB.run_tile(1, 2048 * 5632 + 1, 4, *TD.run_margins(sch, True))[0] == 4096


def test_symmetric_schemes_are_windowed_runs():
    """cdf53 and 97m never need the policy; haar only where a level is
    odd; cdf22 always."""
    for n in (16, 17, 4099, 4100, 65536, 65537):
        for levels in (1, 4):
            lens = TD.run_lengths(n, levels)
            assert not TD.run_policy(TS.get_scheme("cdf53"), n, levels)
            assert not TD.run_policy(TS.get_scheme("97m"), n, levels)
            assert TD.run_policy(TS.get_scheme("cdf22"), n, levels)
            assert TD.run_policy(TS.get_scheme("haar"), n, levels) == any(v % 2 for v in lens)


# ---------------------------------------------------------------------------
# The port's 1-D transforms and containers against the reference.
# ---------------------------------------------------------------------------


def _pyr_eq(got, want) -> None:
    _eq(got.approx, want.approx)
    assert len(got.details) == len(want.details)
    for g, w in zip(got.details, want.details):
        _eq(g, w)


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("shape", [(2, 4099), (3, 4100), (2, 3, 1001), (1, 65537)])
@pytest.mark.parametrize("name", POLICY)
def test_dwt_pyramids_equal_the_reference(name, shape, checked):
    """The same seeded arrays through ``repro.kernels.dwt_fwd`` /
    ``dwt_inv`` and the port's, 1-5 levels (4 checked: the reference's
    checked path compiles a trace a level), odd and even
    lengths (haar at 4100 turns odd at level 2), leading dims: every band
    and every reconstruction equal."""
    x = _line(shape, -30000, 30000)
    mode = "jpeg2000" if checked else "paper"
    for levels in (4,) if checked else range(1, 6):
        want = RK.dwt_fwd(x, levels=levels, mode=mode, scheme=name, checked=checked)
        got = TK.dwt_fwd(torch.from_numpy(x), levels=levels, mode=mode, scheme=name,
                         checked=checked)
        _pyr_eq(got, want)
        _eq(TK.dwt_inv(got, mode=mode, scheme=name, checked=checked), x)
        _eq(RK.dwt_inv(want, mode=mode, scheme=name, checked=checked), x)
    s, d = TK.dwt_fwd_1d(torch.from_numpy(x), mode=mode, scheme=name, checked=checked)
    rs, rd = RK.dwt_fwd_1d(x, mode=mode, scheme=name, checked=checked)
    _eq(s, rs)
    _eq(d, rd)
    _eq(TK.dwt_inv_1d(s, d, mode=mode, scheme=name, checked=checked), x)


@pytest.mark.parametrize("name", POLICY)
def test_1d_container_and_stream_bytes_equal_the_reference(name):
    """WZRC containers of the port's 4-level pyramids and WZRS streams of
    1-D chunks through its stream encoder (policy runs at every chunk
    past 16 samples) equal the reference's bytes, and decode back."""
    x = _line((3, 4099), -3000, 3000)
    want = RC.encode_pyramid(RK.dwt_fwd(x, levels=4, scheme=name), scheme=name)
    tp = TK.dwt_fwd(torch.from_numpy(x), levels=4, scheme=name)
    got = TC.encode_pyramid(tp, scheme=name)
    assert got == want
    _eq(TC.inverse_transform(TC.decode_pyramid(got, device="cpu")), x)
    chunks = [_line(shape, -3000, 3000) for shape in ((2, 4097), (3, 1001), (1, 13))]
    enc_r = RS.StreamEncoder(levels=4, scheme=name, ndim=1)
    enc_t = TSTREAM.StreamEncoder(levels=4, scheme=name, ndim=1, device="cpu")
    data = b"".join(enc_t.encode(chunks))
    assert data == b"".join(enc_r.encode(chunks))
    for a, b in zip(TSTREAM.decode_stream(data, device="cpu"), chunks):
        _eq(a, b)


# ---------------------------------------------------------------------------
# Launches, with the C launchers replaced by a recorder.
# ---------------------------------------------------------------------------


@pytest.fixture
def recorder(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda name, fn, args: calls.append((fn, args)))
    monkeypatch.setattr(_build, "check_tensors", lambda label, ts, dtypes=None: 0)
    monkeypatch.setattr(_build, "current_stream_handle", lambda dev: 0)
    TK.launches.reset()
    return calls


@pytest.mark.parametrize("name,n,margins,policy", [
    ("cdf22", 4099, (2, 2), 1), ("haar", 4099, (1, 1), 1), ("haar", 4100, (1, 1), 1),
    ("haar", 65536, (0, 0), 0), ("cdf53", 4099, (1, 1), 0)])
def test_run_launch_carries_the_policy_flag_and_its_margin(recorder, name, n, margins, policy):
    """A 4-level run is one launch each way; its integer arguments are
    (rows, n, levels, tile, rows a block, margin, policy): a policy run
    passes policy 1 and one more pair of margin, a windowed run the
    scheme's margin and 0; the tile comes from ``run_tile`` at those
    margins."""
    sch = TS.get_scheme(name)
    x = torch.from_numpy(_line((3, n)))
    s, ds = TD.lift_fwd_run_cuda(x, 4, "paper", sch)
    TD.lift_inv_run_cuda(s.contiguous(), [d.contiguous() for d in ds], "paper", sch)
    (ffn, fargs), (ifn, iargs) = recorder
    assert (ffn, ifn) == ("repro_lift1d_run_fwd", "repro_lift1d_run_inv")
    tile, rb = TB.run_tile(3, n, 4, *margins)
    assert [v.value for v in fargs[3:10]] == [3, n, 4, tile, rb, margins[0], policy]
    assert [v.value for v in iargs[3:10]] == [3, n, 4, tile, rb, margins[1], policy]
    assert TK.launches.snapshot() == {"lift1d_fwd": 1, "lift1d_inv": 1}
