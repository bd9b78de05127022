"""Multi-rank 2-D DWT: rows sharded over a mesh axis, halo rows exchanged.

Port of ``repro.kernels.sharded``.  The image's row axis (-2) is split
evenly over ``mesh[axis]`` (``data`` by default); each rank holds full
rows of its shard, and a multi-level 2-D Mallat pyramid needs only
``scheme.halo`` rows from each neighbour per level (2 for cdf53, 4 for
97m, none for haar).  SPMD as torch runs it: every rank calls with the
same arguments, and the neighbours' rows travel by
``dist.batch_isend_irecv`` over ``mesh.get_group(axis)``
(``repro_torch.collectives``: NCCL directly, or gloo through pinned host
buffers for CUDA tensors).

Where the reference runs band-policy math along the width and then
interior-only math (``lift_fwd_axis_ext``) on the exchanged column
stage, each rank here runs one level of the port's own 2-D kernels on an
extended shard and crops it (the *ext-crop* design):

  * Forward: exchange ``halo`` INPUT rows each way; the wire carries the
    same bytes as the reference's width-transformed ``s_r | d_r`` rows
    (the width transform maps a row to a row of the same width).  At the
    global edges the whole-point reflect rows ``[halo .. 1]`` /
    ``[h_loc-2 .. h_loc-halo-1]`` take the place of the received rows.
    Run ``fused2d.dwt_fwd_2d_multi(ext, levels=1)`` on the ``halo + h_loc
    + halo`` rows (``whole2d.cu`` / ``tiled2d.cu`` on the card, their
    plain versions on the CPU) and keep band rows ``[fwd_margin,
    fwd_margin + h_loc/2)``.
  * Inverse: extend each band by ``inv_margin`` rows, exchanged or (at
    the global edges) the band-policy edge rows of the reference
    (``s_top`` / ``d_top`` / ``s_bot`` / ``d_bot``), run one inverse
    level and keep image rows ``[2m, 2m + 2 n_loc)``.

Why the crop equals the reference's interior math: the width pass is
per row, so it commutes with the row extension.  Along the columns, the
band policy on the extended shard computes every entry from the same
reads as the interior math wherever those reads fall inside the
extension; a read outside it only ever feeds an entry within the margin,
because ``halo = 2 * fwd_margin`` (``core/schemes.py``) is exactly the
support of the step cascade's cone (``_margins``), and ``inv_margin``
the inverse cascade's.  So the kept core is the interior math's core,
bit for bit; ``tests/test_torch_sharded.py`` holds the identity against
``schemes.lift_fwd_axis_ext`` / ``lift_inv_axis_ext``.  At the global
edges the reflect rows reproduce the band policy for the same reason as
in the reference: the scheme's steps commute with whole-point reflection
(:func:`check_shardable` refuses cdf22, whose steps do not).

Results are ``Pyramid2D`` s whose bands are DTensors, ``Shard(ndim-2)``
on ``mesh[axis]`` and ``Replicate()`` on every other mesh dim: the output
stays sharded.  ``timeout_s`` arms the host-side collective watchdog.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch import sharding as SH
from repro_torch.collectives import AxisComm, mesh_device
from repro_torch.core import ranges as _ranges
from repro_torch.core import schemes as S
from repro_torch.core.lifting import Pyramid2D
from repro_torch.kernels import fused2d as _f2d
from repro_torch.kernels.ops import _compute_dtype
from repro_torch.resilience import inject
from repro_torch.resilience.errors import CollectiveTimeoutError

Tensor = torch.Tensor

WATCHDOG_THREAD = "collective-watchdog"  # name prefix of the watchdog's workers


def _watchdogged(thunk, label: str, timeout_s: Optional[float], comm: AxisComm,
                 device: torch.device):
    """Run a collective-bearing thunk under a host-side completion watchdog.

    A stuck neighbour (dead host, wedged interconnect) hangs a
    point-to-point receive, and with it the caller, forever.  The thunk
    runs on a daemon worker thread (named ``collective-watchdog:<label>``)
    that blocks until the device is done (``torch.cuda.synchronize``, the
    reference's ``jax.block_until_ready``); past ``timeout_s`` the caller
    gets :class:`CollectiveTimeoutError` naming the neighbours it waits
    on, so the controller can evict or reshard instead of hanging.  The
    orphaned worker is a daemon and cannot keep a dying process alive.
    ``timeout_s=None`` runs inline with no thread.

    The ``sharded.collective`` inject site sits inside the timed region,
    so a test can simulate the stuck neighbour with a delay fault.
    """
    if timeout_s is None:
        # fast path: the span measures host dispatch, not device completion
        with obs.span(label, subsystem="collectives"):
            inject.check("sharded.collective")
            return thunk()
    result: list = []
    failure: list = []

    def _run():
        try:
            inject.check("sharded.collective")
            out = thunk()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            result.append(out)
        except BaseException as e:  # noqa: BLE001 - surfaced below on the caller thread
            failure.append(e)

    worker = threading.Thread(target=_run, daemon=True, name=f"{WATCHDOG_THREAD}:{label}")
    t0 = time.perf_counter()
    # the worker blocks to completion, so the span is end-to-end collective time
    with obs.span(label, subsystem="collectives", timeout_s=timeout_s):
        worker.start()
        worker.join(timeout_s)
    if worker.is_alive():
        obs.counter("collectives.watchdog_trips").inc()
        obs.emit(obs.FaultEvent(
            subsystem="collectives", error="CollectiveTimeoutError",
            site=label, detail=f"no completion within {timeout_s}s",
        ))
        i, n = comm.index, comm.size
        peers = [j for j in (i - 1, i + 1) if 0 <= j < n]
        raise CollectiveTimeoutError(
            f"{label}: collective did not complete within {timeout_s}s — "
            "a mesh participant looks stuck (dead host or wedged "
            "interconnect); evict or reshard before retrying (member "
            f"{i} of {n} on axis {comm.axis!r} waits on members {peers})"
        )
    obs.histogram("collectives.exchange_ms").observe((time.perf_counter() - t0) * 1e3)
    if failure:
        raise failure[0]
    return result[0]


def _scheme_shardable(sch: S.LiftingScheme) -> bool:
    # the exchanged-halo interior math must reproduce the band policy:
    # reflection-commuting steps, or no halo at all (haar — column
    # lengths are even by the divisibility constraint)
    return sch.symmetric or sch.halo == 0


def check_shardable(h: int, w: int, n_shards: int, levels: int, scheme="cdf53") -> None:
    """Raise unless (h, w) supports a row-sharded ``levels``-deep pyramid."""
    sch = S.get_scheme(scheme)
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if not _scheme_shardable(sch):
        raise ValueError(
            f"scheme {sch.name!r} has reflection-asymmetric steps and no "
            "halo-free form; the sharded engine cannot reproduce its "
            "boundary policy — use the fused 2D engine instead"
        )
    wl = w
    for _ in range(levels):
        if wl < 3:
            raise ValueError(
                f"sharded transform needs W >= 3 at every level, got W={w} "
                f"({wl} at some level) for levels={levels}"
            )
        wl = wl - wl // 2
    step = n_shards << levels
    min_local = max(4, sch.halo + 2)  # coarsest-level local rows floor
    if h % step or 2 * (h // step) < min_local:
        raise ValueError(
            f"sharded transform needs H divisible by axis_size * 2**levels "
            f"with >= {min_local} local rows at the coarsest level; got "
            f"H={h}, axis_size={n_shards}, levels={levels}, "
            f"scheme={sch.name!r} (halo={sch.halo})"
        )


def _pick_rows(x: Tensor, idx: Sequence[int]) -> Tensor:
    """Rows ``idx`` of ``x`` (axis -2), in the given order."""
    return x.index_select(-2, torch.tensor(list(idx), device=x.device))


def _exchange_rows(
    top_send: Tensor,
    bot_send: Tensor,
    comm: AxisComm,
    top_edge: Optional[Tensor],
    bot_edge: Optional[Tensor],
) -> Tuple[Tensor, Tensor]:
    """Swap border rows with the row neighbours; the edges take the given
    rows.  Member i receives ``bot_send`` of member i-1 (its top halo) and
    ``top_send`` of member i+1 (its bottom halo), in one batch; the wire
    carries exactly the border rows.  ``top_edge`` / ``bot_edge`` are
    read only on the first / last member (None elsewhere)."""
    i, n = comm.index, comm.size
    sends, recvs = [], []
    if i > 0:
        sends.append((i - 1, top_send))
        recvs.append((i - 1, tuple(bot_send.shape), bot_send.dtype))
    if i < n - 1:
        sends.append((i + 1, bot_send))
        recvs.append((i + 1, tuple(top_send.shape), top_send.dtype))
    got = comm.exchange(sends, recvs, top_send.device)
    top = got.pop(0) if i > 0 else top_edge
    bot = got.pop(0) if i < n - 1 else bot_edge
    return top, bot


def _fwd_level_local(x: Tensor, scheme, mode: str, comm: AxisComm):
    """One forward 2-D level on a row shard: exchange ``halo`` input rows,
    one level of the 2-D kernels on the extended shard, crop."""
    sch = S.get_scheme(scheme)
    halo, m = sch.halo, sch.fwd_margin
    h_loc = x.shape[-2]
    ext = x
    if halo:
        first, last = comm.index == 0, comm.index == comm.size - 1
        # global-edge whole-point reflect rows: entries [-halo..-1] ->
        # [halo..1], [H..H+halo-1] -> [H-2..H-halo-1]
        top_edge = _pick_rows(x, range(halo, 0, -1)) if first else None
        bot_edge = _pick_rows(x, [h_loc - 2 - j for j in range(halo)]) if last else None
        top, bot = _exchange_rows(x[..., :halo, :], x[..., h_loc - halo:, :], comm,
                                  top_edge, bot_edge)
        ext = torch.cat([top, x, bot], dim=-2)
    pyr = _f2d.dwt_fwd_2d_multi(ext, levels=1, mode=mode, scheme=sch, checked=False)
    core = slice(m, m + h_loc // 2)
    lh, hl, hh = pyr.details[0]
    return tuple(b[..., core, :].contiguous() for b in (pyr.ll, lh, hl, hh))


def _inv_level_local(ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor,
                     scheme, mode: str, comm: AxisComm) -> Tensor:
    """One inverse 2-D level on row-sharded bands: ``inv_margin`` band
    rows exchanged, one inverse level of the 2-D kernels, crop."""
    sch = S.get_scheme(scheme)
    m = sch.inv_margin
    bands = (ll, lh, hl, hh)
    n_loc = ll.shape[-2]
    if m:
        widths = [b.shape[-1] for b in bands]
        first, last = comm.index == 0, comm.index == comm.size - 1
        # global-edge band-policy rows (column length even by
        # construction): s-role (ll, hl): [-j] -> [j], [n_e+j] ->
        # [n_e-1-j]; d-role (lh, hh): [-j] -> [j-1], [n_o+j] -> [n_o-2-j]
        s_top, d_top = list(range(m, 0, -1)), list(range(m - 1, -1, -1))
        s_bot = [n_loc - 1 - j for j in range(m)]
        d_bot = [n_loc - 2 - j for j in range(m)]
        roles = ("s", "d", "s", "d")  # rows of ll/hl are s-role, lh/hh d-role

        def edge(top: bool) -> Tensor:
            return torch.cat([
                _pick_rows(b, (s_top if r == "s" else d_top) if top else
                           (s_bot if r == "s" else d_bot))
                for b, r in zip(bands, roles)], dim=-1)

        top, bot = _exchange_rows(
            torch.cat([b[..., :m, :] for b in bands], dim=-1),
            torch.cat([b[..., n_loc - m:, :] for b in bands], dim=-1),
            comm, edge(True) if first else None, edge(False) if last else None)
        ext: List[Tensor] = []
        off = 0
        for b, wd in zip(bands, widths):
            ext.append(torch.cat([top[..., off:off + wd], b, bot[..., off:off + wd]], dim=-2))
            off += wd
        bands = tuple(ext)
    ll_e, lh_e, hl_e, hh_e = bands
    x = _f2d.dwt_inv_2d_multi(Pyramid2D(ll=ll_e, details=((lh_e, hl_e, hh_e),)),
                              mode=mode, scheme=sch, checked=False)
    return x[..., 2 * m:2 * m + 2 * n_loc, :]


# ---------------------------------------------------------------------------
# Placement: full tensors in, row-sharded DTensors out.
# ---------------------------------------------------------------------------


def _row_spec(ndim: int, axis: str):
    """PartitionSpec sharding the row (-2) axis, via sharding.py rules."""
    rules = {"rows": axis}
    axes = (None,) * (ndim - 2) + ("rows", None)
    return SH.spec_for(axes, rules)


def _row_placements(mesh, ndim: int, axis: str):
    return SH.placements(_row_spec(ndim, axis), mesh)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local_rows(t, mesh, axis: str, comm: AxisComm, device: torch.device) -> Tensor:
    """This rank's rows of ``t`` on ``device``: the local shard of a
    DTensor sharded as :func:`_row_placements` says, or rows ``[i*h/n,
    (i+1)*h/n)`` of a full tensor (only those rows are moved)."""
    if _is_dtensor(t):
        want = _row_placements(mesh, t.ndim, axis)
        if t.device_mesh != mesh or tuple(t.placements) != want:
            raise ValueError(
                f"a DTensor input must be sharded {want} on the transform's mesh; got "
                f"{tuple(t.placements)} on {t.device_mesh}"
            )
        return t.to_local().to(device)
    rows = t.shape[-2] // comm.size
    return t[..., comm.index * rows:(comm.index + 1) * rows, :].to(device)


def _to_global(local: Tensor, mesh, axis: str, comm: AxisComm):
    from torch.distributed.tensor import DTensor

    shape = tuple(local.shape[:-2]) + (local.shape[-2] * comm.size, local.shape[-1])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, _row_placements(mesh, local.ndim, axis),
                              run_check=False, shape=torch.Size(shape), stride=stride)


def dwt_fwd_2d_sharded(
    x,
    mesh,
    levels: int = 1,
    mode: str = "paper",
    axis: str = "data",
    scheme="cdf53",
    timeout_s: Optional[float] = None,
    checked=None,
) -> Pyramid2D:
    """Row-sharded multi-level 2-D forward transform over ``mesh[axis]``.

    ``x`` is a full ``(..., H, W)`` tensor (each rank takes its own rows
    and moves only those to its device) or a DTensor sharded
    ``Shard(ndim-2)`` on ``mesh[axis]``.  Bit-exact vs
    :func:`repro_torch.kernels.dwt_fwd_2d_multi` (and the reference) for
    the same scheme; only the scheme's halo rows move between ranks (one
    batch per level).  ``timeout_s`` arms the collective watchdog
    (:class:`~repro_torch.resilience.errors.CollectiveTimeoutError`
    instead of a hang); ``checked=True`` (or ``REPRO_DWT_CHECKED=1``)
    certifies the data first (``core/ranges.py``).
    """
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if x.ndim < 2:
        raise ValueError(f"need a (..., H, W) input, got {tuple(x.shape)}")
    comm = AxisComm(mesh, axis)
    check_shardable(x.shape[-2], x.shape[-1], comm.size, levels, sch)
    if _ranges.checked_enabled(checked):
        full = x.full_tensor() if _is_dtensor(x) else x
        return _ranges.run_checked(
            lambda _a: dwt_fwd_2d_sharded(x, mesh, levels=levels, mode=mode, axis=axis,
                                          scheme=sch, timeout_s=timeout_s, checked=False),
            full, scheme=sch, levels=levels, mode=mode, ndim=2,
            label="kernels.dwt_fwd_2d_sharded",
        )
    dev = mesh_device(mesh)
    x_loc = _local_rows(x, mesh, axis, comm, dev)
    x_loc = x_loc.to(_compute_dtype(x_loc.dtype))

    def local_fwd() -> Pyramid2D:
        ll = x_loc
        details = []
        for _ in range(levels):
            ll, lh, hl, hh = _fwd_level_local(ll, sch, mode, comm)
            details.append((lh, hl, hh))
        return Pyramid2D(ll=ll, details=tuple(reversed(details)))

    loc = _watchdogged(local_fwd, "dwt_fwd_2d_sharded", timeout_s, comm, dev)
    return Pyramid2D(
        ll=_to_global(loc.ll, mesh, axis, comm),
        details=tuple(tuple(_to_global(b, mesh, axis, comm) for b in lvl)
                      for lvl in loc.details),
    )


def dwt_inv_2d_sharded(
    pyr: Pyramid2D,
    mesh,
    mode: str = "paper",
    axis: str = "data",
    scheme="cdf53",
    timeout_s: Optional[float] = None,
    checked=None,
):
    """Inverse of :func:`dwt_fwd_2d_sharded` (same exchange pattern, same
    optional watchdog).  ``pyr``'s bands are row-sharded DTensors (as the
    forward returns them) or full tensors; the result is a row-sharded
    DTensor."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    comm = AxisComm(mesh, axis)
    levels = len(pyr.details)
    h = pyr.ll.shape[-2] * (1 << levels)
    w = pyr.ll.shape[-1]
    for _lh, hl, _hh in pyr.details:
        w = w + hl.shape[-1]
    check_shardable(h, w, comm.size, levels, sch)
    dev = mesh_device(mesh)
    cdt = _compute_dtype(pyr.ll.dtype)

    def local(b) -> Tensor:
        return _local_rows(b, mesh, axis, comm, dev).to(cdt)

    loc = Pyramid2D(ll=local(pyr.ll),
                    details=tuple(tuple(local(b) for b in lvl) for lvl in pyr.details))

    def local_inv() -> Tensor:
        ll = loc.ll
        for lh, hl, hh in loc.details:  # coarsest first
            ll = _inv_level_local(ll, lh, hl, hh, sch, mode, comm)
        return ll

    def run():
        return _to_global(_watchdogged(local_inv, "dwt_inv_2d_sharded", timeout_s, comm, dev),
                          mesh, axis, comm)

    if not _ranges.checked_enabled(checked):
        return run()
    out: list = []

    def run_gathered(_pyr) -> Tensor:  # the certificate reads every row
        out.append(run())
        return out[0].full_tensor()

    _ranges.run_checked_inv(run_gathered, loc, scheme=sch, levels=levels, mode=mode, ndim=2,
                            label="kernels.dwt_inv_2d_sharded")
    return out[0]


# ---------------------------------------------------------------------------
# (5,3) aliases — the seed's public names.
# ---------------------------------------------------------------------------


def dwt53_fwd_2d_sharded(x, mesh, levels: int = 1, mode: str = "paper",
                         axis: str = "data") -> Pyramid2D:
    return dwt_fwd_2d_sharded(x, mesh, levels=levels, mode=mode, axis=axis, scheme="cdf53")


def dwt53_inv_2d_sharded(pyr: Pyramid2D, mesh, mode: str = "paper", axis: str = "data"):
    return dwt_inv_2d_sharded(pyr, mesh, mode=mode, axis=axis, scheme="cdf53")
