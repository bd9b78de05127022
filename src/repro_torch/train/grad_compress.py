"""Cross-pod gradient synchronisation through the integer-DWT codec.

Port of ``repro.train.grad_compress``.  The codec (``mode="bands"``, the
production default) ships every wavelet band, integer-quantized: approx
at int16, details at int8 after a per-band arithmetic right shift
(``core/compression.py``).  ``mode="lowband"`` (kept for ablation) ships
only the approximation band.

:func:`pod_sync_tree` averages a tree of pod-local gradients over the
``pod`` axis of a device mesh.  The reference runs it inside
``shard_map`` (``ppermute`` hops, ``pmax`` / ``pmean`` / ``psum``); torch
has no ambient ``shard_map``, so the port takes the mesh explicitly and
every rank calls it in step.  The collectives go through
``repro_torch.collectives.AxisComm``: the ring is n-1 point-to-point
hops of the quantized payload in its own dtype (int16 / int8 on the
wire, accumulated locally in int32), ``pmax`` is ``all_reduce(MAX)`` of
each leaf's scale and band shifts, ``pmean`` ``all_reduce(SUM)`` / n.
The new error feedback ``g32 - own`` is rounded once
(``compression.residual_fused``), as the reference's compiled program
computes it.
Each leaf's transform runs where the leaf lives: the port's kernels on
the card, their plain versions on the CPU.

:func:`pod_collective_bytes` and :func:`pod_encoded_bytes` account the
wire bytes: host math over shapes, and the codec on each leaf's own
device.  :func:`pod_sync_ops` lists every collective the sync issues and
:func:`pod_sync_schedule` prices them, from the leaf shapes alone.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import roofline as RL
from repro_torch import tree as T
from repro_torch.core import compression as C
from repro_torch.core import lifting

PyTree = Any


@dataclass(frozen=True)
class WaveletSyncConfig:
    levels: int = 2
    mode: str = "paper"  # lifting rounding mode
    codec: str = "bands"  # bands | lowband | none
    min_size: int = 4096  # tensors smaller than this sync uncompressed
    n_pods: int = 2  # static ring size
    # lifting scheme from the registry (core/schemes.py): cdf53, haar,
    # 97m, cdf22.  All participants must agree.
    scheme: str = "cdf53"
    # spatial codec: matrix-shaped leaves (both trailing dims
    # transformable) run the multi-level 2-D pyramid instead of the
    # last-axis 1-D transform.  Off by default (wire format changes).
    spatial_2d: bool = False
    # volumetric codec: leaves with three transformable trailing dims run
    # the multi-level 3-D pyramid.  Checked before spatial_2d.
    spatial_3d: bool = False


def init_error_feedback(params: PyTree) -> PyTree:
    """float32 zeros shaped like every leaf, on the leaf's device."""
    return T.map_leaves(
        lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32, device=p.device), params)


def _ring_sum(x: torch.Tensor, comm, n: int) -> torch.Tensor:
    """Sum x across the axis with n-1 ring hops (wire = payload dtype,
    accumulation in int32)."""
    acc = x.to(torch.int32)
    send = x
    for _ in range(n - 1):
        send = comm.shift(send)
        acc = acc + send.to(torch.int32)
    return acc


def _tree_pmax(shifts, comm):
    """Element-wise max across the axis of a tree of 0-dim tensors (one
    all_reduce for the whole tree)."""
    leaves = T.leaves(shifts)
    got = comm.all_reduce(torch.stack([s.reshape(()) for s in leaves]),
                          dist.ReduceOp.MAX, op="pmax")
    return T.unflatten(shifts, list(got.unbind(0)))


def _can_2d(g, levels: int) -> bool:
    """True when a leaf's trailing two axes support a ``levels``-deep 2-D
    pyramid (``lifting.check_levels_2d``, the engine's own rule)."""
    if len(g.shape) < 2:
        return False
    try:
        lifting.check_levels_2d(g.shape[-2], g.shape[-1], levels)
    except ValueError:
        return False
    return True


def _can_nd(g, levels: int, ndim: int = 3) -> bool:
    """True when a leaf's trailing ``ndim`` axes support a ``levels``-deep
    N-D pyramid (``lifting.check_levels_nd``)."""
    if len(g.shape) < ndim:
        return False
    try:
        lifting.check_levels_nd(tuple(g.shape[-ndim:]), levels)
    except ValueError:
        return False
    return True


def _size(p) -> int:
    return math.prod(p.shape)


def leaf_route(p, cfg: WaveletSyncConfig) -> str:
    """Which codec path one leaf takes through the pod sync:
    "raw" | "lowband" | "3d" | "2d" | "1d" — THE routing rule, shared by
    both byte accountings.  ``p`` needs only a ``shape``."""
    if _size(p) < cfg.min_size or cfg.codec == "none":
        return "raw"
    if cfg.codec == "lowband":
        return "lowband"
    if cfg.spatial_3d and _can_nd(p, cfg.levels):
        return "3d"
    if cfg.spatial_2d and _can_2d(p, cfg.levels):
        return "2d"
    return "1d"


def _sync_leaf_2d(g, g32, scale, cfg: WaveletSyncConfig, comm, n_pods: int):
    """Band sync for one matrix-shaped leaf through the 2-D pyramid codec."""
    pyr = C.forward_pyramid_2d(g32, scale, cfg.levels, cfg.mode, scheme=cfg.scheme)
    shifts = _tree_pmax(C.pyramid2d_shifts(pyr), comm)
    ll_q, details_q = C.quantize_pyramid_2d(pyr, shifts)
    sum_ll = _ring_sum(ll_q, comm, n_pods)
    sum_det = tuple(tuple(_ring_sum(b, comm, n_pods) for b in lvl) for lvl in details_q)
    g_sync = C.divide_f32(C.decompress_pyramid_2d(
        sum_ll, sum_det, shifts, scale, cfg.mode, scheme=cfg.scheme), float(n_pods))
    own = C.reconstruct_pyramid_2d(
        ll_q.to(torch.int32), C._as_i32(details_q), shifts, cfg.mode, scheme=cfg.scheme)
    return g_sync.to(g.dtype), C.residual_fused(g32, own, scale)


def _sync_leaf_nd(g, g32, scale, cfg: WaveletSyncConfig, comm, n_pods: int):
    """Band sync for one volume-shaped leaf through the 3-D pyramid codec."""
    pyr = C.forward_pyramid_nd(g32, scale, cfg.levels, cfg.mode, scheme=cfg.scheme, ndim=3)
    shifts = _tree_pmax(C.pyramid_nd_shifts(pyr), comm)
    a_q, details_q = C.quantize_pyramid_nd(pyr, shifts)
    sum_a = _ring_sum(a_q, comm, n_pods)
    sum_det = tuple(tuple(_ring_sum(b, comm, n_pods) for b in lvl) for lvl in details_q)
    g_sync = C.divide_f32(C.decompress_pyramid_nd(
        sum_a, sum_det, shifts, scale, cfg.mode, scheme=cfg.scheme), float(n_pods))
    own = C.reconstruct_pyramid_nd(
        a_q.to(torch.int32), C._as_i32(details_q), shifts, cfg.mode, scheme=cfg.scheme)
    return g_sync.to(g.dtype), C.residual_fused(g32, own, scale)


def _sync_leaf_1d(g, g32, scale, cfg: WaveletSyncConfig, comm, n_pods: int):
    """Band sync for one leaf through the last-axis 1-D codec."""
    pyr = C.forward_bands_nd(g32, scale, cfg.levels, cfg.mode, scheme=cfg.scheme)
    shifts = _tree_pmax(C.pyramid_shifts(pyr), comm)
    approx_q, details_q = C.quantize_pyramid(pyr, shifts)
    sum_a = _ring_sum(approx_q, comm, n_pods)
    sum_d = tuple(_ring_sum(d, comm, n_pods) for d in details_q)
    shape_nd = tuple(g32.shape) if g32.ndim > 0 else (1,)
    g_sync = C.divide_f32(C.decompress_bands_nd(
        sum_a, sum_d, shifts, scale, shape_nd, cfg.mode, scheme=cfg.scheme), float(n_pods))
    own = C.reconstruct_bands_nd(
        approx_q.to(torch.int32), tuple(d.to(torch.int32) for d in details_q), shifts,
        shape_nd, cfg.mode, scheme=cfg.scheme)
    return g_sync.reshape(g.shape).to(g.dtype), C.residual_fused(g32, own.reshape(g.shape),
                                                                 scale)


def _sync_leaf_lowband(g, g32, scale, cfg: WaveletSyncConfig, comm, n_pods: int):
    """The ablation codec: only the approximation band, summed."""
    approx, _details, n = C.forward_bands(g32, scale, cfg.levels, cfg.mode, scheme=cfg.scheme)
    low_sum = comm.all_reduce(approx, op="psum")
    band = C.CompressedBand(low_sum, scale, n, cfg.levels)
    g_sync = C.divide_f32(C.decompress_lowband(band, g.shape, cfg.mode, scheme=cfg.scheme),
                          float(n_pods))
    own = C.reconstruct_lowband(C.CompressedBand(approx, scale, n, cfg.levels), g.shape,
                                cfg.mode, scheme=cfg.scheme)
    return g_sync.to(g.dtype), C.residual_fused(g32, own, scale)


_SYNC = {"lowband": _sync_leaf_lowband, "3d": _sync_leaf_nd, "2d": _sync_leaf_2d,
         "1d": _sync_leaf_1d}


def pod_sync_tree(grads: PyTree, err: PyTree, cfg: WaveletSyncConfig, axis_name: str = "pod",
                  mesh=None) -> Tuple[PyTree, PyTree]:
    """All-reduce pod-local ``grads`` over ``mesh[axis_name]`` through the
    integer-DWT codec.  Every rank of the axis calls it in step with its
    own gradients and error feedback (``err``, float32, shaped like each
    leaf).  Returns ``(synced_grads, new_error_feedback)``."""
    from repro_torch.collectives import AxisComm

    if mesh is None:
        raise ValueError("pod_sync_tree needs the device mesh whose axis it syncs over (mesh=)")
    comm = AxisComm(mesh, axis_name)
    n_pods = cfg.n_pods
    if comm.size != n_pods:
        raise ValueError(f"cfg.n_pods={n_pods} but mesh axis {axis_name!r} has {comm.size} ranks")

    def sync_leaf(g, e):
        route = leaf_route(g, cfg)  # the shared routing rule (below)
        if route == "raw":
            pmean = C.divide_f32(comm.all_reduce(g.to(torch.float32)), float(n_pods))
            return (pmean.to(g.dtype),
                    torch.zeros(tuple(g.shape), dtype=torch.float32, device=g.device))
        g32 = g.to(torch.float32) + e
        # shared quantization scale (the band shifts follow per route)
        scale = comm.all_reduce(C.tensor_scale(g32), dist.ReduceOp.MAX, op="pmax")
        return _SYNC[route](g, g32, scale, cfg, comm, n_pods)

    flat_g = T.leaves(grads)
    flat_e = T.leaves(err)
    if len(flat_e) != len(flat_g):
        raise ValueError(f"err has {len(flat_e)} leaves for {len(flat_g)} gradients")
    out = [sync_leaf(g, e) for g, e in zip(flat_g, flat_e)]
    return T.unflatten(grads, [o[0] for o in out]), T.unflatten(grads, [o[1] for o in out])


def _lowband_bytes(n: int, levels: int) -> int:
    m = 1 << levels
    n_pad = (n + m - 1) // m * m
    return (n_pad >> levels) * 4 + 4


def pod_collective_bytes(params: PyTree, cfg: WaveletSyncConfig) -> Tuple[int, int]:
    """(uncompressed fp32, compressed) wire bytes per inter-pod sync.

    ANALYTIC: the raw fixed-width band payload the ring ships (int16
    approx + int8 details, no entropy coding), a function of the leaf
    shapes alone.  :func:`pod_encoded_bytes` measures coded bytes."""
    raw = 0
    comp = 0
    for p in T.leaves(params):
        n = _size(p)
        raw += n * 4
        route = leaf_route(p, cfg)
        if route == "raw":
            comp += n * 4
        elif route == "lowband":
            comp += _lowband_bytes(n, cfg.levels)
        elif route == "3d":
            comp += n // math.prod(p.shape[-3:]) * C.band_bytes_nd(p.shape[-3:], cfg.levels)
        elif route == "2d":
            comp += n // math.prod(p.shape[-2:]) * C.band_bytes_2d(
                p.shape[-2], p.shape[-1], cfg.levels)
        else:
            comp += C.band_bytes(n, cfg.levels)
    return raw, comp


def _band_payloads(shape, route: str, levels: int) -> List[int]:
    """Bytes of each band the ring ships for one leaf of ``shape`` on a
    banded route (each band also has one shift): approx at int16, details
    at int8, every band carrying the leaf's lead dims (``lifting``'s band
    geometry, the pyramid :func:`pod_sync_tree` transforms)."""
    if route == "1d":
        shape = tuple(shape) or (1,)  # a 0-dim leaf syncs as one sample
        lead = math.prod(shape[:-1])
        a_len, d_lens = lifting.band_sizes(shape[-1], levels)
        return [2 * lead * a_len] + [lead * d for d in d_lens]
    nd = 3 if route == "3d" else 2
    lead = math.prod(shape[:-nd])
    a_shape, det_shapes = (lifting.band_shapes_nd(tuple(shape[-3:]), levels) if nd == 3
                           else lifting.band_shapes_2d(shape[-2], shape[-1], levels))
    bands = [2 * lead * math.prod(a_shape)]
    for lvl in det_shapes:
        bands.extend(lead * math.prod(b) for b in lvl)
    return bands


def pod_sync_ops(params: PyTree, cfg: WaveletSyncConfig,
                 n_pods: Optional[int] = None) -> List[Tuple[str, str, int, int]]:
    """Every collective :func:`pod_sync_tree` issues through ``AxisComm``
    for leaves shaped like ``params``, in order, from the shapes alone
    (no DWT runs): ``(label, collective, payload bytes, group size)``.
    The label is ``AxisComm``'s ``op`` (the ``collectives.wire_bytes``
    counter's): ``all_reduce`` of a raw leaf in float32; ``pmax`` of a
    leaf's scale and of its band shifts; ``ring``, one of the n-1 hops of
    each band (a ``collective-permute``); ``psum`` of the lowband."""
    n = cfg.n_pods if n_pods is None else int(n_pods)
    ops: List[Tuple[str, str, int, int]] = []
    for p in T.leaves(params):
        size = _size(p)
        route = leaf_route(p, cfg)
        if route == "raw":
            ops.append(("all_reduce", "all-reduce", size * 4, n))
            continue
        ops.append(("pmax", "all-reduce", 4, n))  # the shared float32 scale
        if route == "lowband":
            line = max(min(size, C.BLOCK), 1 << cfg.levels)
            a_len, _ = lifting.band_sizes(line, cfg.levels)
            ops.append(("psum", "all-reduce", -(-size // line) * a_len * 4, n))
            continue
        bands = _band_payloads(tuple(p.shape), route, cfg.levels)
        ops.append(("pmax", "all-reduce", 4 * len(bands), n))  # the int32 band shifts
        for b in bands:
            ops.extend([("ring", "collective-permute", b, 2)] * (n - 1))
    return ops


def pod_sync_schedule(params: PyTree, cfg: WaveletSyncConfig, n_pods: Optional[int] = None):
    """The wire of one :func:`pod_sync_tree` over ``n_pods`` pods, priced
    by ``roofline.wire_bytes``, as a ``roofline.CollectiveStats`` keyed by
    the :func:`pod_sync_ops` labels: what one device sends."""
    stats = RL.CollectiveStats()
    for label, op, payload, k in pod_sync_ops(params, cfg, n_pods):
        stats.add(label, RL.wire_bytes(op, payload, payload, k))
    return stats


def pod_encoded_bytes(grads: PyTree, cfg: WaveletSyncConfig) -> Tuple[int, int]:
    """(uncompressed fp32, entropy-coded) wire bytes, MEASURED per leaf.

    Every eligible leaf goes through the real chain on its own device —
    quantize, integer DWT on the route the sync takes (3-D / 2-D /
    last-axis 1-D), Rice container — and the bytes produced are counted.
    Leaves below ``min_size`` (or with the codec off) count at raw fp32;
    the ``lowband`` ablation keeps its analytic estimate."""
    raw = 0
    enc = 0
    for g in T.leaves(grads):
        n = g.numel()
        raw += n * 4
        route = leaf_route(g, cfg)
        if route == "raw":
            enc += n * 4
        elif route == "lowband":
            enc += _lowband_bytes(n, cfg.levels)
        elif route == "3d":
            enc += C.encoded_bytes_nd(g, cfg.levels, cfg.mode, scheme=cfg.scheme)
        elif route == "2d":
            enc += C.encoded_bytes_2d(g, cfg.levels, cfg.mode, scheme=cfg.scheme)
        else:
            # the last-axis pyramid the sync's 1-D route ships (NOT the
            # line-blocked flatten codec's layout)
            enc += C.encoded_bytes_last_axis(g, cfg.levels, cfg.mode, scheme=cfg.scheme)
    return raw, enc
