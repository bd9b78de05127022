"""Cross-pod gradient sync through the integer-DWT codec: the configuration,
the routing rule and the byte accounting.

Port of the accounting half of ``repro.train.grad_compress``.  The codec
(``mode="bands"``, the production default) ships every wavelet band,
integer-quantized: approx at int16, details at int8 after a per-band
arithmetic right shift (``core/compression.py``).  ``mode="lowband"``
(kept for ablation) ships only the approximation band.

Not ported yet: ``pod_sync_tree`` and its ring exchange.  The reference
runs them inside ``shard_map`` over the ``pod`` mesh axis (``ppermute``
hops with int32 accumulation, ``pmax`` of the scales and shifts); the
port gets them with the sharded transform and ``torch.distributed``
collectives (ROADMAP.md Queue 1 item 8).  What is here is host math over
shapes and, for :func:`pod_encoded_bytes`, the codec on each leaf's own
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

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
