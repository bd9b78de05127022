"""Dispatch policy, budgets and launch counters of the port's kernels.

Port of ``repro.kernels.backend``.  The policy is one
rule: a transform runs on the device its input tensor lives on.

  * A CUDA tensor goes to the hand-written kernel (``csrc/``).  If the
    kernel cannot be built or launched, the call raises.
  * A CPU tensor goes to the kernel's plain PyTorch version.

Nothing swaps one for the other.  The reference's ``pallas_guard``
(recompute on XLA after a kernel failure) and its pallas -> interpret
degrade have no counterpart here, and neither has a ``backend=``
argument: the tensor's device is the whole choice.

Budgets come from the card (``torch.cuda.get_device_properties``): the
shared memory one block may opt in to and the SM count.  On the CPU the
same figures of an H100 SXM are used, so that :func:`pick_tile`,
:func:`pick_blocks` and the whole-image/tiled choice
(``fused2d.plan_2d``) are the same in the CPU tests as on the card.  None
of the TPU's constants (its 16 MB VMEM default, six resident buffers,
the lane-aligned 252 tile, the 8 x 256 1-D blocks) is carried.

``REPRO_DWT_TILE`` ("N" or "TH,TW") keeps its reference meaning: it
forces the tiled engine for every tileable image and sets the tile —
the one test lever that forces multi-tile grids in both packages.
``REPRO_DWT_SLAB`` ("TD", even, >= 2) keeps its reference meaning too:
it forces the depth-slab 3-D engine for every volume that can slab and
sets the slab depth.  The TPU's 3-D constants (ten resident buffers,
the default slab of 8) are not carried either.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.obs import NULL, tracer

# H100 SXM figures (NVIDIA data sheet / Hopper tuning guide): 227 KB of
# opt-in shared memory per block, 228 KB per SM, 132 SMs.
H100_SMEM_PER_BLOCK = 232448
H100_SMEM_PER_SM = 233472
H100_SMS = 132


def resolve_device(device) -> torch.device:
    """A ``torch.device`` for an entry point that builds tensors from
    host data.  A CUDA device on a machine without one raises — there
    is no silent CPU path."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` goes to a kernel; False for the plain version.
    Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


_CARD_BUDGETS: Dict[int, Dict[str, int]] = {}


def budgets(device: Optional[torch.device] = None) -> Dict[str, int]:
    """Shared memory per block (opt-in) and per SM, and the SM count, of
    the CUDA ``device`` (read once per card); the H100's figures for the
    CPU."""
    if device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index not in _CARD_BUDGETS:
            props = torch.cuda.get_device_properties(index)
            per_sm = int(props.shared_memory_per_multiprocessor)
            # older torch builds lack the opt-in figure; CUDA reserves 1 KB
            # of each SM's shared memory per block, which is what it
            # amounts to
            per_block = getattr(props, "shared_memory_per_block_optin", per_sm - 1024)
            _CARD_BUDGETS[index] = {
                "smem_per_block": int(per_block),
                "smem_per_sm": per_sm,
                "sms": int(props.multi_processor_count),
            }
        return dict(_CARD_BUDGETS[index])
    return {
        "smem_per_block": H100_SMEM_PER_BLOCK,
        "smem_per_sm": H100_SMEM_PER_SM,
        "sms": H100_SMS,
    }


def whole_budget_elems(device: Optional[torch.device] = None) -> int:
    """Largest per-image sample count the whole-image path takes when the
    image could also be tiled: an image that one block's shared memory
    could hold.  Larger images are tiled — one pass over device memory
    instead of the whole-image kernel's two."""
    return budgets(device)["smem_per_block"] // 4


# ---------------------------------------------------------------------------
# Tile selection for the tiled 2-D engine.
# ---------------------------------------------------------------------------

_TILE_ENV = "REPRO_DWT_TILE"
_MIN_TILE = 4  # tiles are even and >= 4 so every window has a full halo
# the default core tile is 128 columns wide (16 groups of 16-byte band
# stores per row) and as tall as fits, up to 128 rows
_MAX_TILE = 128
# a tile window takes at most a third of the SM's shared memory (less the
# 1 KB the card reserves per block), so three 512-thread blocks are
# resident on one SM, as for the plane pass below
_TILE_BLOCKS_PER_SM = 3
_SMEM_RESERVED_PER_BLOCK = 1024


def tile_forced() -> bool:
    """True when ``REPRO_DWT_TILE`` is set: the tiled engine is forced
    for every tileable image, budget or not."""
    return bool(os.environ.get(_TILE_ENV, "").strip())


def _tile_env_override() -> Optional[Tuple[int, int]]:
    env = os.environ.get(_TILE_ENV, "").strip()
    if not env:
        return None
    parts = [p for p in env.replace("x", ",").split(",") if p]
    try:
        vals = [int(p) for p in parts]
    except ValueError as e:
        raise ValueError(f"{_TILE_ENV}={env!r}: expected 'N' or 'TH,TW' integers") from e
    th, tw = (vals[0], vals[0]) if len(vals) == 1 else (vals[0], vals[1])
    if th < _MIN_TILE or tw < _MIN_TILE or th % 2 or tw % 2:
        raise ValueError(f"{_TILE_ENV}={env!r}: tile dims must be even and >= {_MIN_TILE}")
    return th, tw


def _max_offset(step: int, back: int) -> int:
    """Largest ``(t * step - back) % 4`` over tile columns t: how far a
    window's first entry can sit past the 16-byte aligned column before
    it (``csrc/tiled2d.cu`` max_offset)."""
    return max((t * step - back) % 4 for t in range(4))


def tile_window_bytes(th: int, tw: int, margin: int) -> int:
    """Shared memory of one block of the tiled forward or inverse level
    (the larger) for ``(th, tw)`` core tiles and lifting margin
    ``margin`` (halo ``2 * margin``), as ``csrc/tiled2d.cu`` allocates it:
    ``th + 4*margin`` window rows, each padded to whole 16-byte groups
    from an aligned column (forward: groups of 4 samples; inverse: two
    planar halves, the even- and odd-column bands' entries, each in
    groups of 4)."""
    width = tw + 4 * margin
    fwd = _cdiv(_max_offset(tw, 2 * margin) + width, 4) * 4
    inv = _cdiv(2 * _max_offset(tw // 2, margin) + width, 8) * 8
    return (th + 4 * margin) * max(fwd, inv) * 4


def pick_tile(
    h: int, w: int, halo: int = 2, device: Optional[torch.device] = None
) -> Tuple[int, int]:
    """(TH, TW) core tile for a tiled level of an (h, w) image.

    TW = 128 and the largest even TH up to 128 whose forward and inverse
    windows (:func:`tile_window_bytes`, margin ``halo // 2``) fit a third
    of an SM's shared memory: (128, 128) for cdf53 and haar, (124, 128)
    for 97m, whose inverse window at 128 rows would take 78,336 bytes.
    Then never wider than the image (odd dims round up to even).
    ``REPRO_DWT_TILE`` overrides, taken as given.
    """
    override = _tile_env_override()
    if override is not None:
        return override
    b = budgets(device)
    share = min(b["smem_per_sm"] // _TILE_BLOCKS_PER_SM - _SMEM_RESERVED_PER_BLOCK,
                b["smem_per_block"])
    th, tw = _MAX_TILE, _MAX_TILE
    while th > _MIN_TILE and tile_window_bytes(th, tw, halo // 2) > share:
        th -= 2
    th = min(th, h + (h % 2))
    tw = min(tw, w + (w % 2))
    return max(th, _MIN_TILE), max(tw, _MIN_TILE)


# ---------------------------------------------------------------------------
# Row-pass geometry (csrc/whole2d.cu: the 2-D whole-image kernels and the
# 1-D fallback).
# ---------------------------------------------------------------------------

_ROW_BLOCK_ELEMS = 4096  # a row-pass block stages about 16 KB of whole rows


def row_geometry(rows: int, w: int, device: Optional[torch.device] = None) -> Dict[str, int]:
    """Launch geometry of the row pass over ``rows`` lines of ``w``
    samples: ``rb`` lines per block (about 16 KB of them), or one line per
    block staged in a global scratch buffer of ``scratch`` int32 entries
    when a line is too long for shared memory (``row_global``)."""
    row_global = int(w * 4 > budgets(device)["smem_per_block"])
    rb = 1 if row_global else max(1, min(rows, _ROW_BLOCK_ELEMS // w))
    return {"rb": rb, "row_global": row_global, "scratch": rows * w if row_global else 0}


STRIP = 32  # columns per block of a column or slab pass: one warp's worth


def strip_width(n: int, device: Optional[torch.device] = None) -> int:
    """Columns per block of a pass that stages ``n`` samples of each
    column in shared memory (csrc/passes.cuh): 32, halved until the strip
    fits one block's shared memory; 0 when even one column does not (the
    pass then stages its lines in a global scratch buffer)."""
    limit = budgets(device)["smem_per_block"]
    cw = STRIP
    while cw > 1 and n * cw * 4 > limit:
        cw //= 2
    return 0 if n * cw * 4 > limit else cw


# ---------------------------------------------------------------------------
# Plane-pass geometry of the depth-slab 3-D level (csrc/slab3d.cu).
# ---------------------------------------------------------------------------

# a plane-pass window takes at most a third of the SM's shared memory
# (less the 1 KB the card reserves per block), so three 512-thread blocks
# are resident: one block's loads overlap another's lifting (measured on
# the H100: 10-15% faster than two blocks of taller strips, PERF.md)
_PLANE_BLOCKS_PER_SM = 3
_PLANE_MIN_ROWS = 8  # fewer core rows than this re-read too much halo


def plane_rows(h: int, w: int, margin: int, windows: bool,
               device: Optional[torch.device] = None) -> int:
    """Core rows R of one block of the fused plane pass of a depth-slab
    level over (h, w) slices, for a scheme with lifting margin ``margin``
    (forward: ``fwd_margin``; inverse: ``inv_margin``) that windows along
    h (``windows``: ``scheme.can_window(h)``).

    The largest even R whose window of ``R + 4*margin`` whole int32 rows
    fits a third of an SM's shared memory, never more than h (odd rounds
    up).
    0 when the plane pass does not apply: the scheme cannot window h, or
    fewer than 8 rows (or h, when that is smaller) fit.  The level then
    runs the row pass along W and the column pass along H instead.
    """
    if not windows:
        return 0
    b = budgets(device)
    share = min(b["smem_per_sm"] // _PLANE_BLOCKS_PER_SM - _SMEM_RESERVED_PER_BLOCK,
                b["smem_per_block"])
    r = share // (4 * w) - 4 * margin
    r -= r % 2
    full = h + h % 2
    return min(r, full) if r >= min(_PLANE_MIN_ROWS, full) else 0


SLAB_STRIP = 128  # widest depth-pass strip: 32 lanes of 16-byte copies


def slab_strip(depth: int, device: Optional[torch.device] = None) -> int:
    """Columns per block of the depth pass whose windows are ``depth``
    samples deep: 128, halved (down to 32) until the window fits a
    quarter of an SM's shared memory, then until it fits one block's; 0
    when even one column does not fit."""
    b = budgets(device)
    cw = SLAB_STRIP
    while cw > STRIP and depth * cw * 4 > b["smem_per_sm"] // _SLAB_BLOCKS_PER_SM:
        cw //= 2
    while cw > 1 and depth * cw * 4 > b["smem_per_block"]:
        cw //= 2
    return 0 if depth * cw * 4 > b["smem_per_block"] else cw


def col_scratch(nb: int, n: int, widths, cw: int) -> int:
    """Global scratch entries of a column pass over ``nb`` batches of
    planes ``widths`` columns wide that stages its lines in device memory
    (``cw == 0``): one n x 32 strip per block; 0 otherwise."""
    if cw:
        return 0
    return nb * sum(_cdiv(wp, STRIP) for wp in widths) * n * STRIP


# ---------------------------------------------------------------------------
# Blocks of one windowed 1-D level at forced blocks (dwt53.lift_fwd_windows).
# ---------------------------------------------------------------------------

_MAX_BLOCK_PAIRS = 1024  # a tile of 2048 samples: the halo re-read is < 1%
# a block's windows take at most an eighth of the SM's shared memory
_LINE_BLOCKS_PER_SM = 8
_MIN_GRID_PER_SM = 4  # fewer rows per block until the grid has this many blocks per SM


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def pick_blocks(
    rows: int, pairs: int, halo: int, device: Optional[torch.device] = None
) -> Tuple[int, int]:
    """(block_rows, block_pairs) for one windowed 1-D level over ``rows``
    lines of ``pairs`` core pairs through the single-level wrappers
    (``dwt53.lift_fwd_windows`` / ``lift_inv_windows``, a run of one level
    at tiles of ``2 * block_pairs`` samples), with ``halo`` extension
    samples per side of each window (``2 * margin``).  The pyramids'
    runs pick their own tiles (:func:`run_tile`).

    ``block_pairs`` is the largest power of two up to 1024 whose one
    int32 window ``(2 * block_pairs + 2 * halo) * 4`` bytes fits an eighth
    of an SM's shared memory, never more than ``pairs``.  ``block_rows``
    stacks as many windows as that share holds, never more than ``rows``
    nor the run kernel's 4 rows a block, and fewer where the grid would
    otherwise have under four blocks per SM.  Derived from
    :func:`budgets`, not from the TPU's 8 x 256 blocks.
    """
    b = budgets(device)
    share = b["smem_per_sm"] // _LINE_BLOCKS_PER_SM
    bp = _MAX_BLOCK_PAIRS
    while bp > 1 and (2 * bp + 2 * halo) * 4 > share:
        bp //= 2
    bp = max(1, min(bp, pairs))
    rb = max(1, min(rows, _RUN_MAX_ROWS, share // ((2 * bp + 2 * halo) * 4)))
    grid_rows = rows * _cdiv(pairs, bp) // (_MIN_GRID_PER_SM * b["sms"])
    return max(1, min(rb, grid_rows)), bp


# ---------------------------------------------------------------------------
# Tile geometry of a run of windowed 1-D levels (csrc/lift1d.cu).
# ---------------------------------------------------------------------------

# a tile owns at most 4096 level-0 samples: the overlap re-read is 1.5%
# for cdf53 over 4 levels (2 x 30 samples), 2.9% for 97m
_RUN_MAX_TILE = 4096
# a block's rows take at most a quarter of the SM's shared memory: four
# or more persistent 128-thread blocks an SM, each with the next tile's
# loads in flight while it lifts the current one (128 threads to a 4096-
# sample tile: the fastest of 64-256 threads by 1024-4096 samples on the
# H100, tools/lift1d_anatomy.py's sweep)
_RUN_BLOCKS_PER_SM = 4
_RUN_MAX_ROWS = 4  # rows a block: each row keeps 32 lanes or more


def run_exts(levels: int, fwd_margin: int, inv_margin: int) -> Tuple[List[int], List[int]]:
    """Each level's window reach past a tile's core in a run of ``levels``
    levels: forward ``E_k = 2 * fwd_margin * (2^(levels-k) - 1)`` samples,
    inverse ``P_0 = inv_margin``, ``P_k = ceil(P_{k-1} / 2) + inv_margin``
    pairs (``csrc/lift1d.cu`` plan)."""
    fwd = [2 * fwd_margin * ((1 << (levels - k)) - 1) for k in range(levels)]
    inv = [inv_margin]
    for _ in range(levels - 1):
        inv.append((inv[-1] + 1) // 2 + inv_margin)
    return fwd, inv


def run_row_bytes(tile: int, levels: int, fwd_margin: int, inv_margin: int) -> int:
    """Shared memory one row of a run's block takes, the larger of the two
    directions, as ``csrc/lift1d.cu`` (plan) lays it out, every window an
    even and an odd plane of whole 16-byte groups: forward, two load
    buffers of the level-0 window and one of the level-1 window; inverse,
    two load regions (every level's d plane and the coarsest s plane) and
    the level-0 and level-1 s planes."""
    fwd, inv = run_exts(levels, fwd_margin, inv_margin)
    r4 = lambda v: _cdiv(v, 4) * 4  # noqa: E731
    second = levels > 1
    f = 4 * r4(tile // 2 + fwd[0]) + (2 * r4(tile // 4 + fwd[1]) if second else 0)
    region = sum(r4((tile >> k) // 2 + 2 * inv[k]) for k in range(levels))
    region += r4((tile >> (levels - 1)) // 2 + 2 * inv[-1])
    i = 2 * region + r4(tile // 2 + 2 * inv[0]) + (r4(tile // 4 + 2 * inv[1]) if second else 0)
    return 4 * max(f, i)


def run_tile(
    rows: int, n: int, levels: int, fwd_margin: int, inv_margin: int,
    device: Optional[torch.device] = None,
) -> Optional[Tuple[int, int]]:
    """(tile, block_rows) of one launch of ``levels`` windowed levels over
    ``rows`` lines of ``n`` samples, or None where no tile takes them.

    The tile is the largest multiple of 2^levels up to 4096 level-0
    samples, never longer than the line rounds up to, whose row
    (:func:`run_row_bytes`) fits a quarter of an SM's shared memory;
    then the shortest multiple of 2^levels that cuts the line into as many
    tiles, so the last tile is not a sliver.  A
    run of two or more levels also needs the tile to be at least twice
    its forward reach E_0 (the re-read at most the core); else None, and the
    caller shortens the run.  ``block_rows`` stacks up to 4 rows (a power
    of two) while they fit that share and the grid keeps four blocks an
    SM.  Derived from :func:`budgets`.
    """
    b = budgets(device)
    share = min(b["smem_per_sm"] // _RUN_BLOCKS_PER_SM - _SMEM_RESERVED_PER_BLOCK,
                b["smem_per_block"])
    unit = 1 << levels
    tile = max(unit, min(_RUN_MAX_TILE // unit * unit, _cdiv(n, unit) * unit))
    while tile > unit and run_row_bytes(tile, levels, fwd_margin, inv_margin) > share:
        tile -= unit
    tiles = _cdiv(n, tile)
    tile = _cdiv(_cdiv(n, tiles), unit) * unit  # the same tiles, as even as they come
    row = run_row_bytes(tile, levels, fwd_margin, inv_margin)
    if levels > 1 and (row > share or 4 * fwd_margin * ((1 << levels) - 1) > tile):
        return None
    rb = 1
    while (2 * rb <= min(rows, _RUN_MAX_ROWS) and 2 * rb * row <= share
           and _cdiv(rows, 2 * rb) * tiles >= _MIN_GRID_PER_SM * b["sms"]):
        rb *= 2
    return tile, rb


# ---------------------------------------------------------------------------
# 3-D budgets: the whole-volume kernel and the depth-slab engine
# (csrc/whole3d.cu, csrc/slab3d.cu).
# ---------------------------------------------------------------------------

_SLAB_ENV = "REPRO_DWT_SLAB"
_MIN_SLAB = 2  # slabs are even and >= 2 so every window has a full halo
# a depth window takes at most a quarter of the SM's shared memory, so
# four blocks can be resident on one SM
_SLAB_BLOCKS_PER_SM = 4


def whole3d_budget_elems(device: Optional[torch.device] = None) -> int:
    """Largest per-volume sample count the whole-volume kernel runs in one
    block (all three axes in shared memory: one read, eight band writes);
    larger volumes slab where they can, and otherwise run the
    whole-volume kernel's three passes through device memory."""
    return budgets(device)["smem_per_block"] // 4


def slab_forced() -> bool:
    """True when ``REPRO_DWT_SLAB`` is set: the depth-slab engine is
    forced for every volume that can slab, budget or not."""
    return bool(os.environ.get(_SLAB_ENV, "").strip())


def _slab_env_override() -> Optional[int]:
    env = os.environ.get(_SLAB_ENV, "").strip()
    if not env:
        return None
    try:
        td = int(env)
    except ValueError as e:
        raise ValueError(f"{_SLAB_ENV}={env!r}: expected an integer") from e
    if td < _MIN_SLAB or td % 2:
        raise ValueError(f"{_SLAB_ENV}={env!r}: slab depth must be even and >= {_MIN_SLAB}")
    return td


def pick_slab(d: int, h: int, w: int, halo: int = 2, device: Optional[torch.device] = None) -> int:
    """Core slab depth TD of a depth-slab level of a (d, h, w) volume.

    The largest even TD >= 2 whose int32 depth window ``(TD + 2*halo)``
    deep and one strip of ``min(32, h*w)`` plane columns wide fits a
    quarter of an SM's shared memory; then never deeper than the volume
    (odd depth rounds up to even).  ``REPRO_DWT_SLAB`` overrides.
    """
    override = _slab_env_override()
    if override is not None:
        return override
    share = budgets(device)["smem_per_sm"] // _SLAB_BLOCKS_PER_SM
    td = share // (4 * min(STRIP, h * w)) - 2 * halo
    td = min(td - td % 2, d + d % 2)
    return max(td, _MIN_SLAB)


# ---------------------------------------------------------------------------
# Launch counters.
# ---------------------------------------------------------------------------


class LaunchCounter:
    """Per-kernel launch counts.  Each kernel wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its
    main path went through the kernels; the plain versions never
    count.  Names: ``whole2d_fwd`` / ``whole2d_inv``, ``tiled2d_fwd`` /
    ``tiled2d_inv``, ``lift1d_fwd`` / ``lift1d_inv``, ``rows1d_fwd`` /
    ``rows1d_inv`` (the 1-D row-pass fallback), ``whole3d_fwd`` /
    ``whole3d_inv``, ``slab3d_fwd`` / ``slab3d_inv``, ``rice_encode`` /
    ``rice_decode``, ``filterbank53_float``."""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def bump(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        self.counts.clear()

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)


launches = LaunchCounter()


# ---------------------------------------------------------------------------
# The public transforms' span.  Kernels-layer spans record only inside
# ``obs.tracing("kernels")``: each site reads ``obs._state.kernels`` and
# enters ``obs.NULL`` when it is off.
# ---------------------------------------------------------------------------

_calls = threading.local()  # ``open``: this thread is inside a public call's span


class _OutermostCall:
    """A ``kernels.call`` span that marks its thread as inside it."""

    __slots__ = ("_span",)

    def __init__(self, span):
        self._span = span

    def __enter__(self) -> None:
        _calls.open = True
        self._span.__enter__()

    def __exit__(self, *exc) -> bool:
        self._span.__exit__(*exc)
        _calls.open = False
        return False


def call_span(direction: str, ndim: int, levels: int, lead: Sequence[int]):
    """The ``kernels.call`` span of a public multi-level transform over a
    batch whose leading dims are ``lead``; ``NULL`` inside another public
    call's span (the checked mode's certification and the N-D API's 2-D
    route call the public transforms again), so that only the outermost
    call records."""
    if getattr(_calls, "open", False):
        return NULL
    return _OutermostCall(tracer.record("kernels.call", "kernels", direction=direction,
                                        ndim=ndim, levels=levels, batch=math.prod(lead)))
