"""Dispatch policy, budgets and launch counters of the port's kernels.

Port of ``repro.kernels.backend`` for the 2-D slice.  The policy is one
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
same figures of an H100 SXM are used, so that :func:`pick_tile` and the
whole-image/tiled choice (``fused2d.plan_2d``) are the same in the CPU
tests as on the card.  None of the TPU's constants (its 16 MB VMEM
default, six resident buffers, the lane-aligned 252 tile) is carried.

``REPRO_DWT_TILE`` ("N" or "TH,TW") keeps its reference meaning: it
forces the tiled engine for every tileable image and sets the tile —
the one test lever that forces multi-tile grids in both packages.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

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


def budgets(device: Optional[torch.device] = None) -> Dict[str, int]:
    """Shared memory per block (opt-in) and per SM, and the SM count, of
    the CUDA ``device``; the H100's figures for the CPU."""
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        per_sm = int(props.shared_memory_per_multiprocessor)
        # older torch builds lack the opt-in figure; CUDA reserves 1 KB of
        # each SM's shared memory per block, which is what it amounts to
        per_block = getattr(props, "shared_memory_per_block_optin", per_sm - 1024)
        return {
            "smem_per_block": int(per_block),
            "smem_per_sm": per_sm,
            "sms": int(props.multi_processor_count),
        }
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
_MAX_TILE = 128
# a tile window takes at most a quarter of the SM's shared memory, so
# four blocks can be resident on one SM
_BLOCKS_PER_SM = 4


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


def pick_tile(
    h: int, w: int, halo: int = 2, device: Optional[torch.device] = None
) -> Tuple[int, int]:
    """(TH, TW) core tile for a tiled level of an (h, w) image.

    The largest power-of-two square tile, up to 128, whose halo'd int32
    window ``(TH + 2*halo) * (TW + 2*halo) * 4`` bytes fits a quarter of
    an SM's shared memory; then never wider than the image (odd dims
    round up to even).  ``REPRO_DWT_TILE`` overrides.
    """
    override = _tile_env_override()
    if override is not None:
        return override
    share = budgets(device)["smem_per_sm"] // _BLOCKS_PER_SM
    t = _MAX_TILE
    while t > _MIN_TILE and (t + 2 * halo) ** 2 * 4 > share:
        t //= 2
    th = min(t, h + (h % 2))
    tw = min(t, w + (w % 2))
    return max(th, _MIN_TILE), max(tw, _MIN_TILE)


# ---------------------------------------------------------------------------
# Launch counters.
# ---------------------------------------------------------------------------


class LaunchCounter:
    """Per-kernel launch counts.  Each kernel wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its
    main path went through the kernels; the plain versions never
    count."""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def bump(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        self.counts.clear()

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)


launches = LaunchCounter()
