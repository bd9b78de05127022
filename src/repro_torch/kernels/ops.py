"""Dtype policy of the port's kernel wrappers.

Port of ``repro.kernels.ops._compute_dtype`` only; the fused 1-D path of
that module is not ported yet (``ROADMAP.md``, Queue 1).
"""
from __future__ import annotations

import torch

_TO_INT32 = (torch.int8, torch.int16, torch.int32, torch.uint8, torch.uint16)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the kernels compute in: int32, for every input dtype the
    oracle accepts (int8 / int16 / uint8 / uint16 promote, int32 passes).

    int64 is rejected, not computed: the reference runs JAX with x64
    disabled, so int64 input reaches its kernels already narrowed to
    int32, while torch would keep it int64 — the two would disagree past
    the int32 range.  The port makes the caller choose the cast
    (``core.lifting.promote_narrow`` applies the same rule)."""
    if dtype in _TO_INT32:
        return torch.int32
    if dtype == torch.int64:
        raise TypeError(
            "integer DWT computes in int32; int64 input is rejected — cast "
            "with .to(torch.int32) first"
        )
    raise TypeError(f"integer DWT requires an int dtype, got {dtype}")
