"""The float (5,3) filter bank: the CUDA kernel and its plain version.

The paper's Table 3 compares its integer lifting modules with a standard
float filter bank.  The reference's baseline is
``repro.core.lifting.filterbank53_fwd_float``, a jnp function that XLA
fuses into one kernel when jitted; it is not a Pallas kernel.  On the
card, :func:`filterbank53_fwd_float` runs it as one launch of
``csrc/filterbank.cu``, so the comparison is one launch against one
launch; a CPU tensor runs the plain version
(``core.lifting.filterbank53_fwd_float``, the reference transcribed, about
20 kernels on the card).  The two are bit-equal: the kernel rounds each
product and sum once, in the plain version's order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import lifting as L
from repro_torch.kernels import _build
from repro_torch.kernels import backend as _backend

Tensor = torch.Tensor


def filterbank53_fwd_float_cuda(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch ``csrc/filterbank.cu`` on a (rows, n) int32 CUDA batch ->
    float32 ``s`` (rows, ceil(n/2)) and ``d`` (rows, n/2)."""
    dev = _build.check_tensors("filterbank53_float", [x])
    if x.dim() != 2 or x.shape[1] < 3:
        raise ValueError(f"need a (rows, n >= 3) batch, got {tuple(x.shape)}")
    rows, n = x.shape
    s = torch.empty((rows, n - n // 2), dtype=torch.float32, device=x.device)
    d = torch.empty((rows, n // 2), dtype=torch.float32, device=x.device)
    _build.launch("filterbank", "repro_filterbank53_fwd_float", dev, (x, s, d), (rows, n))
    _backend.launches.bump("filterbank53_float")
    return s, d


def filterbank53_fwd_float(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Direct-form float (5,3) analysis of the last axis: ``(s, d)`` in
    float32, ``s`` of ceil(n/2) entries and ``d`` of n/2 (n >= 3).

    Takes int32, and int8 / int16 / uint8 / uint16 promoted to it
    (``core.lifting.promote_narrow``).  A CUDA tensor runs the kernel, a
    CPU tensor the plain version; a failed build or launch raises."""
    x = L.promote_narrow(x)
    n = x.shape[-1]
    if n < 3:
        raise ValueError(f"the float filterbank needs at least 3 samples, got {n}")
    if not _backend.on_cuda(x):
        return L.filterbank53_fwd_float(x)
    lead = x.shape[:-1]
    s, d = filterbank53_fwd_float_cuda(x.reshape(-1, n).contiguous())
    return s.reshape(*lead, -1), d.reshape(*lead, -1)
