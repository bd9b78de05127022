"""Paper Fig. 5 on the port: a 64-sample signal (normal distribution,
integer positive), forward -> backward integer DWT is exactly lossless.

The counterpart of ``benchmarks/fig5_lossless.py``: the same six rows,
name for name, plus ``fig5.lossless_kernel_multilevel``.  The oracle and
PE-model rows run on the host; the kernel rows run on ``device``: on the
card the ``lift1d`` CUDA kernel (one level; 4 levels: one ``lift1d`` run
of the levels of 8 pairs or more, then the row pass at the 4-pair
level), on the CPU their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.core import lifting as L
from repro_torch.core.pe import AnalysisModule, ReconstructionModule


def make_fig5_signal(seed: int = 2010) -> np.ndarray:
    """64 samples, normal distribution, positive integers, 8-bit range."""
    rng = np.random.default_rng(seed)
    sig = rng.normal(loc=128.0, scale=40.0, size=64)
    return np.clip(np.round(sig), 0, 255).astype(np.int32)


def run(device: str = "cuda") -> list:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fig5: device='cuda' but no CUDA card; pass device='cpu'")
    x_np = make_fig5_signal()
    x = torch.from_numpy(x_np[None])

    s, d = L.dwt53_fwd_1d(x)
    exact_ref = bool((L.dwt53_inv_1d(s, d) == x).all())

    am = AnalysisModule()
    s_pe, d_pe = am.process(x_np)
    rm = ReconstructionModule()
    exact_pe = rm.process(s_pe, d_pe) == [int(v) for v in x_np]

    xk = x.to(device)
    sk, dk = K.dwt53_fwd_1d(xk)
    exact_kernel = bool((K.dwt53_inv_1d(sk, dk) == xk).all())
    exact_kernel_ml = bool((K.dwt53_inv(K.dwt53_fwd(xk, levels=4)) == xk).all())

    # multi-level (the paper's "several level" future-work case, also exact)
    pyr = L.dwt53_fwd(x, levels=4)
    exact_ml = bool((L.dwt53_inv(pyr) == x).all())

    max_err = int((L.dwt53_inv_1d(s, d) - x).abs().max())
    energy = (d * d).sum().to(torch.float32) / (x * x).sum().to(torch.float32)
    on = "lift1d CUDA kernel on the card, its plain version on the CPU"
    return [
        ("fig5.lossless_reference", int(exact_ref), "1 = bit exact"),
        ("fig5.lossless_pe_model", int(exact_pe), "1 = bit exact"),
        ("fig5.lossless_pallas_kernel", int(exact_kernel), f"1 = bit exact; {on} ({device})"),
        ("fig5.lossless_multilevel", int(exact_ml), "4 levels"),
        ("fig5.lossless_kernel_multilevel", int(exact_kernel_ml),
         f"1 = bit exact; 4 levels through kernels.dwt_fwd / dwt_inv: a lift1d run of 3 "
         f"levels, then the row pass at the 4-pair level on the card ({device})"),
        ("fig5.max_abs_error", max_err, "paper Fig.5 shows zero error"),
        ("fig5.detail_energy_fraction", round(float(energy), 4),
         "energy compaction into approx band"),
    ]
