"""Beyond-paper experiment on the port: wavelet band-coded gradient sync.

The counterpart of ``benchmarks/grad_compression.py``, row for row:
(a) the pod-axis byte reduction for a real model's gradient shapes
(reduced granite-3-8b, ``launch.train.init_train_state``), (b) the lossy
channel's distortion and its behaviour under error feedback on white-noise
gradients (8 x 4096, float32), on ``device``: the transforms run the
``lift1d`` kernels on the card, their plain versions on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import compression as C
from repro_torch.launch.train import init_train_state
from repro_torch.train.grad_compress import WaveletSyncConfig, pod_collective_bytes


def _ef_sim(roundtrip, g_true, steps=20):
    """Run the lossy channel with error feedback; return cumulative rel err."""
    err = torch.zeros_like(g_true)
    applied = torch.zeros_like(g_true)
    wanted = torch.zeros_like(g_true)
    for t in range(steps):
        g_t = g_true * (1.0 + 0.05 * t)
        g_hat, err = roundtrip(g_t + err)
        applied = applied + g_hat
        wanted = wanted + g_t
    return float(torch.linalg.norm(applied - wanted) / torch.linalg.norm(wanted))


def run(device: str = "cuda") -> list:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gradsync: device='cuda' but no CUDA card; pass device='cpu'")
    rows = []
    # (a) byte reduction on a real parameter tree (reduced granite-3-8b)
    cfg = reduced(get_config("granite-3-8b"))
    state = init_train_state(cfg, seed=0, device=device)
    for codec, levels in (("bands", 2), ("bands", 3), ("lowband", 2)):
        sc = WaveletSyncConfig(levels=levels, codec=codec)
        raw, comp = pod_collective_bytes(state["params"], sc)
        rows.append((f"gradsync.pod_bytes_ratio.{codec}.L{levels}", round(raw / comp, 3),
                     f"raw {raw} -> {comp} wire bytes per inter-pod sync"))
    # (b) channel distortion + error-feedback behaviour on white-noise grads
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.standard_normal((8, 4096)).astype(np.float32)).to(device)

    def bands_rt(g):
        return C.band_quantized_roundtrip(g, levels=2)

    def low_rt(g):
        return C.lossy_roundtrip(g, levels=2)

    def rel1(rt):
        return float(torch.linalg.norm(rt(g_true)[0] - g_true) / torch.linalg.norm(g_true))

    rows.append(("gradsync.bands.single_step_rel_error", round(rel1(bands_rt), 5),
                 "band-quantized codec (production)"))
    rows.append(("gradsync.bands.ef_cumulative_rel_error", round(_ef_sim(bands_rt, g_true), 5),
                 "EF drains: cumulative << single-step x steps"))
    rows.append(("gradsync.lowband.single_step_rel_error", round(rel1(low_rt), 5),
                 "low-band-only ablation"))
    rows.append(("gradsync.lowband.ef_cumulative_rel_error", round(_ef_sim(low_rt, g_true), 5),
                 "NEGATIVE RESULT kept: fixed dropped subspace => EF cannot drain"))
    return rows
