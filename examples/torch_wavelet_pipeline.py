"""The paper's own application on the port: line-based signal compression
(``examples/wavelet_pipeline.py`` on ``repro_torch``).

Encodes a synthetic "sound line" stream (the paper's test: lines of 256
8-bit samples) through the integer DWT -> band packing -> zlib chain and
reports compression ratio and losslessness.

    PYTHONPATH=src python examples/torch_wavelet_pipeline.py [--device cpu]

Runs on the card by default (the transform is the ``lift1d`` kernel);
``--device cpu`` runs its plain PyTorch version.
"""
import argparse
import zlib

import numpy as np
import torch

from repro_torch.core import lifting as L
from repro_torch.kernels import ops


def make_signal(n_lines: int = 64, line: int = 256, seed: int = 7) -> np.ndarray:
    """Smooth band-limited 'audio' lines + noise, 8-bit positive."""
    rng = np.random.default_rng(seed)
    t = np.arange(line)
    lines = []
    for _ in range(n_lines):
        f1, f2 = rng.uniform(0.01, 0.05), rng.uniform(0.05, 0.2)
        sig = 100 * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 6)) \
            + 20 * np.sin(2 * np.pi * f2 * t) + rng.normal(0, 3, line)
        lines.append(np.clip(np.round(sig + 128), 0, 255))
    return np.stack(lines).astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = torch.device(ap.parse_args(argv).device)
    x = torch.from_numpy(make_signal()).to(dev)
    levels = 3

    # forward transform on the kernel path
    pyr = ops.dwt53_fwd(x, levels=levels)

    # entropy-code raw vs band-packed (lossless: keep full precision bands)
    raw_bytes = len(zlib.compress(x.to(torch.int16).cpu().numpy().tobytes(), 6))
    packed = L.pack(pyr).to(torch.int16).cpu().numpy()
    dwt_bytes = len(zlib.compress(packed.tobytes(), 6))
    print(f"lines: {tuple(x.shape)}, levels: {levels}")
    print(f"zlib(raw int16)        : {raw_bytes:8d} bytes")
    print(f"zlib(DWT bands int16)  : {dwt_bytes:8d} bytes "
          f"({raw_bytes / dwt_bytes:.2f}x better)")

    # lossless reconstruction through the kernel path
    x_rec = ops.dwt53_inv(pyr)
    print("lossless reconstruction:", bool(torch.equal(x_rec, x)))

    # band energy profile (why it compresses: energy compaction)
    e_total = float(torch.sum(x.to(torch.float32) ** 2))
    e_approx = float(torch.sum(pyr.approx.to(torch.float32) ** 2))
    print(f"approx band holds {100 * e_approx / e_total:.1f}% of signal energy "
          f"in {pyr.approx.shape[-1]}/{x.shape[-1]} samples")


if __name__ == "__main__":
    main()
