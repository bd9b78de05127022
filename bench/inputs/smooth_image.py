"""Smooth 8-bit greyscale images: three low-frequency sinusoids a
picture, quantised, plus +-2 noise, DC-shifted to -128..127 and held as
int32 (as ``chip_smoke.smooth_image``, made in torch on the device)."""
import math

import torch


def make(gen: torch.Generator, count: int, config: dict, device) -> torch.Tensor:
    """``count`` images of ``config["shape"]`` from ``gen``, on ``device``."""
    h, w = config["shape"]
    lo, hi = -(1 << (config["bits"] - 1)), (1 << (config["bits"] - 1)) - 1
    p = torch.rand((count, 3, 3), generator=gen, device=device)
    fy, fx, ph = 0.5 + 2.5 * p[..., 0], 0.5 + 2.5 * p[..., 1], 2 * math.pi * p[..., 2]
    yy = (torch.arange(h, device=device, dtype=torch.float32) / h).view(1, h, 1)
    xx = (torch.arange(w, device=device, dtype=torch.float32) / w).view(1, 1, w)
    img = torch.zeros((count, h, w), device=device)
    for k in range(3):
        img += torch.sin(2 * math.pi * (fy[:, k, None, None] * yy + fx[:, k, None, None] * xx)
                         + ph[:, k, None, None])
    img = torch.round(img * 40)
    img += torch.randint(-2, 3, (count, h, w), generator=gen, device=device)
    return img.clamp_(lo, hi).to(torch.int32)
