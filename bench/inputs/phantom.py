"""CT-like signed 12-bit volumes: air (-1024) around an ellipsoidal body
of soft tissue (40) holding five denser or lighter ellipsoids, plus
integer noise in [-noise, noise], clipped to the sample range (as
``chip_smoke.phantom``, made for a whole batch at once on the device)."""
import torch


def make(gen: torch.Generator, count: int, config: dict, device) -> torch.Tensor:
    """``count`` volumes of ``config["shape"]`` from ``gen``, on ``device``."""
    d, h, w = config["shape"]
    lo, hi = -(1 << (config["bits"] - 1)), (1 << (config["bits"] - 1)) - 1
    noise = config["noise"]
    u = torch.rand((count, 5, 7), generator=gen, device=device)
    centre = torch.cat([torch.zeros((count, 1, 3), device=device), -0.4 + 0.8 * u[..., 0:3]], 1)
    radius = torch.cat([torch.tensor([0.95, 0.8, 0.85], device=device).expand(count, 1, 3),
                        0.12 + 0.28 * u[..., 3:6]], 1)
    value = torch.cat([torch.full((count, 1), 40.0, device=device), -600 + 2400 * u[..., 6]], 1)
    axes = [torch.linspace(-1, 1, n, device=device) for n in (d, h, w)]
    z, y, x = axes[0].view(1, d, 1, 1), axes[1].view(1, 1, h, 1), axes[2].view(1, 1, 1, w)
    vol = torch.full((count, d, h, w), -1024.0, device=device)
    for k in range(6):
        c = centre[:, k].view(count, 3, 1, 1, 1)
        r = radius[:, k].view(count, 3, 1, 1, 1)
        inside = (((z - c[:, 0]) / r[:, 0]) ** 2 + ((y - c[:, 1]) / r[:, 1]) ** 2
                  + ((x - c[:, 2]) / r[:, 2]) ** 2) <= 1
        vol = torch.where(inside, value[:, k].view(count, 1, 1, 1), vol)
    vol += torch.randint(-noise, noise + 1, (count, d, h, w), generator=gen, device=device)
    return vol.round_().clamp_(lo, hi).to(torch.int32)
