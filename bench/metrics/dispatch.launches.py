"""Kernel launches a batch, from the port's launch counter
(``repro_torch.kernels.backend.launches``) over the window."""


def read(ctx):
    total = sum(ctx["launches"].values())
    return total / ctx["submitted"] if total and ctx["submitted"] else None
