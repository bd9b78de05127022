"""The 2-D surface of the port's integer lifting DWT.

    from repro_torch import kernels as K
    pyr = K.dwt_fwd_2d_multi(img, levels=5, scheme="cdf53", mode="jpeg2000")
    img2 = K.dwt_inv_2d_multi(pyr, scheme="cdf53", mode="jpeg2000")

A transform runs where its input lives: CUDA tensors through the
hand-written Hopper kernels (``csrc/``), CPU tensors through their plain
PyTorch versions.  Layout, as in ``repro.kernels``: fused2d.py
(whole-image kernels, level dispatch, pyramids), tiled2d.py (halo-tiled
kernels), backend.py (dispatch policy, budgets, tiles, launch counters),
ops.py (dtype policy), ref.py (the torch oracle), _build.py (nvcc build
and ctypes binding of ``csrc/``).
"""
from repro_torch.core.lifting import (  # noqa: F401  structural types + packing
    Bands2D,
    Pyramid2D,
    band_shapes_2d,
    check_levels_2d,
    max_levels_2d,
    pack2d,
    unpack2d,
)
from repro_torch.core.schemes import (  # noqa: F401  the scheme registry
    LiftingScheme,
    LiftStep,
    available_schemes,
    get_scheme,
    register_scheme,
    scheme_from_spec,
)
from repro_torch.kernels.backend import (  # noqa: F401
    launches,
    pick_tile,
    resolve_device,
)
from repro_torch.kernels.fused2d import (  # noqa: F401
    dwt_fwd_2d,
    dwt_fwd_2d_multi,
    dwt_inv_2d,
    dwt_inv_2d_multi,
    plan_2d,
)

__all__ = [
    "Bands2D",
    "Pyramid2D",
    "band_shapes_2d",
    "check_levels_2d",
    "max_levels_2d",
    "pack2d",
    "unpack2d",
    "LiftingScheme",
    "LiftStep",
    "available_schemes",
    "get_scheme",
    "register_scheme",
    "scheme_from_spec",
    "launches",
    "pick_tile",
    "resolve_device",
    "dwt_fwd_2d",
    "dwt_fwd_2d_multi",
    "dwt_inv_2d",
    "dwt_inv_2d_multi",
    "plan_2d",
]
