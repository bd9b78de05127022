"""The port's integer lifting DWT: the 1-D library surface and the 2-D one.

    from repro_torch import kernels as K
    pyr = K.dwt_fwd(x, levels=3, scheme="97m")
    x2 = K.dwt_inv(pyr, scheme="97m")
    pyr2 = K.dwt_fwd_2d_multi(img, levels=5, scheme="cdf53", mode="jpeg2000")

A transform runs where its input lives: CUDA tensors through the
hand-written Hopper kernels (``csrc/``), CPU tensors through their plain
PyTorch versions.  Every transform takes ``checked=`` (or
``REPRO_DWT_CHECKED``; ``core/ranges.py``).  Layout, as in
``repro.kernels``: ops.py (1-D level dispatch, pyramids, dtype policy),
dwt53.py (windowed 1-D kernels and the row-pass fallback), fused2d.py
(whole-image kernels, 2-D level dispatch, pyramids), tiled2d.py
(halo-tiled kernels), backend.py (dispatch policy, budgets, blocks,
tiles, launch counters), ref.py (the torch oracle), _build.py (nvcc
build and ctypes binding of ``csrc/``).
"""
from repro_torch.core.lifting import (  # noqa: F401  structural types + packing
    Bands2D,
    Pyramid2D,
    WaveletPyramid,
    band_shapes_2d,
    band_sizes,
    check_levels_2d,
    max_levels,
    max_levels_2d,
    pack,
    pack2d,
    unpack,
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
    pick_blocks,
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
from repro_torch.kernels.ops import (  # noqa: F401
    dwt53_fwd,
    dwt53_fwd_1d,
    dwt53_inv,
    dwt53_inv_1d,
    dwt_fwd,
    dwt_fwd_1d,
    dwt_inv,
    dwt_inv_1d,
    plan_1d,
)

__all__ = [
    "Bands2D",
    "Pyramid2D",
    "WaveletPyramid",
    "band_shapes_2d",
    "band_sizes",
    "check_levels_2d",
    "max_levels",
    "max_levels_2d",
    "pack",
    "pack2d",
    "unpack",
    "unpack2d",
    "LiftingScheme",
    "LiftStep",
    "available_schemes",
    "get_scheme",
    "register_scheme",
    "scheme_from_spec",
    "launches",
    "pick_blocks",
    "pick_tile",
    "resolve_device",
    "dwt_fwd_2d",
    "dwt_fwd_2d_multi",
    "dwt_inv_2d",
    "dwt_inv_2d_multi",
    "plan_2d",
    "dwt53_fwd",
    "dwt53_fwd_1d",
    "dwt53_inv",
    "dwt53_inv_1d",
    "dwt_fwd",
    "dwt_fwd_1d",
    "dwt_inv",
    "dwt_inv_1d",
    "plan_1d",
]
