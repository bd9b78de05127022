"""The port's integer lifting DWT: the 1-D, 2-D and N-D (3-D volume) surfaces.

    from repro_torch import kernels as K
    pyr = K.dwt_fwd(x, levels=3, scheme="97m")
    x2 = K.dwt_inv(pyr, scheme="97m")
    pyr2 = K.dwt_fwd_2d_multi(img, levels=5, scheme="cdf53", mode="jpeg2000")
    p3d = K.dwt_fwd_nd(vol, levels=4, ndim=3)  # (..., D, H, W) volumes

A transform runs where its input lives: CUDA tensors through the
hand-written Hopper kernels (``csrc/``), CPU tensors through their plain
PyTorch versions.  Every transform takes ``checked=`` (or
``REPRO_DWT_CHECKED``; ``core/ranges.py``).  Layout, as in
``repro.kernels``: ops.py (1-D level dispatch, pyramids, dtype policy),
dwt53.py (windowed 1-D kernels and the row-pass fallback), fused2d.py
(whole-image kernels, 2-D level dispatch, pyramids), tiled2d.py
(halo-tiled kernels), fused3d.py (the N-D API, whole-volume and
depth-slab 3-D kernels, 3-D level dispatch), filterbank.py (the float
(5,3) filter bank of the paper's Table 3, one launch), backend.py
(dispatch policy, budgets, blocks, tiles, launch counters), ref.py (the
torch oracle), _build.py (nvcc build and ctypes binding of ``csrc/``).
"""
from repro_torch.core.lifting import (  # noqa: F401  structural types + packing
    Bands2D,
    Pyramid2D,
    PyramidND,
    WaveletPyramid,
    band_shapes_2d,
    band_shapes_nd,
    band_sizes,
    check_levels_2d,
    check_levels_nd,
    max_levels,
    max_levels_2d,
    max_levels_nd,
    pack,
    pack2d,
    pack_nd,
    unpack,
    unpack2d,
    unpack_nd,
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
    pick_slab,
    pick_tile,
    resolve_device,
)
from repro_torch.kernels.fused2d import (  # noqa: F401
    dwt53_fwd_2d,
    dwt53_fwd_2d_multi,
    dwt53_inv_2d,
    dwt53_inv_2d_multi,
    dwt_fwd_2d,
    dwt_fwd_2d_multi,
    dwt_inv_2d,
    dwt_inv_2d_multi,
    plan_2d,
)
from repro_torch.kernels.filterbank import filterbank53_fwd_float  # noqa: F401
from repro_torch.kernels.fused3d import (  # noqa: F401
    dwt_fwd_nd,
    dwt_inv_nd,
    plan_3d,
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
from repro_torch.kernels.sharded import (  # noqa: F401
    dwt53_fwd_2d_sharded,
    dwt53_inv_2d_sharded,
    dwt_fwd_2d_sharded,
    dwt_inv_2d_sharded,
)

__all__ = [
    "Bands2D",
    "Pyramid2D",
    "PyramidND",
    "WaveletPyramid",
    "band_shapes_2d",
    "band_shapes_nd",
    "band_sizes",
    "check_levels_2d",
    "check_levels_nd",
    "max_levels",
    "max_levels_2d",
    "max_levels_nd",
    "pack",
    "pack2d",
    "pack_nd",
    "unpack",
    "unpack2d",
    "unpack_nd",
    "LiftingScheme",
    "LiftStep",
    "available_schemes",
    "get_scheme",
    "register_scheme",
    "scheme_from_spec",
    "launches",
    "pick_blocks",
    "pick_slab",
    "pick_tile",
    "resolve_device",
    "dwt_fwd_2d",
    "dwt_fwd_2d_multi",
    "dwt_inv_2d",
    "dwt_inv_2d_multi",
    "plan_2d",
    "dwt_fwd_nd",
    "dwt_inv_nd",
    "plan_3d",
    "filterbank53_fwd_float",
    "dwt53_fwd",
    "dwt53_fwd_1d",
    "dwt53_inv",
    "dwt53_inv_1d",
    "dwt53_fwd_2d",
    "dwt53_fwd_2d_multi",
    "dwt53_inv_2d",
    "dwt53_inv_2d_multi",
    "dwt_fwd",
    "dwt_fwd_1d",
    "dwt_inv",
    "dwt_inv_1d",
    "plan_1d",
    "dwt53_fwd_2d_sharded",
    "dwt53_inv_2d_sharded",
    "dwt_fwd_2d_sharded",
    "dwt_inv_2d_sharded",
]
