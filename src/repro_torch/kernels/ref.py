"""The oracle surface for the port's kernels.

As in ``repro.kernels.ref``, the reference IS the band-policy lifting
math of ``core.lifting`` (on torch tensors here), re-exported so tests
import the oracle from one place: the 1-D transforms beside the 2-D
ones.
"""
from repro_torch.core.lifting import (  # noqa: F401
    Bands2D,
    Pyramid2D,
    WaveletPyramid,
    dwt53_fwd,
    dwt53_fwd_1d,
    dwt53_fwd_2d,
    dwt53_fwd_2d_multi,
    dwt53_inv,
    dwt53_inv_1d,
    dwt53_inv_2d,
    dwt53_inv_2d_multi,
    dwt_fwd,
    dwt_fwd_1d,
    dwt_fwd_2d,
    dwt_fwd_2d_multi,
    dwt_inv,
    dwt_inv_1d,
    dwt_inv_2d,
    dwt_inv_2d_multi,
)
