"""The oracle surface for the port's 2-D kernels.

As in ``repro.kernels.ref``, the reference IS the band-policy lifting
math of ``core.lifting`` (on torch tensors here), re-exported so tests
import the oracle from one place.
"""
from repro_torch.core.lifting import (  # noqa: F401
    Bands2D,
    Pyramid2D,
    dwt_fwd_2d,
    dwt_fwd_2d_multi,
    dwt_inv_2d,
    dwt_inv_2d_multi,
)
