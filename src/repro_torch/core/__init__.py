"""Core: the paper's integer lifting-scheme DWT, its range model and its
hardware model.

Re-exports what ``repro.core`` re-exports, on torch tensors, the float
filter-bank baseline ``filterbank53_fwd_float`` (the plain version of
``kernels.filterbank53_fwd_float``) among them.  The processing-element
model (``core.pe``) and the op counter (``core.opcount``) are modules of
their own, as in the reference.
"""
from repro_torch.core.lifting import (  # noqa: F401
    Bands2D,
    LiftingScheme,
    LiftStep,
    WaveletPyramid,
    available_schemes,
    band_sizes,
    dwt53_fwd,
    dwt53_fwd_1d,
    dwt53_fwd_2d,
    dwt53_inv,
    dwt53_inv_1d,
    dwt53_inv_2d,
    dwt_fwd,
    dwt_fwd_1d,
    dwt_fwd_2d,
    dwt_inv,
    dwt_inv_1d,
    dwt_inv_2d,
    filterbank53_fwd_float,
    get_scheme,
    max_levels,
    pack,
    register_scheme,
    unpack,
)
from repro_torch.core.ranges import (  # noqa: F401
    RangeCertificate,
    certified_levels,
    range_certificate,
)
