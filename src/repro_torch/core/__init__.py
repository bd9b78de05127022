"""Core: the paper's integer lifting-scheme DWT and its range model.

Re-exports what ``repro.core`` re-exports, on torch tensors.  The one
name left out, ``filterbank53_fwd_float`` (the float filter-bank
comparison of the reference), is not ported yet: see ROADMAP.md Queue 1
item 7.
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
