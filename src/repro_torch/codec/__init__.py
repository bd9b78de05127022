"""Lossless entropy-coded bitstream codec over the integer wavelet bands.

Port of ``repro.codec``: the same module names, the same exports, and the
same bytes, both ways.

    rice.py        adaptive Golomb-Rice coder — hand-written CUDA encode
                   and decode kernels (``csrc/rice.cu``) for CUDA bands,
                   their plain PyTorch versions for CPU bands
    container.py   one pyramid -> one self-describing WZRC blob (v1, v2
                   with per-band CRCs and XOR parity); ``encode_batch`` /
                   ``decode_batch`` treat the lead dim as a serve batch
    progressive.py byte-range decode of one stored container into
                   fidelity tiers
    stream.py      framed sequences of containers (WZRS)
    errors.py      the typed error taxonomy

Encode codes each band where it lives; decode rebuilds bands on
``device`` (the card by default: one decode launch for all the bands of
a container, ``rice.decode_bands``).  ``decode_band`` at this package level
is the PROGRESSIVE per-band decoder (container in, one band out); the
coder-level primitive of the same name stays at
``repro_torch.codec.rice.decode_band``.
"""
from repro_torch.codec.container import (  # noqa: F401
    DecodedPyramid,
    PartialDecode,
    decode_batch,
    decode_pyramid,
    decode_pyramid_partial,
    encode_batch,
    encode_pyramid,
    inverse_transform,
    peek,
    roundtrip_exact,
)
from repro_torch.codec.errors import (  # noqa: F401
    CodecError,
    CorruptBandError,
    CorruptHeaderError,
    TruncatedStreamError,
    UnsupportedVersionError,
)
from repro_torch.codec.progressive import (  # noqa: F401
    BandDecode,
    CountingReader,
    decode_band,
    decode_lowband,
    decode_progressive,
    read_header,
    reconstruct,
)
from repro_torch.codec.rice import (  # noqa: F401
    BLOCK_VALUES,
    encode_band,
    unzigzag,
    zigzag,
)
from repro_torch.codec.stream import (  # noqa: F401
    StreamEncoder,
    decode_stream,
    decode_volume,
    encode_volume,
    iter_frames,
)

__all__ = [
    "CodecError",
    "CorruptBandError",
    "CorruptHeaderError",
    "TruncatedStreamError",
    "UnsupportedVersionError",
    "DecodedPyramid",
    "PartialDecode",
    "decode_batch",
    "decode_pyramid",
    "decode_pyramid_partial",
    "encode_batch",
    "encode_pyramid",
    "inverse_transform",
    "peek",
    "roundtrip_exact",
    "BandDecode",
    "CountingReader",
    "decode_band",
    "decode_lowband",
    "decode_progressive",
    "read_header",
    "reconstruct",
    "BLOCK_VALUES",
    "encode_band",
    "unzigzag",
    "zigzag",
    "StreamEncoder",
    "decode_stream",
    "decode_volume",
    "encode_volume",
    "iter_frames",
]
