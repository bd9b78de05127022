"""Wavelet tensor compression on the paper's integer lifting DWT.

Port of ``repro.core.compression``.  Two uses, as in the reference:

1. **Cross-pod gradient sync** (``train/grad_compress.py``): quantize a
   gradient to integers with a shared scale, run the multiplierless
   integer DWT, and ship either the approximation band alone (the
   low-band codec) or every band, integer-quantized per band (the
   band-quantized codec: approx at int16, details at int8 after a
   per-band arithmetic right shift).
2. **Checkpoint/tensor packing** (``ckpt/``): integer DWT + an entropy
   coder; :func:`encoded_bytes` and its relatives measure the Rice
   container's bytes on the real values.

The quantize -> integer-DWT -> dequantize channel is the fixed-point
chain of the paper's hardware modules (shift/add arithmetic); the
"samples" are gradient values.

Every function takes and returns tensors on its input's device: a CUDA
tensor is transformed by the hand-written kernels (``repro_torch.kernels``),
a CPU tensor by their plain versions.  There is no ``backend=`` argument.

Two rules keep the integers equal to the reference's:

* **Division.** ``x / scale`` is float32 divided by float32, correctly
  rounded (:func:`divide_f32`).  PyTorch's CUDA true divide by a Python
  or CPU scalar multiplies by the scalar's reciprocal, which rounds
  differently at about one value in 10^5, so the divisor goes in as a
  0-dim tensor on the dividend's device.
* **Band shifts.** :func:`_band_shift` is exact: the smallest ``sh`` in
  0..30 with ``fl32(max(amax, 1) / limit) <= 2**sh``, read from the
  float32 quotient's exponent (``torch.frexp``).  The reference's
  ``ceil(log2(.))`` equals it wherever XLA's ``log2`` is correctly
  rounded; next to the powers of two it is not always, and
  ``torch.log2`` rounds differently again.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import Tensor

from repro_torch import kernels as K
from repro_torch.core import lifting

INT_SCALE_BITS = 15  # quantize to +-2^15 (int16 range) before the DWT
_LIM16 = 2**15 - 1  # approx bands: int16
_LIM8 = 2**7 - 1  # detail bands: int8

Scale = Union[Tensor, float]


def divide_f32(x: Tensor, d: Scale) -> Tensor:
    """``x / d`` in float32, correctly rounded, on ``x``'s device.

    ``d`` (a Python number, rounded to float32, or a tensor) is moved to a
    0-dim float32 tensor on ``x``'s device first: a CUDA divide by a CPU
    scalar would multiply by its reciprocal instead."""
    if not isinstance(d, Tensor):
        d = torch.tensor(float(d), dtype=torch.float32)
    return x.to(torch.float32) / d.to(device=x.device, dtype=torch.float32)


class CompressedBand(NamedTuple):
    """Low-band payload + the metadata needed to reconstruct.

    Payloads are (n_lines, band_len) — line-blocked like the paper's
    serial hardware modules.
    """

    low: Tensor  # int32 approximation band, (n_lines, a_len)
    scale: Scale  # float32 scalar dequantization scale
    n: int  # total padded length (n_lines * line)
    levels: int


BLOCK = 65536  # transform line length — the paper's modules process lines


def _flatten_pad(g: Tensor, levels: int) -> Tuple[Tensor, int]:
    """Flatten to (n_lines, line) zero-padded lines, line = min(n, BLOCK)
    (at least 2**levels)."""
    flat = g.reshape(-1)
    n = flat.shape[0]
    line = max(min(n, BLOCK), 1 << levels)
    pad = (-n) % line
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, line), n


def quantize(
    g: Tensor,
    scale: Scale,
    *,
    scheme: Optional[str] = None,
    levels: Optional[int] = None,
    mode: str = "paper",
    ndim: int = 1,
) -> Tensor:
    """fp -> int32 with the given positive scale (shared across pods).

    The limit is ``+-(2**15 - 1)``; with ``scheme`` and ``levels`` it is
    also clamped to the derived overflow certificate of the cascade the
    caller is about to run (``core.ranges.range_certificate``)."""
    q = torch.round(divide_f32(g, scale))
    lim = float(_LIM16)
    if scheme is not None and levels is not None:
        from repro_torch.core import ranges

        cert = ranges.range_certificate(scheme, levels, "int32", mode=mode, ndim=ndim)
        lim = min(lim, float(cert.hi))
    return torch.clamp(q, -lim, lim).to(torch.int32)


def dequantize(q: Tensor, scale: Scale) -> Tensor:
    return q.to(torch.float32) * scale


def tensor_scale(g: Tensor) -> Tensor:
    """Per-tensor quantization scale (float32 0-dim tensor on ``g``'s
    device)."""
    amax = g.to(torch.float32).abs().max()
    return divide_f32(torch.clamp(amax, min=1e-12), float(_LIM16))


def compress_lowband(
    g: Tensor, scale: Scale, levels: int, mode: str = "paper", scheme: str = "cdf53"
) -> CompressedBand:
    """Quantize + integer DWT, keep only the approximation band."""
    lines, _ = _flatten_pad(g, levels)
    q = quantize(lines, scale)
    pyr = K.dwt_fwd(q, levels=levels, mode=mode, scheme=scheme)
    return CompressedBand(low=pyr.approx, scale=scale, n=lines.numel(), levels=levels)


def reconstruct_lowband(
    band: CompressedBand, out_shape, mode: str = "paper", scheme: str = "cdf53"
) -> Tensor:
    """Inverse DWT with zeroed detail bands, reshaped: the int32 samples
    :func:`decompress_lowband` dequantizes."""
    n_lines, _ = band.low.shape
    line = band.n // n_lines
    _, d_lens = lifting.band_sizes(line, band.levels)
    details = tuple(band.low.new_zeros((n_lines, dl)) for dl in d_lens)
    pyr = lifting.WaveletPyramid(approx=band.low, details=details)
    flat = K.dwt_inv(pyr, mode=mode, scheme=scheme).reshape(-1)
    return flat[: math.prod(out_shape)].reshape(tuple(out_shape))


def decompress_lowband(
    band: CompressedBand, out_shape, mode: str = "paper", scheme: str = "cdf53"
) -> Tensor:
    """Inverse DWT with zeroed detail bands, dequantize, reshape."""
    return dequantize(reconstruct_lowband(band, out_shape, mode, scheme), band.scale)


def residual_fused(g32: Tensor, q: Tensor, scale: Scale) -> Tensor:
    """``g32 - q * scale`` rounded ONCE to float32, as a fused
    multiply-subtract computes it: the reference's error feedback
    (``repro.train.grad_compress``) is one XLA program, whose compiler
    contracts the dequantize into the subtraction.  The product of an
    integer of at most 31 bits and a float32 scale and the difference
    are taken in float64, so the result does not depend on the device
    contracting anything."""
    s = scale.to(torch.float64) if isinstance(scale, Tensor) else float(scale)
    return (g32.to(torch.float64) - q.to(torch.float64) * s).to(torch.float32)


def _residual(g: Tensor, g_hat: Tensor) -> Tensor:
    return g.to(torch.float32) - g_hat.to(torch.float32)


def lossy_roundtrip(
    g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53"
) -> Tuple[Tensor, Tensor]:
    """g -> lowband channel -> g_hat. Returns (g_hat, residual)."""
    scale = tensor_scale(g)
    band = compress_lowband(g, scale, levels, mode, scheme=scheme)
    g_hat = decompress_lowband(band, g.shape, mode, scheme=scheme).to(g.dtype)
    return g_hat, _residual(g, g_hat)


def compression_ratio(shape, levels: int) -> float:
    """ANALYTIC bytes(original fp32) / bytes(low band), assuming the low
    band ships as RAW int32 — a pure function of the geometry.  For
    measured bytes through the Rice codec use :func:`encoded_ratio`."""
    n = math.prod(shape)
    m = 1 << levels
    n_pad = (n + m - 1) // m * m
    return n * 4 / (n_pad // m * 4)


# ---------------------------------------------------------------------------
# Band-quantized representation (the production gradient-sync codec):
# every band shipped, approx at int16, details at int8 after a per-band
# arithmetic right shift.  Quantization error has no fixed subspace, so
# error feedback drains (the low-band projector's does not).
# ---------------------------------------------------------------------------


class BandQuantized(NamedTuple):
    approx: Tensor  # int16 (shifted)
    details: Tuple[Tensor, ...]  # int8 (shifted), coarsest first
    approx_shift: Tensor  # int32 scalar
    detail_shifts: Tuple[Tensor, ...]  # int32 scalars
    scale: Scale  # float32 scalar
    n: int
    levels: int


def _band_shift(band: Tensor, limit: int) -> Tensor:
    """Smallest arithmetic right shift (0..30) that fits the band into
    +-limit: the least ``sh`` with ``fl32(max(amax, 1) / limit) <= 2**sh``
    (module docstring).  frexp gives q = m * 2**e, m in [0.5, 1); q is
    2**(e-1) exactly when m == 0.5."""
    amax = band.abs().max().to(torch.float32)
    m, e = torch.frexp(divide_f32(torch.clamp(amax, min=1.0), float(limit)))
    return torch.clamp(e - (m == 0.5).to(e.dtype), 0, 30).to(torch.int32)


def _narrow(band: Tensor, shift: Tensor, lim: int, dtype: torch.dtype) -> Tensor:
    """Arithmetic right shift, clip to +-lim, cast (int16 / int8)."""
    return torch.clamp(torch.bitwise_right_shift(band, shift), -lim, lim).to(dtype)


def _widen(band: Tensor, shift: Tensor) -> Tensor:
    """Undo :func:`_narrow`'s shift (int32 left shift, wrapping)."""
    return torch.bitwise_left_shift(band.to(torch.int32), shift)


def forward_bands(
    g: Tensor, scale: Scale, levels: int, mode: str = "paper", scheme: str = "cdf53"
) -> Tuple[Tensor, Tuple[Tensor, ...], int]:
    """fp tensor -> int32 DWT bands ((lines, a), details, padded_len)."""
    lines, _ = _flatten_pad(g, levels)
    q = quantize(lines, scale)
    pyr = K.dwt_fwd(q, levels=levels, mode=mode, scheme=scheme)
    return pyr.approx, tuple(pyr.details), lines.numel()


def band_shifts(
    approx: Tensor, details: Tuple[Tensor, ...]
) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    return (
        _band_shift(approx, _LIM16),
        tuple(_band_shift(d, _LIM8) for d in details),
    )


def quantize_bands(
    approx: Tensor,
    details: Tuple[Tensor, ...],
    shifts: Tuple[Tensor, Tuple[Tensor, ...]],
    scale: Scale,
    n: int,
    levels: int,
) -> BandQuantized:
    a_sh, d_shs = shifts
    return BandQuantized(
        approx=_narrow(approx, a_sh, _LIM16, torch.int16),
        details=tuple(_narrow(d, sh, _LIM8, torch.int8) for d, sh in zip(details, d_shs)),
        approx_shift=a_sh,
        detail_shifts=d_shs,
        scale=scale,
        n=n,
        levels=levels,
    )


def compress_bands(
    g: Tensor,
    scale: Scale,
    levels: int,
    mode: str = "paper",
    shifts: Optional[Tuple[Tensor, Tuple[Tensor, ...]]] = None,
    scheme: str = "cdf53",
) -> BandQuantized:
    """fp tensor -> integer DWT -> per-band int16/int8 quantization.

    ``shifts`` may be supplied (e.g. the pod-global max of each band's
    shift) so all participants quantize identically."""
    approx, details, n = forward_bands(g, scale, levels, mode, scheme=scheme)
    if shifts is None:
        shifts = band_shifts(approx, details)
    return quantize_bands(approx, details, shifts, scale, n, levels)


def decompress_bands(
    bq: BandQuantized,
    out_shape,
    mode: str = "paper",
    approx_i32: Optional[Tensor] = None,
    details_i32: Optional[Tuple[Tensor, ...]] = None,
    scheme: str = "cdf53",
) -> Tensor:
    """Inverse of compress_bands. ``*_i32`` overrides let callers pass
    locally-accumulated (summed) integer bands (pod sync path)."""
    approx = approx_i32 if approx_i32 is not None else bq.approx
    details = details_i32 if details_i32 is not None else bq.details
    pyr = lifting.WaveletPyramid(
        approx=_widen(approx, bq.approx_shift),
        details=tuple(_widen(d, sh) for d, sh in zip(details, bq.detail_shifts)),
    )
    flat = K.dwt_inv(pyr, mode=mode, scheme=scheme).reshape(-1)
    return dequantize(flat[: math.prod(out_shape)], bq.scale).reshape(tuple(out_shape))


def band_quantized_roundtrip(
    g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53"
) -> Tuple[Tensor, Tensor]:
    """g -> band-quantized channel -> g_hat. Returns (g_hat, residual)."""
    scale = tensor_scale(g)
    bq = compress_bands(g, scale, levels, mode, scheme=scheme)
    g_hat = decompress_bands(bq, g.shape, mode, scheme=scheme).to(g.dtype)
    return g_hat, _residual(g, g_hat)


# ---------------------------------------------------------------------------
# Last-axis band codec (the pod sync's 1-D route): the transform runs
# along the tensor's own last axis, so every band keeps the tensor's
# leading layout.
# ---------------------------------------------------------------------------


def forward_bands_nd(
    g: Tensor, scale: Scale, levels: int, mode: str = "paper", scheme: str = "cdf53"
) -> lifting.WaveletPyramid:
    """Quantize + integer DWT along the LAST axis."""
    q = quantize(g, scale)
    if q.ndim == 0:
        q = q.reshape(1)
    return K.dwt_fwd(q, levels=levels, mode=mode, scheme=scheme)


def quantize_pyramid(
    pyr: lifting.WaveletPyramid, shifts: Tuple[Tensor, Tuple[Tensor, ...]]
) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    """approx -> int16, details -> int8, after the given per-band shifts."""
    a_sh, d_shs = shifts
    return (
        _narrow(pyr.approx, a_sh, _LIM16, torch.int16),
        tuple(_narrow(d, sh, _LIM8, torch.int8) for d, sh in zip(pyr.details, d_shs)),
    )


def pyramid_shifts(
    pyr: lifting.WaveletPyramid,
) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    return band_shifts(pyr.approx, tuple(pyr.details))


def decompress_bands_nd(
    approx_i32: Tensor,
    details_i32: Tuple[Tensor, ...],
    shifts: Tuple[Tensor, Tuple[Tensor, ...]],
    scale: Scale,
    out_shape,
    mode: str = "paper",
    scheme: str = "cdf53",
) -> Tensor:
    return dequantize(
        reconstruct_bands_nd(approx_i32, details_i32, shifts, out_shape, mode, scheme), scale)


def reconstruct_bands_nd(
    approx_i32: Tensor,
    details_i32: Tuple[Tensor, ...],
    shifts: Tuple[Tensor, Tuple[Tensor, ...]],
    out_shape,
    mode: str = "paper",
    scheme: str = "cdf53",
) -> Tensor:
    """Un-shift and inverse last-axis pyramid: the int32 samples
    :func:`decompress_bands_nd` dequantizes."""
    a_sh, d_shs = shifts
    pyr = lifting.WaveletPyramid(
        approx=_widen(approx_i32, a_sh),
        details=tuple(_widen(d, sh) for d, sh in zip(details_i32, d_shs)),
    )
    return K.dwt_inv(pyr, mode=mode, scheme=scheme).reshape(tuple(out_shape))


# ---------------------------------------------------------------------------
# 2-D and N-D band codecs: the Mallat pyramid over the last two (three)
# axes, leading dims batched.  Band layout as the 1-D codec: approx at
# int16, details at int8 after per-band shifts.
# ---------------------------------------------------------------------------


def _level_shifts(approx: Tensor, details):
    """(approx shift, per-level per-band shifts) — the 1-D limits."""
    return (
        _band_shift(approx, _LIM16),
        tuple(tuple(_band_shift(b, _LIM8) for b in lvl) for lvl in details),
    )


def _level_narrow(approx: Tensor, details, shifts):
    a_sh, det_shs = shifts
    return (
        _narrow(approx, a_sh, _LIM16, torch.int16),
        tuple(
            tuple(_narrow(b, sh, _LIM8, torch.int8) for b, sh in zip(lvl, lvl_shs))
            for lvl, lvl_shs in zip(details, det_shs)
        ),
    )


def _level_widen(approx_i32: Tensor, details_i32, shifts):
    a_sh, det_shs = shifts
    return (
        _widen(approx_i32, a_sh),
        tuple(
            tuple(_widen(b, sh) for b, sh in zip(lvl, lvl_shs))
            for lvl, lvl_shs in zip(details_i32, det_shs)
        ),
    )


def _as_i32(details):
    return tuple(tuple(b.to(torch.int32) for b in lvl) for lvl in details)


def forward_pyramid_2d(
    g: Tensor, scale: Scale, levels: int, mode: str = "paper", scheme: str = "cdf53"
) -> lifting.Pyramid2D:
    """Quantize + integer 2-D DWT over the last two axes (batched lead)."""
    return K.dwt_fwd_2d_multi(quantize(g, scale), levels=levels, mode=mode, scheme=scheme)


def pyramid2d_shifts(pyr: lifting.Pyramid2D):
    """(ll_shift, per-level (lh, hl, hh) shifts) — same limits as 1-D."""
    return _level_shifts(pyr.ll, pyr.details)


def quantize_pyramid_2d(pyr: lifting.Pyramid2D, shifts):
    """ll -> int16, detail bands -> int8, after the given shifts."""
    return _level_narrow(pyr.ll, pyr.details, shifts)


def decompress_pyramid_2d(
    ll_i32: Tensor, details_i32, shifts, scale: Scale, mode: str = "paper",
    scheme: str = "cdf53",
) -> Tensor:
    """Un-shift, inverse 2-D pyramid, dequantize."""
    return dequantize(reconstruct_pyramid_2d(ll_i32, details_i32, shifts, mode, scheme), scale)


def reconstruct_pyramid_2d(
    ll_i32: Tensor, details_i32, shifts, mode: str = "paper", scheme: str = "cdf53",
) -> Tensor:
    """Un-shift, inverse 2-D pyramid: the int32 samples
    :func:`decompress_pyramid_2d` dequantizes."""
    ll, details = _level_widen(ll_i32, details_i32, shifts)
    return K.dwt_inv_2d_multi(lifting.Pyramid2D(ll=ll, details=details), mode=mode, scheme=scheme)


def band_quantized_roundtrip_2d(
    g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53"
) -> Tuple[Tensor, Tensor]:
    """g -> 2-D band-quantized channel -> g_hat. Returns (g_hat, residual)."""
    scale = tensor_scale(g)
    pyr = forward_pyramid_2d(g, scale, levels, mode, scheme=scheme)
    shifts = pyramid2d_shifts(pyr)
    ll_q, details_q = quantize_pyramid_2d(pyr, shifts)
    g_hat = decompress_pyramid_2d(
        ll_q.to(torch.int32), _as_i32(details_q), shifts, scale, mode, scheme=scheme
    ).to(g.dtype)
    return g_hat, _residual(g, g_hat)


def forward_pyramid_nd(
    g: Tensor, scale: Scale, levels: int, mode: str = "paper", scheme: str = "cdf53",
    ndim: int = 3,
) -> lifting.PyramidND:
    """Quantize + integer N-D DWT over the last ``ndim`` axes."""
    return K.dwt_fwd_nd(quantize(g, scale), levels=levels, mode=mode, scheme=scheme, ndim=ndim)


def pyramid_nd_shifts(pyr: lifting.PyramidND):
    """(approx_shift, per-level per-band shifts) — same limits as 1-D/2-D."""
    return _level_shifts(pyr.approx, pyr.details)


def quantize_pyramid_nd(pyr: lifting.PyramidND, shifts):
    """approx -> int16, detail bands -> int8, after the given shifts."""
    return _level_narrow(pyr.approx, pyr.details, shifts)


def decompress_pyramid_nd(
    approx_i32: Tensor, details_i32, shifts, scale: Scale, mode: str = "paper",
    scheme: str = "cdf53",
) -> Tensor:
    """Un-shift, inverse N-D pyramid, dequantize."""
    return dequantize(reconstruct_pyramid_nd(approx_i32, details_i32, shifts, mode, scheme), scale)


def reconstruct_pyramid_nd(
    approx_i32: Tensor, details_i32, shifts, mode: str = "paper", scheme: str = "cdf53",
) -> Tensor:
    """Un-shift, inverse N-D pyramid: the int32 samples
    :func:`decompress_pyramid_nd` dequantizes."""
    approx, details = _level_widen(approx_i32, details_i32, shifts)
    return K.dwt_inv_nd(lifting.PyramidND(approx=approx, details=details), mode=mode,
                        scheme=scheme)


def band_quantized_roundtrip_nd(
    g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53", ndim: int = 3
) -> Tuple[Tensor, Tensor]:
    """g -> N-D band-quantized channel -> g_hat. Returns (g_hat, residual)."""
    scale = tensor_scale(g)
    pyr = forward_pyramid_nd(g, scale, levels, mode, scheme=scheme, ndim=ndim)
    shifts = pyramid_nd_shifts(pyr)
    a_q, details_q = quantize_pyramid_nd(pyr, shifts)
    g_hat = decompress_pyramid_nd(
        a_q.to(torch.int32), _as_i32(details_q), shifts, scale, mode, scheme=scheme
    ).to(g.dtype)
    return g_hat, _residual(g, g_hat)


# ---------------------------------------------------------------------------
# ANALYTIC wire bytes of the band-quantized payloads (raw fixed-width
# bands: int16 approx, int8 details, + 8 bytes of scale/shift scalars).
# Geometry only; the encoded_bytes family below measures coded bytes.
# ---------------------------------------------------------------------------


def band_bytes_nd(shape, levels: int) -> int:
    """ANALYTIC wire bytes of the N-D band-quantized payload for a
    trailing shape (see :func:`encoded_bytes_nd` for measured bytes)."""
    a_shape, det_shapes = lifting.band_shapes_nd(tuple(shape), levels)
    total = 2 * math.prod(a_shape)
    for lvl in det_shapes:
        total += sum(math.prod(band) for band in lvl)  # int8 detail bands
    return total + 8


def band_bytes_2d(h: int, w: int, levels: int) -> int:
    """ANALYTIC wire bytes of the 2-D band-quantized payload for an
    (h, w) slice (see :func:`encoded_bytes_2d` for measured bytes)."""
    (h_ll, w_ll), det_shapes = lifting.band_shapes_2d(h, w, levels)
    total = h_ll * w_ll * 2
    for lvl in det_shapes:
        total += sum(a * b for a, b in lvl)
    return total + 8


def band_bytes(n: int, levels: int) -> int:
    """ANALYTIC wire bytes of the band-quantized payload for n fp32
    values (see :func:`encoded_bytes` for measured bytes)."""
    line = max(min(n, BLOCK), 1 << levels)
    n_pad = (n + line - 1) // line * line
    a_len, d_lens = lifting.band_sizes(line, levels)
    return n_pad // line * (a_len * 2 + sum(d_lens)) + 8


# ---------------------------------------------------------------------------
# MEASURED entropy-coded sizes: quantize, integer DWT, Rice container
# (``repro_torch.codec``) on the tensor's own device; the bytes that
# would hit the wire.
# ---------------------------------------------------------------------------


def _coded_len(pyr, scheme: str, mode: str, ndim: Optional[int] = None) -> int:
    from repro_torch.codec import container

    return len(container.encode_pyramid(pyr, scheme=scheme, mode=mode, ndim=ndim))


def encoded_bytes(g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53") -> int:
    """Measured codec bytes of the 1-D line-blocked pyramid of ``g``."""
    lines, _ = _flatten_pad(g, levels)
    q = quantize(lines, tensor_scale(g))
    return _coded_len(K.dwt_fwd(q, levels=levels, mode=mode, scheme=scheme), scheme, mode)


def encoded_bytes_last_axis(
    g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53"
) -> int:
    """Measured codec bytes of the LAST-AXIS pyramid of ``g``: the
    pyramid the pod sync's 1-D route ships (:func:`forward_bands_nd`)."""
    pyr = forward_bands_nd(g, tensor_scale(g), levels, mode, scheme=scheme)
    return _coded_len(pyr, scheme, mode)


def encoded_bytes_2d(g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53") -> int:
    """Measured codec bytes of the 2-D Mallat pyramid of ``g``."""
    pyr = forward_pyramid_2d(g, tensor_scale(g), levels, mode, scheme=scheme)
    return _coded_len(pyr, scheme, mode)


def encoded_bytes_nd(
    g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53", ndim: int = 3
) -> int:
    """Measured codec bytes of the N-D pyramid of ``g``."""
    pyr = forward_pyramid_nd(g, tensor_scale(g), levels, mode, scheme=scheme, ndim=ndim)
    return _coded_len(pyr, scheme, mode, ndim=ndim)


def _raw_fp32_bytes(g: Tensor) -> int:
    return max(math.prod(g.shape), 1) * 4


def encoded_ratio(g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53") -> float:
    """MEASURED bytes(original fp32) / bytes(Rice-coded 1-D pyramid)."""
    return _raw_fp32_bytes(g) / encoded_bytes(g, levels, mode, scheme)


def encoded_ratio_2d(g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53") -> float:
    """MEASURED fp32-vs-coded ratio through the 2-D pyramid codec."""
    return _raw_fp32_bytes(g) / encoded_bytes_2d(g, levels, mode, scheme)


def encoded_ratio_nd(
    g: Tensor, levels: int, mode: str = "paper", scheme: str = "cdf53", ndim: int = 3
) -> float:
    """MEASURED fp32-vs-coded ratio through the N-D pyramid codec."""
    return _raw_fp32_bytes(g) / encoded_bytes_nd(g, levels, mode, scheme, ndim=ndim)
