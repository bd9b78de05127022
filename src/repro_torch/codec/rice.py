"""Adaptive Golomb-Rice coding of integer wavelet bands: kernels and plain versions.

Port of ``repro.codec.rice``.  Signed band coefficients are zigzag-mapped
to unsigned magnitudes and Rice-coded in independent blocks of
``BLOCK_VALUES`` samples, each with its own parameter ``k`` (the first
``k`` of least exact cost in ``0..K_MAX``, as ``jnp.argmin`` picks it),
each value as ``q = u >> k`` unary ones, a zero, then ``k`` remainder
bits; quotients at or above ``Q_MAX`` escape to ``Q_MAX`` ones and the
raw 32-bit value.  Blocks are byte-aligned and self-contained (own ``k``,
own byte length), so both directions parallelise across blocks.

Two hand-written CUDA kernels (``csrc/rice.cu``) take a CUDA tensor:

  * ``rice_encode`` — the reference's Pallas stage ``_pack_words_pallas``
    fused with the jnp stages around it (``_encode_chunk``): zigzag, the
    k-cost scan, code lengths, their prefix sum, bit placement and the
    word pack, one thread block per Rice block, into a padded
    ``BYTES_CAP``-byte row per block; a second small kernel compacts the
    rows to the payload at the byte offsets ``torch.cumsum`` gives;
  * ``rice_decode`` — the reference's 256-step ``lax.scan`` of gathers
    (``_decode_chunk``, no Pallas kernel on the TPU side): one thread per
    Rice block walks its codes from its own byte range.

Beside them, the plain PyTorch versions the CPU tests run and the card
check holds the kernels against: :func:`zigzag`, :func:`unzigzag`,
:func:`pack_words`, :func:`_encode_chunk` and :func:`_decode_chunk`,
written as the reference writes them.  Unsigned 32-bit arithmetic runs in
int64 masked to 32 bits (torch's uint32 coverage on the CPU is partial),
which gives the reference's bits for ``INT32_MIN`` / ``INT32_MAX``.

Host-facing API: :func:`encode_band` takes a tensor and codes it where it
lives (CUDA: the kernels, whole band per launch, only the compact payload
and the tables come to the host; CPU: the plain version in
``CHUNK_BLOCKS`` chunks); :func:`decode_band` rebuilds the band on
``device`` (the card by default; it raises without one).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import backend as _backend

Tensor = torch.Tensor

BLOCK_VALUES = 256
Q_MAX = 8  # unary quotient cap; q >= Q_MAX escapes to 32 raw bits
K_MAX = 24  # largest Rice parameter the cost scan considers
LMAX = Q_MAX + 32  # longest code: escape (non-escape max is Q_MAX+K_MAX)

_STRIDE_BITS = BLOCK_VALUES * LMAX  # per-block bit workspace (10240)
_WORDS = _STRIDE_BITS // 32
BYTES_CAP = _STRIDE_BITS // 8  # worst-case encoded bytes per block

# blocks per plain-version chunk: bounds its (nb, 256, 40) bit grid
CHUNK_BLOCKS = 128

_MASK32 = 0xFFFFFFFF


def n_blocks(count: int) -> int:
    return -(-count // BLOCK_VALUES)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def zigzag(x: Tensor) -> Tensor:
    """Signed int32 -> the uint32 value ``(x << 1) ^ (x >> 31)``, held in
    int64.  INT32_MIN maps to 0xFFFFFFFF."""
    x = x.to(torch.int64)
    return ((x << 1) ^ (x >> 31)) & _MASK32


def unzigzag(u: Tensor) -> Tensor:
    """Inverse of :func:`zigzag`: uint32 values (any integer dtype) -> int32."""
    u = u.to(torch.int64) & _MASK32
    return ((u >> 1) ^ -(u & 1)).to(torch.int32)


def _wrap_int32(v: Tensor) -> Tensor:
    """Values in [0, 2**32) held in int64 -> the int32 with those bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def pack_words(bits3: Tensor) -> Tensor:
    """(nb, 32, nwords) 0/1 planes -> (nb, nwords) packed int32 words.

    The function ``_pack_words_pallas`` computes: bit ``32w + i`` of a
    block is bit ``31 - i`` of word ``w`` (MSB first within every byte).
    """
    sh = (31 - torch.arange(32, dtype=torch.int64, device=bits3.device)).view(1, 32, 1)
    acc = (bits3.to(torch.int64) << sh).sum(dim=1) & _MASK32
    return _wrap_int32(acc)


def _encode_chunk(xb: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Encode (nb, BLOCK_VALUES) int32 blocks, as the reference does.

    Returns (bytes (nb, BYTES_CAP) uint8, nbits (nb,) int32, k (nb,) int32).
    """
    nb = xb.shape[0]
    dev = xb.device
    u = zigzag(xb)

    # exact per-block cost of every candidate k; a strictly smaller cost
    # replaces the best, so ties keep the FIRST k (jnp.argmin's rule)
    ks = torch.zeros(nb, dtype=torch.int64, device=dev)
    best = None
    for k in range(K_MAX + 1):
        q = u >> k
        ln = torch.where(q >= Q_MAX, LMAX, torch.clamp(q, max=Q_MAX) + (1 + k))
        cost = ln.sum(dim=1)
        if best is None:
            best = cost
        else:
            better = cost < best
            best = torch.where(better, cost, best)
            ks = torch.where(better, k, ks)

    k2 = ks[:, None]
    q = u >> k2
    esc = q >= Q_MAX
    q_c = torch.clamp(q, max=Q_MAX)
    lens = torch.where(esc, LMAX, q_c + 1 + k2)
    offs = torch.cumsum(lens, dim=1) - lens  # exclusive prefix sum
    nbits = offs[:, -1] + lens[:, -1]
    rem = u & ((1 << k2) - 1)

    # materialise every code bit on a (nb, BLOCK, LMAX) grid
    jj = torch.arange(LMAX, dtype=torch.int64, device=dev)
    q3, e3 = q_c[..., None], esc[..., None]
    m = jj - q3 - 1  # remainder bit index (valid where 0 <= m < k)
    k3 = ks[:, None, None]
    rbit = (rem[..., None] >> torch.clamp(k3 - 1 - m, 0, 31)) & 1
    t = jj - Q_MAX  # escape raw-bit index (valid where 0 <= t < 32)
    ebit = (u[..., None] >> torch.clamp(31 - t, 0, 31)) & 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    bits = torch.where(
        jj < q3,
        torch.ones((), dtype=torch.int64, device=dev),  # unary ones
        torch.where(
            e3,
            torch.where((t >= 0) & (t < 32), ebit, zero),
            torch.where((m >= 0) & (m < k3), rbit, zero),  # jj == q3 -> terminator 0
        ),
    )
    valid = jj < lens[..., None]

    # scatter each code's bits to its prefix-sum offset
    pos = offs[..., None] + jj
    gpos = torch.arange(nb, dtype=torch.int64, device=dev)[:, None, None] * _STRIDE_BITS + pos
    buf = torch.zeros(nb * _STRIDE_BITS, dtype=torch.int64, device=dev)
    buf[gpos[valid]] = bits[valid]

    bits3 = buf.view(nb, _WORDS, 32).transpose(1, 2)
    words = pack_words(bits3).to(torch.int64) & _MASK32
    by = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1)
    return (
        by.reshape(nb, BYTES_CAP).to(torch.uint8),
        nbits.to(torch.int32),
        ks.to(torch.int32),
    )


def _decode_chunk(byte_mat: Tensor, ks: Tensor) -> Tensor:
    """Decode (nb, L) byte rows with per-block k -> (nb, BLOCK_VALUES)
    int32, as the reference does: a 256-step scan, each step resolving
    its unary run through a next-zero suffix scan and gathering its
    remainder or escape bits."""
    nb, nbytes = byte_mat.shape
    dev = byte_mat.device
    nbits = nbytes * 8
    lane = torch.arange(8, dtype=torch.int64, device=dev)
    bits = ((byte_mat.to(torch.int64)[..., None] >> (7 - lane)) & 1).reshape(nb, nbits)

    # next-zero-at-or-after: suffix cummin over the zero positions
    pos = torch.arange(nbits, dtype=torch.int64, device=dev)
    idx = torch.where(bits == 0, pos, nbits)
    nz = torch.flip(torch.cummin(torch.flip(idx, dims=[1]), dim=1).values, dims=[1])

    k = ks.to(torch.int64)
    m = torch.arange(K_MAX, dtype=torch.int64, device=dev)
    t = torch.arange(32, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    off = torch.zeros(nb, dtype=torch.int64, device=dev)
    us = []
    for _ in range(BLOCK_VALUES):
        o = torch.clamp(off, 0, nbits - 1)
        nzp = torch.gather(nz, 1, o[:, None])[:, 0]
        q = torch.clamp(nzp - off, 0, Q_MAX)
        esc = q >= Q_MAX
        # remainder: gather K_MAX bits, keep the first k, weight by shifts
        gi = torch.clamp(off[:, None] + q[:, None] + 1 + m[None, :], 0, nbits - 1)
        rb = torch.gather(bits, 1, gi)
        sh = torch.clamp(k[:, None] - 1 - m[None, :], 0, 31)
        r = torch.where(m[None, :] < k[:, None], rb << sh, zero).sum(dim=1) & _MASK32
        u_rice = ((q << k) | r) & _MASK32
        # escape: 32 raw bits after the Q_MAX unary prefix
        ge = torch.clamp(off[:, None] + Q_MAX + t[None, :], 0, nbits - 1)
        eb = torch.gather(bits, 1, ge)
        u_esc = (eb << (31 - t)[None, :]).sum(dim=1)
        us.append(torch.where(esc, u_esc, u_rice))
        off = off + torch.where(esc, LMAX, q + 1 + k)
    return unzigzag(torch.stack(us, dim=1))


def _blocks(flat: Tensor) -> Tensor:
    """A flat int32 band -> (nb, BLOCK_VALUES), the last block zero-padded."""
    nb = n_blocks(flat.numel())
    pad = nb * BLOCK_VALUES - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(nb, BLOCK_VALUES)


def encode_band_plain(
    flat: Tensor, chunk_blocks: int = CHUNK_BLOCKS
) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """The plain version of :func:`encode_band` on a flat int32 tensor of
    any device: :func:`_encode_chunk` over ``chunk_blocks`` blocks at a
    time, each row cut to its byte length."""
    if flat.numel() == 0:
        return b"", np.zeros(0, np.uint8), np.zeros(0, np.uint16)
    blocks = _blocks(flat)
    parts, ks, lens = [], [], []
    for start in range(0, blocks.shape[0], chunk_blocks):
        by, nbits, k = _encode_chunk(blocks[start : start + chunk_blocks])
        blen = (nbits.to(torch.int64) + 7) // 8
        mask = torch.arange(BYTES_CAP, device=by.device)[None, :] < blen[:, None]
        parts.append(by[mask].cpu().numpy().tobytes())
        ks.append(k.cpu().numpy())
        lens.append(blen.cpu().numpy())
    return (
        b"".join(parts),
        np.concatenate(ks).astype(np.uint8),
        np.concatenate(lens).astype(np.uint16),
    )


def _bucket(n: int) -> int:
    """Next power of two >= n (the reference's decode row width)."""
    return 1 << max(0, (n - 1).bit_length())


def decode_band_plain(
    payload: bytes, ks: np.ndarray, blens: np.ndarray, count: int, device="cpu",
    chunk_blocks: int = CHUNK_BLOCKS,
) -> Tensor:
    """The plain version of :func:`decode_band` (tables already checked):
    byte rows zero-padded to the reference's power-of-two width per
    chunk, then :func:`_decode_chunk`.  Returns (nb * BLOCK_VALUES,)."""
    nb = n_blocks(count)
    raw = np.frombuffer(payload, np.uint8)
    offs = np.concatenate([[0], np.cumsum(blens)])
    out = []
    for start in range(0, nb, chunk_blocks):
        rows = min(chunk_blocks, nb - start)
        lens_c = blens[start : start + rows]
        maxlen = _bucket(max(int(lens_c.max()), 8))
        mat = np.zeros((rows, maxlen), np.uint8)
        mask = np.arange(maxlen)[None, :] < lens_c[:, None]
        mat[mask] = raw[offs[start] : offs[start + rows]]
        dec = _decode_chunk(
            torch.from_numpy(mat).to(device),
            torch.from_numpy(ks[start : start + rows].astype(np.int64)).to(device),
        )
        out.append(dec.reshape(-1))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/rice.cu).
# ---------------------------------------------------------------------------


def rice_encode_cuda(flat: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch ``csrc/rice.cu`` ``rice_encode`` on a flat int32 CUDA band
    (values past its end code as the zero padding of the last block).
    Replaces ``repro.codec.rice._pack_words_pallas`` and the jnp stages of
    ``_encode_chunk`` around it.  Returns (rows (nb, BYTES_CAP) uint8,
    k (nb,) uint8, nbits (nb,) int32), every row zero past its bits."""
    dev = _build.check_tensors("rice_encode", [flat])
    count = flat.numel()
    nb = n_blocks(count)
    if nb == 0:
        raise ValueError("rice_encode: empty band (no block to launch)")
    rows = torch.empty((nb, BYTES_CAP), dtype=torch.uint8, device=flat.device)
    ks = torch.empty(nb, dtype=torch.uint8, device=flat.device)
    nbits = torch.empty(nb, dtype=torch.int32, device=flat.device)
    _build.launch("rice", "repro_rice_encode", dev, (flat, rows, ks, nbits), (count, nb))
    _backend.launches.bump("rice_encode")
    return rows, ks, nbits


def rice_compact_cuda(rows: Tensor, nbits: Tensor, offs: Tensor, total: int) -> Tensor:
    """Copy each row's ``ceil(nbits / 8)`` bytes to ``offs`` (int64,
    exclusive prefix sum of the byte lengths) of a ``total``-byte payload:
    the compaction step of ``rice_encode``."""
    dev = _build.check_tensors("rice_compact", [rows], (torch.uint8,))
    _build.check_tensors("rice_compact", [nbits])
    _build.check_tensors("rice_compact", [offs], (torch.int64,))
    payload = torch.empty(total, dtype=torch.uint8, device=rows.device)
    if total:
        _build.launch("rice", "repro_rice_compact", dev, (rows, nbits, offs, payload),
                      (rows.shape[0],))
        _backend.launches.bump("rice_compact")
    return payload


def rice_decode_cuda(payload: Tensor, offs: Tensor, lens: Tensor, ks: Tensor) -> Tensor:
    """Launch ``csrc/rice.cu`` ``rice_decode``: block ``b`` decodes from
    ``payload[offs[b] : offs[b] + lens[b]]`` with parameter ``ks[b]``.
    Replaces the reference's ``_decode_chunk`` scan (no TPU kernel).
    Returns (nb * BLOCK_VALUES,) int32."""
    dev = _build.check_tensors("rice_decode", [payload, ks], (torch.uint8,))
    _build.check_tensors("rice_decode", [offs], (torch.int64,))
    _build.check_tensors("rice_decode", [lens])
    nb = offs.numel()
    if nb == 0 or lens.numel() != nb or ks.numel() != nb:
        raise ValueError(f"rice_decode: {nb} offsets, {lens.numel()} lengths, {ks.numel()} k")
    out = torch.empty(nb * BLOCK_VALUES, dtype=torch.int32, device=offs.device)
    _build.launch("rice", "repro_rice_decode", dev, (payload, offs, lens, ks, out), (nb,))
    _backend.launches.bump("rice_decode")
    return out


def byte_offsets(nbits: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-block byte lengths (int32) and their exclusive prefix sum
    (int64 byte offsets into the payload), on the blocks' device."""
    lens = (nbits + 7) >> 3
    return lens, torch.cumsum(lens, 0, dtype=torch.int64) - lens


def tables_to_host(ks: Tensor, lens: Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """One copy of the k and byte-length tables to the host: (k uint8,
    byte lengths uint16), as the container stores them."""
    with _build.device_errors("rice tables to host"):
        tables = torch.stack([ks.to(torch.int32), lens]).cpu().numpy()
    return tables[0].astype(np.uint8), tables[1].astype(np.uint16)


def payload_to_host(payload: Tensor) -> bytes:
    with _build.device_errors("rice payload to host"):
        return payload.cpu().numpy().tobytes()


def encode_band_cuda(flat: Tensor) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """:func:`encode_band` on a flat int32 CUDA band: the encode kernel,
    the byte offsets, one copy of the tables to the host, the compaction
    kernel, then only the payload's bytes.  A kernel fault that surfaces
    at a copy to the host raises ``KernelLaunchError``."""
    rows, ks, nbits = rice_encode_cuda(flat)
    lens, offs = byte_offsets(nbits)
    k_h, lens_h = tables_to_host(ks, lens)
    payload = rice_compact_cuda(rows, nbits, offs, int(lens_h.sum()))
    return payload_to_host(payload), k_h, lens_h


# ---------------------------------------------------------------------------
# Host-facing band API.
# ---------------------------------------------------------------------------


def _flat_int32(x) -> Tensor:
    """A band (tensor, or anything ``np.array`` takes) as a flat
    contiguous int32 tensor on its own device (narrow dtypes widen, as
    the reference's ``astype(np.int32)`` does)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.reshape(-1).to(torch.int32).contiguous()


def encode_band(x) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """Rice-encode a flat integer band where it lives.

    Returns ``(payload, k_table, byte_lengths)`` — the byte-aligned
    concatenated block bitstreams plus the per-block Rice parameters
    (uint8) and encoded byte counts (uint16) the container serialises,
    byte for byte the reference's.  A CUDA tensor goes to the kernels
    (one launch for the whole band), a CPU tensor to the plain version.
    """
    flat = _flat_int32(x)
    if flat.numel() == 0:  # no block: nothing to launch
        return b"", np.zeros(0, np.uint8), np.zeros(0, np.uint16)
    if _backend.on_cuda(flat):
        return encode_band_cuda(flat)
    return encode_band_plain(flat)


def _check_tables(payload: bytes, k_table, byte_lengths, count: int):
    """The reference's host checks on a band's tables, plus a k range
    check; returns (k int64, byte lengths int64) ndarrays."""
    nb = n_blocks(count)
    ks = np.asarray(k_table).astype(np.int64)
    blens = np.asarray(byte_lengths).astype(np.int64)
    if ks.shape[0] != nb or blens.shape[0] != nb:
        raise ValueError(f"rice tables describe {ks.shape[0]} blocks, geometry needs {nb}")
    if int(blens.sum()) != len(payload):
        raise ValueError(
            f"rice payload is {len(payload)} bytes, block lengths sum to "
            f"{int(blens.sum())} (truncated or corrupt stream)"
        )
    if nb and int(ks.max()) > K_MAX:
        raise ValueError(f"rice k table holds k={int(ks.max())} > K_MAX={K_MAX} (corrupt stream)")
    return ks, blens


def decode_band(
    payload: bytes, k_table, byte_lengths, count: int, device="cuda"
) -> Tensor:
    """Inverse of :func:`encode_band` -> flat int32 tensor of ``count`` on
    ``device``: the decode kernel on the card (the default; it raises
    without one), the plain version on the CPU."""
    dev = _backend.resolve_device(device)
    if count == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    ks, blens = _check_tables(payload, k_table, byte_lengths, count)
    if dev.type == "cpu":
        return decode_band_plain(payload, ks, blens, count)[:count]
    raw = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(dev)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(blens)[:-1]]).astype(np.int64)).to(dev)
    out = rice_decode_cuda(
        raw, offs,
        torch.from_numpy(blens.astype(np.int32)).to(dev),
        torch.from_numpy(ks.astype(np.uint8)).to(dev),
    )
    return out[:count]
