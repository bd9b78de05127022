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
    k-cost scan, code lengths, their prefix sum, bit placement, the word
    pack and the byte offsets, one warp per Rice block, in ONE launch
    over every band of a pyramid: each block's bytes go straight to
    their final offset in one payload, beside the k and byte-length
    tables;
  * ``rice_decode`` — the reference's 256-step ``lax.scan`` of gathers
    (``_decode_chunk``, no Pallas kernel on the TPU side), in ONE launch
    over every band of a container: one warp per Rice block, its lanes
    splitting the block's bits, code boundaries made exact by
    synchronising rounds, each block's bytes found by a look-back over
    tiles of blocks.

Beside them, the plain PyTorch versions the CPU tests run and the card
check holds the kernels against: :func:`zigzag`, :func:`unzigzag`,
:func:`pack_words`, :func:`_encode_chunk` and :func:`_decode_chunk`,
written as the reference writes them; and :func:`decode_block_serial`,
one block as the decode kernel reads it (bytes past its length zero),
for streams that are not well formed.  Unsigned 32-bit arithmetic runs in
int64 masked to 32 bits (torch's uint32 coverage on the CPU is partial),
which gives the reference's bits for ``INT32_MIN`` / ``INT32_MAX``.

Host-facing API: :func:`encode_bands` takes a pyramid's bands and codes
each where it lives (the CUDA bands of a device: one launch, then one
copy of the tables and one of exactly the payload's bytes to the host;
CPU bands: the plain version in ``CHUNK_BLOCKS`` chunks);
:func:`encode_band` is it for one band; :func:`decode_bands` rebuilds
bands on ``device`` (the card by default; it raises without one): on the
card one staged copy of all their coded bytes and one launch, on the CPU
the plain version; :func:`decode_band` is it for one band.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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


def decode_block_serial(block, k: int) -> np.ndarray:
    """One Rice block as the decode kernel reads it, code by code: 256
    codes from bit 0 of ``block`` (bytes), every bit past it 0, so a
    malformed stream decodes too (the first ``BYTES_CAP`` bytes are all
    that 256 codes can reach).  Returns (BLOCK_VALUES,) int32."""
    data = bytes(block[:BYTES_CAP])
    nbits = 8 * len(data)
    bits = int.from_bytes(data, "big") << LMAX  # LMAX zero bits past the end
    out = np.zeros(BLOCK_VALUES, np.int64)
    p = 0
    for i in range(BLOCK_VALUES):
        if p >= nbits:  # only zero bits left: every code from here is 0
            break
        win = (bits >> (nbits - p)) & ((1 << LMAX) - 1)  # the LMAX bits from p
        ones = 0
        while ones < Q_MAX and (win >> (LMAX - 1 - ones)) & 1:
            ones += 1
        if ones == Q_MAX:  # escape: the 32 raw bits after Q_MAX ones
            out[i] = win & _MASK32
            p += LMAX
        else:
            out[i] = (ones << k) | ((win >> (LMAX - 1 - ones - k)) & ((1 << k) - 1))
            p += ones + 1 + k
    return unzigzag(torch.from_numpy(out)).numpy()


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/rice.cu).
# ---------------------------------------------------------------------------

Coded = Tuple[bytes, np.ndarray, np.ndarray]


def rice_encode_cuda(bands: Sequence[Tensor]) -> Tuple[Tensor, Tensor]:
    """Launch ``csrc/rice.cu`` ``rice_encode`` once over flat int32 CUDA
    bands, none empty, on one device (each band's last block codes its
    zero pad as values).  Replaces ``repro.codec.rice._pack_words_pallas``
    and the jnp stages of ``_encode_chunk`` around it, for every band at
    once.  Returns (payload, tables), both uint8 on the card: the bands'
    coded bytes back to back from offset 0 (the buffer is sized for the
    worst case, ``BYTES_CAP`` per block), and the tables that
    :func:`tables_to_host` reads."""
    dev = _build.check_tensors("rice_encode", bands)
    counts = [b.numel() for b in bands]
    if not bands or min(counts) == 0:
        raise ValueError("rice_encode: needs at least one band, none empty (no block to launch)")
    firsts = np.concatenate([[0], np.cumsum([n_blocks(c) for c in counts])])
    nb = int(firsts[-1])
    table = np.concatenate([firsts, [b.data_ptr() for b in bands], counts]).astype(np.int64)
    device = bands[0].device
    payload = torch.empty(nb * BYTES_CAP, dtype=torch.uint8, device=device)
    tables = torch.empty(8 * (len(bands) + 1) + 3 * nb, dtype=torch.uint8, device=device)
    work = torch.empty(nb + 1 + len(table), dtype=torch.int64, device=device)
    _build.launch("rice", "repro_rice_encode", dev, (payload, tables, work), (nb,), table)
    _backend.launches.bump("rice_encode")
    return payload, tables


# the decode table's head: the staged bytes' offsets of every block's
# byte length, of its k and of the payloads (csrc/rice.cu decode_kernel)
TABLE_HEAD = 3


def rice_decode_cuda(coded: Tensor, table: np.ndarray, nblocks: int) -> Tensor:
    """Launch ``csrc/rice.cu`` ``rice_decode`` once over the ``nblocks``
    Rice blocks of the bands that ``table`` describes (as
    :func:`stage_bands` makes it), from ``coded``, their staged bytes on
    the card (uint8).  Replaces the reference's ``_decode_chunk`` scan (no
    TPU kernel) for every band at once.  Returns (nblocks *
    BLOCK_VALUES,) int32: band ``b``'s values from ``BLOCK_VALUES`` times
    its first block."""
    dev = _build.check_tensors("rice_decode", [coded], (torch.uint8,))
    if nblocks < 1:
        raise ValueError("rice_decode: needs at least one block (nothing to launch)")
    out = torch.empty(nblocks * BLOCK_VALUES, dtype=torch.int32, device=coded.device)
    work = torch.empty(nblocks + 1 + len(table), dtype=torch.int64, device=coded.device)
    _build.launch("rice", "repro_rice_decode", dev, (coded, out, work), (nblocks,), table)
    _backend.launches.bump("rice_decode")
    return out


def split_tables(raw: np.ndarray, nbands: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The encode kernel's tables as host bytes -> (each band's first
    byte offset in the payload and the total, int64 (nbands + 1); each
    block's k, uint8; each block's byte length, uint16)."""
    nb = (raw.size - 8 * (nbands + 1)) // 3
    offs = np.frombuffer(raw, np.int64, nbands + 1)
    lens = np.frombuffer(raw, np.uint16, nb, 8 * (nbands + 1))
    ks = np.frombuffer(raw, np.uint8, nb, 8 * (nbands + 1) + 2 * nb)
    return offs, ks, lens


def tables_to_host(tables: Tensor, nbands: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One copy of the encode kernel's tables to the host: see
    :func:`split_tables`."""
    with _build.device_errors("rice tables to host"):
        return split_tables(tables.cpu().numpy(), nbands)


def payload_to_host(payload: Tensor, total: int) -> np.ndarray:
    """One copy of the payload's first ``total`` bytes to the host,
    through a pinned staging buffer."""
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    with _build.device_errors("rice payload to host"):
        host.copy_(payload[:total])
    return host.numpy()


def split_bands(raw: np.ndarray, offs: np.ndarray, ks: np.ndarray, lens: np.ndarray,
                counts: Sequence[int]) -> List[Coded]:
    """Host payload bytes and tables -> each band's ``(payload, k_table,
    byte_lengths)``, the bands' value counts giving their blocks."""
    firsts = np.concatenate([[0], np.cumsum([n_blocks(c) for c in counts])])
    return [
        (raw[offs[i] : offs[i + 1]].tobytes(), ks[firsts[i] : firsts[i + 1]].copy(),
         lens[firsts[i] : firsts[i + 1]].copy())
        for i in range(len(counts))
    ]


def encode_bands_cuda(flats: Sequence[Tensor]) -> List[Coded]:
    """:func:`encode_bands` on flat int32 CUDA bands of one device, none
    empty: one launch, one copy of the tables to the host, then one copy
    of exactly the payload's bytes.  A kernel fault that surfaces at a
    copy to the host raises ``KernelLaunchError``."""
    payload, tables = rice_encode_cuda(flats)
    offs, ks, lens = tables_to_host(tables, len(flats))
    raw = payload_to_host(payload, int(offs[-1]))
    return split_bands(raw, offs, ks, lens, [f.numel() for f in flats])


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


def encode_bands(bands: Sequence) -> List[Coded]:
    """Rice-encode flat integer bands where they live, in order.

    Returns one ``(payload, k_table, byte_lengths)`` per band — the
    byte-aligned concatenated block bitstreams plus the per-block Rice
    parameters (uint8) and encoded byte counts (uint16) the container
    serialises, byte for byte the reference's.  The CUDA bands of a
    device take one launch for all of them (:func:`encode_bands_cuda`),
    CPU bands the plain version, empty bands nothing.
    """
    flats = [_flat_int32(b) for b in bands]
    out: List[Optional[Coded]] = [None] * len(flats)
    on_card: Dict[torch.device, List[int]] = {}
    for i, flat in enumerate(flats):
        if flat.numel() == 0:  # no block: nothing to launch
            out[i] = (b"", np.zeros(0, np.uint8), np.zeros(0, np.uint16))
        elif _backend.on_cuda(flat):
            on_card.setdefault(flat.device, []).append(i)
        else:
            out[i] = encode_band_plain(flat)
    for idx in on_card.values():
        for i, coded in zip(idx, encode_bands_cuda([flats[i] for i in idx])):
            out[i] = coded
    return out


def encode_band(x) -> Coded:
    """Rice-encode one flat integer band where it lives:
    ``encode_bands([x])[0]``."""
    return encode_bands([x])[0]


class Checked(NamedTuple):
    """A band's coding whose tables passed the host checks
    (:func:`check_band`): k and byte lengths as int64 ndarrays."""

    payload: object  # bytes-like
    ks: np.ndarray
    lens: np.ndarray
    count: int


def check_band(payload, k_table, byte_lengths, count: int) -> Checked:
    """The reference's host checks on a band's tables, plus range checks
    on k and the byte lengths (what the decode kernel reads); raises
    ``ValueError``.  A band of no values is not checked, as the
    reference's ``decode_band`` does not check it."""
    if count == 0:
        return Checked(b"", np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
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
    if int(ks.max()) > K_MAX:
        raise ValueError(f"rice k table holds k={int(ks.max())} > K_MAX={K_MAX} (corrupt stream)")
    if int(ks.min()) < 0 or int(blens.min()) < 0 or int(blens.max()) > 0xFFFF:
        raise ValueError("rice tables hold a negative k, or a byte length outside 0..65535 "
                         "(corrupt stream)")
    return Checked(payload, ks, blens, count)


def stage_bands(bands: Sequence[Checked]) -> Tuple[Tensor, np.ndarray, int]:
    """Checked bands, none empty -> (their coded bytes staged in one host
    buffer, pinned where there is a card; the decode table; the blocks in
    all).  The buffer holds every block's uint16 byte length, then its
    uint8 k, then from a 16-byte boundary the bands' payloads back to
    back, and 16 bytes of room."""
    firsts = np.concatenate([[0], np.cumsum([len(b.ks) for b in bands])])
    nb = int(firsts[-1])
    pay_at = -(-3 * nb // 16) * 16
    host = torch.empty(pay_at + sum(len(b.payload) for b in bands) + 16, dtype=torch.uint8,
                       pin_memory=torch.cuda.is_available())
    raw = host.numpy()
    lens, ks = raw[: 2 * nb].view(np.uint16), raw[2 * nb : 3 * nb]
    at = pay_at
    for b, f0, f1 in zip(bands, firsts[:-1], firsts[1:]):
        lens[f0:f1] = b.lens
        ks[f0:f1] = b.ks
        raw[at : at + len(b.payload)] = np.frombuffer(b.payload, np.uint8)
        at += len(b.payload)
    table = np.concatenate([[0, 2 * nb, pay_at], firsts, [b.count for b in bands]])
    return host, table.astype(np.int64), nb


def decode_checked(bands: Sequence[Checked], device="cuda") -> List[Tensor]:
    """:func:`decode_bands` on bands that passed :func:`check_band`: on a
    CUDA device one copy of their staged bytes to the card and ONE launch
    for all of them, each band's flat int32 values a view of the one
    output; on the CPU the plain version, band by band."""
    dev = _backend.resolve_device(device)
    out: List[Optional[Tensor]] = [None] * len(bands)
    live = [i for i, b in enumerate(bands) if b.count]
    for i, b in enumerate(bands):
        if not b.count:
            out[i] = torch.zeros(0, dtype=torch.int32, device=dev)
        elif dev.type == "cpu":
            out[i] = decode_band_plain(b.payload, b.ks, b.lens, b.count)[: b.count]
    if dev.type == "cuda" and live:
        host, table, nb = stage_bands([bands[i] for i in live])
        coded = torch.empty(host.numel(), dtype=torch.uint8, device=dev)
        with _build.device_errors("rice coded bytes to the card"):
            coded.copy_(host, non_blocking=True)
        values = rice_decode_cuda(coded, table, nb)
        for i, first in zip(live, table[TABLE_HEAD:]):
            at = int(first) * BLOCK_VALUES
            out[i] = values[at : at + bands[i].count]
    return out


def decode_bands(items: Sequence, device="cuda") -> List[Tensor]:
    """Inverse of :func:`encode_bands`: each ``(payload, k_table,
    byte_lengths, count)`` -> its flat int32 tensor of ``count`` on
    ``device``.  Every band's tables are checked on the host first
    (:func:`check_band`; the first that fails raises ``ValueError``);
    then on the card one launch of the decode kernel decodes them all (the
    default; it raises without a card), on the CPU the plain version."""
    _backend.resolve_device(device)
    return decode_checked([check_band(*item) for item in items], device)


def decode_band(
    payload: bytes, k_table, byte_lengths, count: int, device="cuda"
) -> Tensor:
    """Inverse of :func:`encode_band` -> flat int32 tensor of ``count`` on
    ``device``: ``decode_bands([...])[0]``."""
    return decode_bands([(payload, k_table, byte_lengths, count)], device)[0]
