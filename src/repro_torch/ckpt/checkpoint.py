"""Checkpointing: atomic, per-leaf shards, keep-k, integrity manifest,
optional wavelet compression, async save.

Port of ``repro.ckpt.checkpoint``; the files on disk are the reference's,
byte for byte, so a checkpoint written by either package restores in the
other.

Layout:
    <dir>/step_<N>/
        manifest.json        {leaf_path: {file, sha256, shape, dtype, codec}}
        <leaf>.bin           raw | zlib | wavelet payloads
    <dir>/LATEST             atomic pointer file (written last)

Codecs:
    raw  — the leaf's bytes (bfloat16 as its 2-byte patterns)
    z    — zlib(raw)                                (lossless, default)
    wz   — zlib(int-DWT(int16-quantized tensor))    (lossy; per-tensor
           max-abs scale in the manifest; the integer DWT is lossless,
           only the quantization loses precision, bounded by scale/2)
    wz2d — like wz, but matrix-shaped leaves run the multi-level 2-D
           Mallat pyramid (leading dims batched); vectors fall back to
           the 1-D wz encoding per leaf
    wz3d — like wz2d, but volume-shaped leaves (ndim >= 3, the three
           trailing dims >= 4) run the multi-level 3-D pyramid; each leaf
           records its encoding in the manifest meta
    wz-rice — shape-routed like wz3d, but the entropy coder is the Rice
           container (``repro_torch.codec``, WZRC v2 with per-band CRCs
           and, by default, an XOR parity group) instead of zlib'd int16
           band packs: quantization always to the FULL int16 range, the
           pyramid depth capped by the scheme's derived certificate

Where the work runs: a leaf is quantized and transformed on the device it
lives on (a CUDA leaf through the hand-written kernels, the Rice coder
included); only the int16 payload (or the Rice container) crosses to the
host for zlib, sha256 and the write.  Restore decodes on the manager's
``device`` (the card by default) and returns tensors there.
``save()`` snapshots every leaf (a clone on its own device) before it
returns, so an optimizer changing the parameters in place after an async
``save()`` does not change what is written.

Fault-tolerance contract: a crash at ANY point leaves either the previous
LATEST intact or a fully-written new step (manifest written before
LATEST, LATEST update an atomic rename; payloads, manifest and step
directory fsynced before the rename).  A dangling LATEST falls back to a
scan for the newest complete step.  The save path carries the
``ckpt.save.*`` fault sites of ``repro_torch.resilience.inject``;
async-save exceptions re-raise from :meth:`CheckpointManager.wait`.

Self-healing restore: a ``wz-rice`` leaf whose sha256 fails but whose
container still yields a fully verified decode (per-band CRCs, parity)
is returned healed with a
:class:`~repro_torch.resilience.errors.DegradedRestoreWarning`;
unhealable damage raises
:class:`~repro_torch.resilience.errors.CheckpointIntegrityError`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from repro_torch import kernels as K
from repro_torch import obs
from repro_torch import tree as T
from repro_torch.core.compression import divide_f32
from repro_torch.kernels import backend
from repro_torch.resilience import inject
from repro_torch.resilience.errors import CheckpointIntegrityError, DegradedRestoreWarning

PyTree = Any

# wavelet-leaf encoding version, recorded per leaf in the manifest meta
# (the reference's numbers: 2 = wz-rice leaves carry WZRC v2 containers;
# the zlib wz family's payload is unchanged and still writes version 1)
ENC_VERSION = 2
_KNOWN_ENC_VERSIONS = (1, 2)
_WAVELET_CODECS = ("wz", "wz2d", "wz3d", "wz-rice")


# ---------------------------------------------------------------------------
# Leaves: names, dtypes, host bytes.
# ---------------------------------------------------------------------------


def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's dtype string: numpy's name (``"bfloat16"`` as
    ml_dtypes names it)."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint leaf dtype {name!r} has no torch counterpart")
    return dt


def _host_bytes(t: Tensor) -> bytes:
    """The leaf's bytes as numpy lays them out (bf16: 2-byte patterns)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().cpu().numpy().tobytes()


def _h2d(arr: np.ndarray, device) -> Tensor:
    """A copy of a host array on ``device`` (a restore's one crossing)."""
    return torch.from_numpy(arr.copy()).to(device)


def _from_bytes(buf: bytes, shape, dtype_name: str, device) -> Tensor:
    """Inverse of :func:`_host_bytes`: a new tensor on ``device``."""
    if dtype_name == "bfloat16":
        return _h2d(np.frombuffer(buf, dtype=np.int16), device).view(torch.bfloat16).reshape(shape)
    return _h2d(np.frombuffer(buf, dtype=np.dtype(dtype_name)), device).reshape(shape)


def tree_from_numpy(tree: PyTree, device="cuda") -> PyTree:
    """A nested dict/list tree of host arrays (the JAX package's state,
    bfloat16 included) as tensors on ``device``, same leaf names."""
    dev = backend.resolve_device(device)
    return T.map_leaves(lambda a: T.to_tensor(a).to(dev), tree)


def tree_to_numpy(tree: PyTree) -> PyTree:
    """Inverse of :func:`tree_from_numpy`: host arrays, same leaf names.
    A bfloat16 leaf comes back as its uint16 bit patterns (with ml_dtypes,
    ``.view(ml_dtypes.bfloat16)`` gives the values)."""

    def one(t: Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return T.map_leaves(one, tree)


# ---------------------------------------------------------------------------
# Encoders.  Each runs on the leaf's device up to the payload, which is
# the only thing copied to the host.
# ---------------------------------------------------------------------------


def _wz_quant_limit(heuristic: float, scheme: str, levels: int, ndim: int) -> float:
    """Quantization limit for an int16-packed wavelet leaf: the ``32767 >>
    k`` headroom heuristic, clamped to the scheme's derived safe input
    magnitude (``ranges.band_safe_input``), as the reference."""
    from repro_torch.core import ranges

    derived = ranges.band_safe_input(scheme, levels, 32767, mode="paper", ndim=ndim)
    return float(min(heuristic, max(derived, 1)))


def _quantize_for_wz(x: Tensor, lim: float) -> Tuple[Tensor, float]:
    """The reference's numpy rule, on ``x``'s device: ``scale`` a Python
    float (``amax / lim`` in float64), the division float32 with the scale
    rounded to float32 (NEP 50), round half to even, clip, then int32."""
    xf = x.to(torch.float32)
    scale = (float(xf.abs().max()) or 1.0) / lim
    scale = max(scale, 1e-12)
    q = torch.clamp(torch.round(divide_f32(xf, scale)), -lim, lim)
    return q.to(torch.int32), scale


def _wavelet_route(shape, want_3d: bool) -> str:
    """Which pyramid a leaf's shape supports: "3d" | "2d" | "1d" — THE
    shape-routing rule of every shape-routed wavelet codec."""
    if want_3d and len(shape) >= 3 and all(n >= 4 for n in shape[-3:]):
        return "3d"
    if len(shape) >= 2 and shape[-1] >= 4 and shape[-2] >= 4:
        return "2d"
    return "1d"


def _pad_to_levels(flat: Tensor, levels: int) -> Tensor:
    """Zero-pad a flat signal to a multiple of 2**levels (1-D encoders)."""
    pad = (-flat.shape[0]) % (1 << levels)
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def _pyramid(q: Tensor, enc: str, levels: int, scheme: str):
    """The integer pyramid of a wavelet leaf on its route: over the three
    trailing dims or the two (leading dims batched), or over the leaf
    flattened and zero-padded to a multiple of 2**levels."""
    if enc == "3d":
        d, h, w = q.shape[-3:]
        return K.dwt_fwd_nd(q.reshape(-1, d, h, w), levels=levels, scheme=scheme, ndim=3)
    if enc == "2d":
        h, w = q.shape[-2:]
        return K.dwt_fwd_2d_multi(q.reshape(-1, h, w), levels=levels, scheme=scheme)
    flat = _pad_to_levels(q.reshape(-1), levels)
    return K.dwt_fwd(flat[None], levels=levels, scheme=scheme)


def _band_pack(pyr, enc: str) -> Tensor:
    """A zlib-family pyramid's bands as one int16 tensor."""
    if enc == "3d":
        return K.pack_nd(pyr).to(torch.int16)
    if enc == "2d":
        return K.pack2d(pyr).to(torch.int16)
    return K.pack(pyr)[0].to(torch.int16)


def _zlib_wavelet(x: Tensor, enc: str, levels: int, heuristic: int,
                  scheme: str) -> Tuple[bytes, float]:
    """(payload, scale) of a zlib-family leaf: quantize to the limit,
    transform, pack to int16 on the leaf's device; then host, zlib level 1."""
    lim = _wz_quant_limit(float(heuristic), scheme, levels, int(enc[0]))
    q, scale = _quantize_for_wz(x, lim)
    packed = _band_pack(_pyramid(q, enc, levels, scheme), enc)
    return zlib.compress(_host_bytes(packed), level=1), scale


def _encode_wz(x: Tensor, wavelet_levels: int, scheme: str = "cdf53") -> Tuple[bytes, Dict]:
    # 1-D headroom: bands grow ~1 bit a level (clamped by the certificate)
    data, scale = _zlib_wavelet(x, "1d", wavelet_levels, 32767 >> (wavelet_levels + 1), scheme)
    meta = {
        "scale": scale,
        "padded_len": x.numel() + (-x.numel()) % (1 << wavelet_levels),
        "levels": wavelet_levels,
        "scheme": scheme,
    }
    return data, meta


def _wz2d_levels(h: int, w: int, levels: int) -> int:
    """Deepest level count <= ``levels`` the (h, w) slice supports, capped
    at 3 by int16 headroom (limit ``32767 >> (2*levels + 1)``)."""
    return max(1, min(levels, 3, K.max_levels_2d(h, w)))


def _encode_wz2d(x: Tensor, wavelet_levels: int, scheme: str = "cdf53") -> Tuple[bytes, Dict]:
    """2-D Mallat-pyramid codec for matrix-shaped leaves."""
    levels = _wz2d_levels(x.shape[-2], x.shape[-1], wavelet_levels)
    # 2-D headroom: ~1 bit per level per axis (clamped by the certificate)
    data, scale = _zlib_wavelet(x, "2d", levels, 32767 >> (2 * levels + 1), scheme)
    return data, {"scale": scale, "levels": levels, "enc": "2d", "scheme": scheme}


def _wz3d_levels(d: int, h: int, w: int, levels: int) -> int:
    """Deepest level count <= ``levels`` the (d, h, w) volume supports,
    capped at 2 by int16 headroom (limit ``32767 >> (3*levels + 1)``)."""
    return max(1, min(levels, 2, K.max_levels_nd((d, h, w))))


def _encode_wz3d(x: Tensor, wavelet_levels: int, scheme: str = "cdf53") -> Tuple[bytes, Dict]:
    """3-D Mallat-pyramid codec for volume-shaped leaves."""
    levels = _wz3d_levels(*x.shape[-3:], wavelet_levels)
    # 3-D headroom: ~1 bit per level per axis (clamped by the certificate)
    data, scale = _zlib_wavelet(x, "3d", levels, 32767 >> (3 * levels + 1), scheme)
    return data, {"scale": scale, "levels": levels, "enc": "3d", "scheme": scheme}


def _cert_cap(scheme: str, nd: int) -> int:
    """Deepest cascade the scheme's derived certificate admits for
    +-32767 int32 samples (wz-rice quantizes to the full int16 range, so
    it caps the depth instead of shifting the limit)."""
    from repro_torch.core import ranges

    return max(1, ranges.certified_levels(
        scheme, np.int32, (-32767, 32767), mode="paper", ndim=nd))


def _wzrice_plan(shape, wavelet_levels: int, scheme: str) -> Tuple[str, int]:
    """(route, levels) of a wz-rice leaf."""
    enc = _wavelet_route(shape, want_3d=True)
    if enc == "3d":
        deepest = K.max_levels_nd(tuple(shape[-3:]))
    elif enc == "2d":
        deepest = K.max_levels_2d(shape[-2], shape[-1])
    else:
        deepest = K.max_levels(max(math.prod(shape), 2))
    return enc, max(1, min(wavelet_levels, deepest, _cert_cap(scheme, int(enc[0]))))


def _encode_wzrice(x: Tensor, wavelet_levels: int, scheme: str = "cdf53",
                   parity: bool = True) -> Tuple[bytes, Dict]:
    """Rice-container codec: quantize, DWT, WZRC bitstream (no zlib)."""
    from repro_torch.codec import container

    enc, levels = _wzrice_plan(tuple(x.shape), wavelet_levels, scheme)
    q, scale = _quantize_for_wz(x, 32767.0)
    data = container.encode_pyramid(_pyramid(q, enc, levels, scheme), scheme=scheme,
                                    ndim=3 if enc == "3d" else None, parity=parity)
    meta = {
        "scale": scale, "levels": levels, "enc": enc, "scheme": scheme,
        "parity": bool(parity),
    }
    return data, meta


def _encode(x: Tensor, codec: str, wavelet_levels: int, scheme: str = "cdf53",
            parity: bool = True) -> Tuple[bytes, Dict]:
    meta: Dict[str, Any] = {}
    if codec == "raw":
        return _host_bytes(x), meta
    if codec == "z":
        return zlib.compress(_host_bytes(x), level=1), meta
    if codec == "wz":
        data, meta = _encode_wz(x, wavelet_levels, scheme)
    elif codec == "wz-rice":
        data, meta = _encode_wzrice(x, wavelet_levels, scheme, parity)
    elif codec in ("wz2d", "wz3d"):
        route = _wavelet_route(tuple(x.shape), want_3d=(codec == "wz3d"))
        if route == "3d":
            data, meta = _encode_wz3d(x, wavelet_levels, scheme)
        elif route == "2d":
            data, meta = _encode_wz2d(x, wavelet_levels, scheme)
        else:
            data, meta = _encode_wz(x, wavelet_levels, scheme)  # vectors: 1-D
            meta["enc"] = "1d"
    else:
        raise ValueError(codec)
    # the zlib wz family's payload is unchanged since version 1; only the
    # wz-rice container moved to the v2 layout
    meta["enc_version"] = ENC_VERSION if codec == "wz-rice" else 1
    return data, meta


# ---------------------------------------------------------------------------
# Decoders: each returns a tensor on ``device``.
# ---------------------------------------------------------------------------


def _unpacked_int32(data: bytes, device) -> Tensor:
    """zlib'd int16 band pack -> int32 tensor on ``device`` (the int16
    crosses, the widening runs there)."""
    return _h2d(np.frombuffer(zlib.decompress(data), dtype=np.int16), device).to(torch.int32)


def _unpyramid(flat: Tensor, shape, meta: Dict) -> Tensor:
    """A zlib-family leaf's int32 samples from its band pack, on the route
    its meta records (``wz`` leaves record none: 1-D)."""
    scheme, levels = meta.get("scheme", "cdf53"), meta["levels"]
    if meta.get("enc") == "3d":
        pyr = K.unpack_nd(flat.reshape(math.prod(shape[:-3]), -1), tuple(shape[-3:]), levels)
        return K.dwt_inv_nd(pyr, scheme=scheme)
    if meta.get("enc") == "2d":
        pyr = K.unpack2d(flat.reshape(math.prod(shape[:-2]), -1), shape[-2], shape[-1], levels)
        return K.dwt_inv_2d_multi(pyr, scheme=scheme)
    pyr = K.unpack(flat[None], meta["padded_len"], levels)
    return K.dwt_inv(pyr, scheme=scheme)[0]


def _dequantized(x: Tensor, shape, dtype_name: str, scale: float) -> Tensor:
    """``x[:count] * scale`` in float32 (the scale rounded to float32, as
    numpy's rule), reshaped, cast to the leaf's dtype (round to nearest
    even for bfloat16)."""
    vals = x.reshape(-1)[: math.prod(shape)].to(torch.float32) * scale
    return vals.reshape(tuple(shape)).to(_torch_dtype(dtype_name))


def _decode_wzrice(data: bytes, shape, dtype_name: str, meta: Dict, device) -> Tensor:
    from repro_torch.codec import container

    x = container.inverse_transform(container.decode_pyramid(data, device=device))
    return _dequantized(x, shape, dtype_name, meta["scale"])


def _decode(data: bytes, shape, dtype_name: str, codec: str, meta: Dict, device) -> Tensor:
    if codec in ("raw", "z"):
        if codec == "z":
            data = zlib.decompress(data)
        return _from_bytes(data, tuple(shape), dtype_name, device)
    if codec in _WAVELET_CODECS:
        # manifests written before enc_version existed carry version-1
        # payloads; anything newer than this build knows must fail loudly
        version = meta.get("enc_version", 1)
        if version not in _KNOWN_ENC_VERSIONS:
            raise ValueError(
                f"checkpoint leaf uses {codec!r} enc_version {version}; this "
                f"build supports versions {_KNOWN_ENC_VERSIONS} — restore "
                "with the build that wrote the checkpoint"
            )
    if codec == "wz-rice":
        return _decode_wzrice(data, shape, dtype_name, meta, device)
    if codec in ("wz", "wz2d", "wz3d"):
        x = _unpyramid(_unpacked_int32(data, device), shape, meta)
        return _dequantized(x, shape, dtype_name, meta["scale"])
    raise ValueError(codec)


def _write_file_synced(path: Path, data: bytes) -> None:
    """Write bytes and fsync so the payload is durable before the step
    directory's commit rename can make it reachable."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _snapshot(tree: PyTree) -> List[Tuple[str, Tensor]]:
    """(name, private copy) of every leaf: a contiguous clone on the leaf's
    own device, enqueued on its current stream before anything the caller
    enqueues there afterwards, or a new CPU tensor for host arrays and
    numbers."""
    out = []
    for name, leaf in T.leaf_paths(tree):
        t = T.to_tensor(leaf)
        if t is leaf:
            t = leaf.detach().clone(memory_format=torch.contiguous_format)
        out.append((name, t))
    return out


def _clones_written(leaves) -> Dict[torch.device, Any]:
    """One event per CUDA device, recorded on the caller's stream after
    the snapshot's clones."""
    events = {}
    for _, t in leaves:
        if t.is_cuda and t.device not in events:
            events[t.device] = torch.cuda.Event()
            events[t.device].record(torch.cuda.current_stream(t.device))
    return events


def _read_clones_here(leaves, events) -> None:
    """Order the snapshot's clones before this thread's streams (an async
    save encodes on its own thread's stream, not the caller's) and keep
    their memory from reuse until this stream's work on them is done."""
    for _, t in leaves:
        if t.is_cuda:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(events[t.device])
            t.record_stream(stream)


@dataclasses.dataclass
class CheckpointManager:
    directory: str | Path
    keep: int = 3
    codec: str = "z"  # raw | z | wz | wz2d | wz3d | wz-rice
    wavelet_levels: int = 2
    wavelet_scheme: str = "cdf53"  # lifting scheme for the wz family
    parity: bool = True  # wz-rice leaves: write the XOR parity group
    host_id: int = 0
    n_hosts: int = 1
    device: Any = "cuda"  # where restored leaves are decoded and put

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.device = backend.resolve_device(self.device)
        self._save_thread: Optional[threading.Thread] = None
        self._save_exc: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: PyTree, blocking: bool = True) -> None:
        """Write ``tree`` as step ``step``.  Every leaf is copied before
        this returns (blocking or not)."""
        if not blocking:
            self.wait()  # one async save in flight at a time
        leaves = _snapshot(tree)
        if blocking:
            self._save_impl(step, leaves)
        else:
            self._save_thread = threading.Thread(
                target=self._save_async, args=(step, leaves, _clones_written(leaves)),
                daemon=True,
            )
            self._save_thread.start()

    def _save_async(self, step: int, leaves, events) -> None:
        try:
            _read_clones_here(leaves, events)
            self._save_impl(step, leaves)
        except BaseException as e:  # surfaced from wait(), not swallowed
            self._save_exc = e

    def wait(self) -> None:
        """Join any in-flight async save; re-raise its failure here."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        exc, self._save_exc = self._save_exc, None
        if exc is not None:
            raise exc

    def _save_impl(self, step: int, leaves) -> None:
        t0 = time.perf_counter()
        with obs.span("ckpt.save", subsystem="ckpt", step=step):
            self._save_inner(step, leaves)
        obs.counter("ckpt.saves").inc()
        obs.histogram("ckpt.save_ms").observe((time.perf_counter() - t0) * 1e3)

    def _save_inner(self, step: int, leaves) -> None:
        step_dir = self.directory / f"step_{step:010d}"
        tmp_dir = self.directory / f".tmp_step_{step:010d}_{self.host_id}"
        if tmp_dir.exists():
            shutil.rmtree(tmp_dir)
        tmp_dir.mkdir(parents=True)
        try:
            inject.check("ckpt.save.before_write")
            manifest: Dict[str, Dict] = {}
            for name, t in leaves:
                inject.check("ckpt.save.mid_write")
                data, meta = _encode(
                    t, self.codec, self.wavelet_levels, self.wavelet_scheme, self.parity,
                )
                fname = name.replace("/", "__") + ".bin"
                _write_file_synced(tmp_dir / fname, data)
                manifest[name] = {
                    "file": fname,
                    "sha256": hashlib.sha256(data).hexdigest(),
                    "shape": list(t.shape),
                    "dtype": _dtype_name(t.dtype),
                    "codec": self.codec,
                    "meta": meta,
                    "raw_bytes": t.numel() * t.element_size(),
                    "stored_bytes": len(data),
                }
            _write_file_synced(
                tmp_dir / "manifest.json",
                json.dumps({"step": step, "leaves": manifest}).encode(),
            )
            _fsync_dir(tmp_dir)
            inject.check("ckpt.save.before_commit")
        except BaseException:
            # a crashed save leaves no trace a reader could mistake for a step
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        if step_dir.exists():
            shutil.rmtree(step_dir)
        os.replace(tmp_dir, step_dir)  # atomic on same filesystem
        _fsync_dir(self.directory)  # the rename itself is now durable
        inject.check("ckpt.save.before_latest")
        latest_tmp = self.directory / ".LATEST.tmp"
        latest_tmp.write_text(step_dir.name)
        os.replace(latest_tmp, self.directory / "LATEST")
        _fsync_dir(self.directory)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.directory.glob("step_*"))
        for old in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(old, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        """Newest COMPLETE step on disk.  LATEST is a hint: a crash between
        the step commit and the pointer update leaves a valid newer step
        it does not name, which the scan finds; a step directory without
        its manifest is never eligible."""
        best: Optional[int] = None
        latest = self.directory / "LATEST"
        if latest.exists():
            name = latest.read_text().strip()
            if (self.directory / name / "manifest.json").exists():
                best = int(name.split("_")[1])
        for cand in sorted(self.directory.glob("step_*"), reverse=True):
            if (cand / "manifest.json").exists():
                n = int(cand.name.split("_")[1])
                if best is None or n > best:
                    best = n
                break  # sorted newest-first: the first complete dir wins
        return best

    def _decode_leaf(self, data: bytes, m: Dict) -> Tensor:
        return _decode(data, tuple(m["shape"]), m["dtype"], m["codec"], m["meta"], self.device)

    def _integrity_error(self, name: str, step: int, msg: str) -> CheckpointIntegrityError:
        obs.counter("ckpt.integrity_failures").inc()
        obs.emit(obs.FaultEvent(
            subsystem="ckpt", error="CheckpointIntegrityError",
            site="ckpt.restore", detail=f"leaf {name} step {step}",
        ))
        return CheckpointIntegrityError(msg)

    def _restore_leaf(self, name: str, step: int, data: bytes, m: Dict) -> Tensor:
        if hashlib.sha256(data).hexdigest() == m["sha256"]:
            return self._decode_leaf(data, m)
        # whole-file hash failed; a wz-rice leaf's per-band CRCs + parity
        # can still certify (or reconstruct) every band — a verified
        # decode is bit-identical to what the sha256 protected
        if m["codec"] != "wz-rice":
            raise self._integrity_error(name, step, f"checksum mismatch for {name} in step {step}")
        try:
            healed = self._decode_leaf(data, m)
        except Exception as e:
            raise self._integrity_error(
                name, step, f"checksum mismatch for {name} in step {step} "
                f"(container could not self-heal: {e})") from e
        obs.counter("ckpt.heals").inc()
        obs.warn_event(
            obs.HealEvent(
                subsystem="ckpt", mechanism="parity",
                detail=f"leaf {name} step {step} healed past a bad sha256",
            ),
            DegradedRestoreWarning(
                f"leaf {name} in step {step} failed its sha256 but "
                "decoded via the container's per-band CRC/parity path"
            ),
            stacklevel=3,
        )
        return healed

    def restore(self, step: Optional[int] = None,
                template: Optional[PyTree] = None) -> Tuple[int, PyTree]:
        """(step, leaves): a ``{name: tensor}`` dict, or ``template``'s
        structure, every tensor on the manager's ``device``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        step_dir = self.directory / f"step_{step:010d}"
        t0 = time.perf_counter()
        with obs.span("ckpt.restore", subsystem="ckpt", step=step):
            info = json.loads((step_dir / "manifest.json").read_text())
            leaves: Dict[str, Tensor] = {}
            for name, m in info["leaves"].items():
                data = (step_dir / m["file"]).read_bytes()
                leaves[name] = self._restore_leaf(name, step, data, m)
        obs.counter("ckpt.restores").inc()
        obs.histogram("ckpt.restore_ms").observe((time.perf_counter() - t0) * 1e3)
        if template is not None:
            return info["step"], T.unflatten(
                template, [leaves[n] for n, _ in T.leaf_paths(template)])
        return info["step"], leaves

    def compression_report(self, step: Optional[int] = None) -> Dict[str, float]:
        if step is None:
            step = self.latest_step()
        step_dir = self.directory / f"step_{step:010d}"
        info = json.loads((step_dir / "manifest.json").read_text())
        raw = sum(m["raw_bytes"] for m in info["leaves"].values())
        stored = sum(m["stored_bytes"] for m in info["leaves"].values())
        return {"raw_bytes": raw, "stored_bytes": stored, "ratio": raw / max(stored, 1)}
