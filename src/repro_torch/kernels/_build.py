"""Build, load and call the hand-written CUDA kernels of the port.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, loaded through
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Builds happen at first use, from the sources in the checkout only, into
``build/repro_torch/`` at the repository root (listed in
``.gitignore``); a library's file name carries a hash of its sources
and flags, so an edited kernel is never served from a stale build.
:func:`build` compiles several sources at once, one ``nvcc`` process
each, started together.

Nothing here runs on import, so every module imports on a machine with
no ``nvcc`` and no card (where the tests run the plain versions).  A
missing ``nvcc``, a failed compile or a nonzero CUDA error code raises —
there is no fallback to the plain versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import schemes as S
from repro_torch.obs import NULL, tracer
from repro_torch.obs import _state as _obs

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCES = ("whole2d", "tiled2d", "rice", "lift1d", "whole3d", "slab3d", "filterbank")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signatures of the exported launchers (every one returns a cudaError_t)
_SIGNATURES = {
    "whole2d": {
        "repro_whole_fwd": [_I] + [_P] * 8 + [_I] * 7 + [_P, _I, _P],
        "repro_whole_inv": [_I] + [_P] * 8 + [_I] * 7 + [_P, _I, _P],
        "repro_rows_fwd": [_I] + [_P] * 4 + [_I] * 4 + [_P, _I, _P],
        "repro_rows_inv": [_I] + [_P] * 4 + [_I] * 4 + [_P, _I, _P],
        "repro_whole2d_cluster_fwd": [_I] + [_P] * 2 + [_I] * 5 + [_P, _I, _P],
        "repro_whole2d_cluster_inv": [_I] + [_P] * 2 + [_I] * 5 + [_P, _I, _P],
        "repro_whole2d_cluster_room": [_I, _I, _I, _P],
    },
    "tiled2d": {
        "repro_tiled_fwd": [_I] + [_P] * 5 + [_I] * 6 + [_P, _I, _P],
        "repro_tiled_inv": [_I] + [_P] * 5 + [_I] * 6 + [_P, _I, _P],
    },
    "rice": {
        "repro_rice_encode": [_I] + [_P] * 3 + [_L, _P, _I, _P],
        "repro_rice_decode": [_I] + [_P] * 3 + [_L, _P, _I, _P],
    },
    "lift1d": {
        "repro_lift1d_run_fwd": [_I] + [_P] * 2 + [_I] * 7 + [_P, _I, _P],
        "repro_lift1d_run_inv": [_I] + [_P] * 2 + [_I] * 7 + [_P, _I, _P],
    },
    "whole3d": {
        "repro_whole3d_fwd": [_I] + [_P] * 16 + [_I] * 9 + [_P, _I, _P],
        "repro_whole3d_inv": [_I] + [_P] * 16 + [_I] * 9 + [_P, _I, _P],
        "repro_whole3d_cluster_room": [_I, _I, _I, _P],
    },
    "slab3d": {
        "repro_slab3d_fwd": [_I] + [_P] * 16 + [_I] * 11 + [_P, _I, _P],
        "repro_slab3d_inv": [_I] + [_P] * 16 + [_I] * 11 + [_P, _I, _P],
    },
    "filterbank": {
        "repro_filterbank53_fwd_float": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    },
}


class KernelBuildError(RuntimeError):
    """A kernel source failed to compile, or no ``nvcc`` was found."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a nonzero CUDA error code, or a kernel's
    asynchronous fault surfaced at a later synchronisation."""


def is_kernel_fault(e: BaseException) -> bool:
    """True for a kernel build or launch error, and for the error torch
    raises when an asynchronous CUDA fault (illegal address, ...)
    surfaces at a synchronising call."""
    if isinstance(e, (KernelBuildError, KernelLaunchError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(e, accel)) or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e)
    )


@contextlib.contextmanager
def device_errors(label: str):
    """Re-raise a CUDA fault that surfaces inside the block (a copy to the
    host, a synchronisation) as :class:`KernelLaunchError`."""
    try:
        yield
    except RuntimeError as e:
        if is_kernel_fault(e) and not isinstance(e, (KernelBuildError, KernelLaunchError)):
            raise KernelLaunchError(f"{label}: {e}") from e
        raise


_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are built from csrc/ at first use"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that have no current library, all in
    parallel.  Returns the seconds each compile took (0.0 when already
    built).  Raises :class:`KernelBuildError` with the compiler's output
    on the first failure."""
    names = list(names)
    for name in names:
        if name not in _SIGNATURES:
            raise ValueError(f"unknown kernel source {name!r}; have {SOURCES}")
    todo = [n for n in names if not library_path(n).exists()]
    times = {n: 0.0 for n in names}
    if not todo:
        return times
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures: List[str] = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return times


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) of the current build of ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        lib.repro_error_string.argtypes = [_I]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(
    name: str, fn: str, device: int, tensors: Sequence, ints: Sequence[int],
    table: Optional[np.ndarray] = None,
) -> None:
    """Call one exported launcher of ``csrc/<name>.cu`` on the current
    stream of ``device``: ``fn(device, *tensor pointers, *ints, [table,
    len(table),] stream)`` — the scheme table only where one is given; a
    pointer argument may be a tensor, None or a device address (int).
    Raises on a nonzero CUDA error code."""
    extra = () if table is None else (table.ctypes.data, len(table))
    call(name, fn, (device, *(_ptr(t) for t in tensors), *ints, *extra,
                    current_stream_handle(device)))


def call(name: str, fn: str, args: Sequence) -> None:
    """Call one exported launcher of ``csrc/<name>.cu`` with its whole
    argument list ready (addresses as ints, ctypes objects), for a caller
    that builds the fixed part once per shape.  Raises on a nonzero CUDA
    error code.  Inside ``obs.tracing("kernels")`` the call is the span
    ``kernels.launch`` (``fn``): the launcher's host time, the CUDA
    runtime's launch calls among it."""
    lib = library(name)
    with tracer.record("kernels.launch", "kernels", fn=fn) if _obs.kernels else NULL:
        rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise KernelLaunchError(f"{fn}: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# Arguments.
# ---------------------------------------------------------------------------


def check_tensors(
    label: str, tensors: Sequence[torch.Tensor], dtypes: Sequence[torch.dtype] = (torch.int32,)
) -> int:
    """Validate a kernel's tensor arguments; returns their CUDA device
    index.  Every tensor must be a contiguous CUDA tensor on one device,
    of a dtype in ``dtypes`` (int32 unless the caller says otherwise)."""
    dev = None
    for t in tensors:
        if t.dtype not in dtypes:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{label}: kernel wrapper needs {names}, got {t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"{label}: kernel wrapper needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{label}: kernel wrapper needs contiguous tensors")
        index = t.get_device()
        if dev is not None and index != dev:
            raise ValueError(f"{label}: tensors on cuda:{dev} and {t.device}")
        dev = index
    return dev


def _ptr(t) -> int:
    """A tensor's data pointer; an int is taken as a device address, None
    as a null pointer (the launchers' ``argtypes`` make each a pointer)."""
    if t is None or isinstance(t, int):
        return t or 0
    return t.data_ptr()


# the current stream's handle without building a torch.cuda.Stream object
# on every launch (host time a small level's kernel does not hide); the
# public call where this build of torch lacks the raw accessor
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream_handle(device: int) -> int:
    """The ``cudaStream_t`` of the current stream of CUDA ``device``."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device)
    return torch.cuda.current_stream(device).cuda_stream


def cascade_table(scheme, mode: str, inverse: bool) -> np.ndarray:
    """The resolved steps of ``scheme`` as the kernels' int32 table (see
    ``csrc/lift2d.cuh`` parse_cascade): execution order, the inverse's
    reversed order and flipped signs applied, each weight as its NAF
    digits (a negative weight negates its digits).  Read-only, built once
    per scheme, mode and direction."""
    return _cascade_table(S.get_scheme(scheme), mode, inverse)


@functools.lru_cache(maxsize=64)
def _cascade_table(sch, mode: str, inverse: bool) -> np.ndarray:
    steps = S.resolved_steps(sch, mode)
    out = [len(steps)]
    for st in reversed(steps) if inverse else steps:
        sign = -st.sign if inverse else st.sign
        out += [1 if st.kind == "predict" else 0, sign, st.shift, st.round_add, len(st.taps)]
        for off, w in st.taps:
            terms = S._naf(abs(w))
            out += [off, len(terms)]
            for t in terms:
                out += [abs(t).bit_length() - 1, int((t < 0) != (w < 0))]
    table = np.asarray(out, np.int32)
    table.flags.writeable = False
    return table
