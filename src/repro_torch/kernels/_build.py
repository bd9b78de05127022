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

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from repro_torch.core import schemes as S

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCES = ("whole2d", "tiled2d")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the exported launchers (every one returns a cudaError_t)
_SIGNATURES = {
    "whole2d": {
        "repro_whole_fwd": [_I] + [_P] * 8 + [_I] * 7 + [_P, _I, _P],
        "repro_whole_inv": [_I] + [_P] * 8 + [_I] * 7 + [_P, _I, _P],
    },
    "tiled2d": {
        "repro_tiled_fwd": [_I] + [_P] * 5 + [_I] * 6 + [_P, _I, _P],
        "repro_tiled_inv": [_I] + [_P] * 5 + [_I] * 6 + [_P, _I, _P],
    },
}


class KernelBuildError(RuntimeError):
    """A kernel source failed to compile, or no ``nvcc`` was found."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a nonzero CUDA error code."""


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
    table: np.ndarray,
) -> None:
    """Call one exported launcher of ``csrc/<name>.cu`` on the current
    stream of ``device``: ``fn(device, *tensor pointers, *ints, table,
    len(table), stream)``.  Raises on a nonzero CUDA error code."""
    lib = library(name)
    rc = getattr(lib, fn)(
        device, *(_ptr(t) for t in tensors), *ints,
        table.ctypes.data_as(ctypes.c_void_p), len(table),
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
    )
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise KernelLaunchError(f"{fn}: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# Arguments.
# ---------------------------------------------------------------------------


def check_tensors(label: str, tensors: Sequence[torch.Tensor]) -> int:
    """Validate a kernel's tensor arguments; returns their CUDA device
    index.  Every tensor must be a contiguous int32 CUDA tensor on one
    device."""
    dev = None
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{label}: kernel wrapper needs int32, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"{label}: kernel wrapper needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{label}: kernel wrapper needs contiguous tensors")
        if dev is not None and t.device != dev:
            raise ValueError(f"{label}: tensors on {dev} and {t.device}")
        dev = t.device
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def cascade_table(scheme, mode: str, inverse: bool) -> np.ndarray:
    """The resolved steps of ``scheme`` as the kernels' int32 table (see
    ``csrc/lift2d.cuh`` parse_cascade): execution order, the inverse's
    reversed order and flipped signs applied, each weight as its NAF
    digits (a negative weight negates its digits)."""
    steps = S.resolved_steps(scheme, mode)
    out = [len(steps)]
    for st in reversed(steps) if inverse else steps:
        sign = -st.sign if inverse else st.sign
        out += [1 if st.kind == "predict" else 0, sign, st.shift, st.round_add, len(st.taps)]
        for off, w in st.taps:
            terms = S._naf(abs(w))
            out += [off, len(terms)]
            for t in terms:
                out += [abs(t).bit_length() - 1, int((t < 0) != (w < 0))]
    return np.asarray(out, np.int32)
