"""Where the time of one depth-slab 3-D level goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/slab3d_anatomy.py [--json-out PATH]

Builds ``src/repro_torch/csrc/slab3d.cu`` as it is and in variants with
parts of its work cut out, into ``build/slab3d_anatomy/`` (the cut
variants compute wrong bands: they only time), and runs each on level 1
of one 4 x (64, 512, 512) cdf53 / jpeg2000 batch, forward:

  as_is             the kernel as committed
  no_plane_cascade  the plane pass loads and stores only: its memory floor
  plane_rows_only   the plane pass without its H cascade
  plane_cols_only   the plane pass without its W cascade
  no_depth_cascade  the depth pass loads and stores only

Each line gives the CUDA-event median of the whole level (20 calls of the
C launcher, no Python wrapper) and each kernel's device ms
(``torch.profiler``).  Then the library calls on one (64, 512, 512)
volume, 4 levels, warm: host clock around ``kernels.dwt_fwd_nd`` /
``dwt_inv_nd`` with a device sync, 10 calls each, sorted.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FWD_CASCADES = "  cascade_rows(win, rows, W, c);\n  cascade_cols_ext(win, W, W, rows / 2, c);\n"
DEPTH_CASCADE = "    cascade_cols_ext(win, cw, ncol, depth / 2, c);\n"


def variants(source: str) -> dict:
    for cut in (FWD_CASCADES, DEPTH_CASCADE):
        if cut not in source:
            raise SystemExit(f"slab3d.cu no longer holds {cut.strip()!r}: update this tool")
    return {
        "as_is": source,
        "no_plane_cascade": source.replace(FWD_CASCADES, ""),
        "plane_rows_only": source.replace(FWD_CASCADES, "  cascade_rows(win, rows, W, c);\n"),
        "plane_cols_only": source.replace(FWD_CASCADES,
                                          "  cascade_cols_ext(win, W, W, rows / 2, c);\n"),
        "no_depth_cascade": source.replace(DEPTH_CASCADE, ""),
    }


def build(out: pathlib.Path, texts: dict) -> dict:
    from repro_torch.kernels import _build

    csrc = _build.CSRC
    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "slab3d.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
             str(d / "slab3d.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for fn, argtypes in _build._SIGNATURES["slab3d"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("slab3d_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch import kernels as K
    from repro_torch.core import schemes as S
    from repro_torch.kernels import _build
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import fused3d as F3

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(card, flush=True)
    libs = build(ROOT / "build" / "slab3d_anatomy",
                 variants((_build.CSRC / "slab3d.cu").read_text()))
    rng = np.random.default_rng(0)
    x = torch.cat([CS.phantom(rng, CS.VOLUME, dev, 20)[None] for _ in range(CS.VOL_SLOTS)])
    bsz, d, h, w = x.shape
    sch = S.get_scheme(CS.VOL_SCHEME)
    td = B.pick_slab(d, h, w, sch.halo, dev)
    g = F3.slab_geometry(bsz, d, h, w, td, sch, False, dev)
    table = _build.cascade_table(sch, CS.VOL_MODE, False)
    want = F3.fwd3d_slab_cuda(x, CS.VOL_MODE, td, sch)
    record = {"card": card, "shape": list(x.shape), "td": td, "geometry": g, "variants": {}}
    for name, lib in libs.items():
        bands = [x.new_empty((bsz,) + dim) for dim in F3._band_dims_3d(d, h, w)]
        _planes, sw, dw, t, scratch = F3._slab_buffers(x, g, bsz, d, h, w)
        argv = [0, *(_build._ptr(a) for a in (x, sw, dw, *t, *bands, scratch)),
                *F3._slab_args(g, bsz, d, h, w, td), table.ctypes.data_as(ctypes.c_void_p),
                len(table), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)]

        def run(lib=lib, argv=argv):
            if lib.repro_slab3d_fwd(*argv):
                raise RuntimeError(f"{name}: launch failed")

        run()
        torch.cuda.synchronize(dev)
        exact = all(torch.equal(a, b) for a, b in zip(bands, want))
        ms, by_kernel = CS._median_ms(run, 20), CS._pass_ms(run)
        record["variants"][name] = {"ms": ms, "by_kernel": by_kernel, "bands_exact": exact}
        print(f"{name}: level 1 {ms:.4f} ms (bands exact: {exact}); by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()), flush=True)
    x1 = x[:1].contiguous()
    kw = dict(mode=CS.VOL_MODE, scheme=CS.VOL_SCHEME)
    pyr = K.dwt_fwd_nd(x1, levels=CS.VOL_LEVELS, **kw)
    for label, fn in (("dwt_fwd_nd", lambda: K.dwt_fwd_nd(x1, levels=CS.VOL_LEVELS, **kw)),
                      ("dwt_inv_nd", lambda: K.dwt_inv_nd(pyr, **kw))):
        fn()
        times = []
        for _ in range(10):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        record[label] = sorted(times)
        print(f"{label} one volume, {CS.VOL_LEVELS} levels, warm: median "
              f"{statistics.median(times):.3f} ms of {[round(v, 3) for v in sorted(times)]}")
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
