"""Where the time of one halo-tiled 2-D level goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/tiled2d_anatomy.py [--json-out PATH]

Builds ``src/repro_torch/csrc/tiled2d.cu`` as it is and in variants with
parts of its work cut out, into ``build/tiled2d_anatomy/`` (the cut
variants compute wrong bands: they only time), and runs each on level 1
of one 8 x 2048^2 cdf53 / jpeg2000 batch (the serve route's largest
bucket), forward and inverse, at the default tile:

  as_is        the kernels as committed
  no_cascade   loads and stores only: the kernels' memory floor
  rows_only    without the column cascade
  cols_only    without the row cascade

Then the committed kernels at other tiles (forward and inverse, each
checked bit-equal against the plain version), with 4-byte loads and
stores forced (every pointer 4 bytes past a 16-byte boundary), and on
97m / paper, and the first line once more (the spread within one run).
Then each tiled level of the serve route's 8 x 2048^2 pyramid (2048^2
down to 256^2) at tiles from 128 x 128 to 32 x 32, and the Python
wrappers at the picked tile; last, the host's time per call (200 calls
enqueued back to back at the 8 x 256^2 level) of the C launchers, the
wrappers, four band allocations and one PyTorch kernel.  Each line gives the CUDA-event median of 20 calls of the C
launcher (no Python wrapper) and the kernel's device ms
(``torch.profiler``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FWD = ("  cascade_rows_ext<false>(win + a, cs, R, C / 2, 1, c);\n"
       "  cascade_cols_ext<true>(win + a + halo, cs, tw, R / 2, c);\n")
INV = ("  cascade_cols_ext<true>(win + a, cs, half + pc, pr, c);\n"
       "  cascade_rows_ext<true>(win + 2 * m * cs + a, cs, th, pc, half, c);\n")


def variants(source: str) -> dict:
    for cut in (FWD, INV):
        if cut not in source:
            raise SystemExit(f"tiled2d.cu no longer holds {cut.strip()!r}: update this tool")
    fwd_rows, fwd_cols = FWD.splitlines(keepends=True)
    inv_cols, inv_rows = INV.splitlines(keepends=True)
    return {
        "as_is": source,
        "no_cascade": source.replace(FWD, "").replace(INV, ""),
        "rows_only": source.replace(FWD, fwd_rows).replace(INV, inv_rows),
        "cols_only": source.replace(FWD, fwd_cols).replace(INV, inv_cols),
    }


def build(out: pathlib.Path, texts: dict) -> dict:
    from repro_torch.kernels import _build

    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "tiled2d.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
             str(d / "tiled2d.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        if name == "as_is":
            print("as_is build:\n  " + "\n  ".join(
                ln.split("'")[1] if "entry function" in ln else ln.strip()
                for ln in log.splitlines()
                if "entry function" in ln or "registers" in ln or "spill" in ln))
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for fn, argtypes in _build._SIGNATURES["tiled2d"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _shifted(t: torch.Tensor, shift: bool) -> torch.Tensor:
    """``t``, or a copy whose data starts 4 bytes past a 16-byte boundary."""
    if not shift:
        return t
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def level_calls(lib, x, bands, mode, th, tw, sch, shift=False):
    """(forward, inverse) closures calling the C launchers on one level,
    and the outputs they write."""
    from repro_torch.kernels import _build

    bsz, h, w = x.shape
    xi = _shifted(x, shift)
    outs = [_shifted(torch.empty_like(bd), shift) for bd in bands]
    ins = [_shifted(bd, shift) for bd in bands]
    xo = _shifted(torch.empty_like(x), shift)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ft, it = (_build.cascade_table(sch, mode, inverse=v) for v in (False, True))

    def fwd():
        rc = lib.repro_tiled_fwd(0, *(_build._ptr(a) for a in [xi] + outs), bsz, h, w, th, tw,
                                 sch.fwd_margin, ft.ctypes.data_as(ctypes.c_void_p), len(ft),
                                 stream)
        if rc:
            raise RuntimeError(f"repro_tiled_fwd: CUDA error {rc}")

    def inv():
        rc = lib.repro_tiled_inv(0, *(_build._ptr(a) for a in ins + [xo]), bsz, h, w, th, tw,
                                 sch.inv_margin, it.ctypes.data_as(ctypes.c_void_p), len(it),
                                 stream)
        if rc:
            raise RuntimeError(f"repro_tiled_inv: CUDA error {rc}")

    return fwd, inv, outs, xo


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tiled2d_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.core import schemes as S
    from repro_torch.kernels import _build
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import fused2d as F
    from repro_torch.kernels import tiled2d as T

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(card, flush=True)
    libs = build(ROOT / "build" / "tiled2d_anatomy",
                 variants((_build.CSRC / "tiled2d.cu").read_text()))
    rng = np.random.default_rng(0)
    h, w = CS.BUCKETS[-1]
    x = torch.from_numpy(rng.integers(-128, 128, (CS.SLOTS, h, w), dtype=np.int32)).to(dev)
    bound = 2 * x.numel() * 4 / CS.PEAK_BYTES_PER_S * 1e3
    record = {"card": card, "shape": list(x.shape), "bound_ms": bound, "runs": []}
    print(f"level 1 {tuple(x.shape)}: byte bound {bound:.4f} ms per direction", flush=True)

    def measure(label, lib, mode, th, tw, sch, shift=False, check=False, x=x):
        sch = S.get_scheme(sch)
        bands = F._fwd2d_math(x, mode, sch)
        fwd, inv, outs, xo = level_calls(lib, x, bands, mode, th, tw, sch, shift)
        fwd()
        inv()
        torch.cuda.synchronize(dev)
        exact = None
        if check:
            exact = (all(torch.equal(a, b) for a, b in zip(outs, bands))
                     and torch.equal(xo, x))
            if not exact:
                raise AssertionError(f"{label}: kernel != plain version")
        row = {"label": label, "shape": list(x.shape), "scheme": sch.name, "mode": mode,
               "tile": [th, tw], "four_byte": shift, "exact": exact}
        for name, fn in (("fwd", fwd), ("inv", inv)):
            row[name + "_ms"] = CS._median_ms(fn, 20)
            row[name + "_device_ms"] = CS._pass_ms(fn)
        record["runs"].append(row)
        dv = {k: next(iter(row[k + "_device_ms"].values()), float("nan")) for k in ("fwd", "inv")}
        print(f"{label} {tuple(x.shape)} {sch.name}/{mode} tile {th}x{tw}"
              f"{' 4-byte' if shift else ''}: fwd "
              f"{row['fwd_ms']:.4f} ms (device {dv['fwd']:.4f}), inv {row['inv_ms']:.4f} ms "
              f"(device {dv['inv']:.4f})" + ("; bit-equal" if exact else ""), flush=True)

    sch = S.get_scheme(CS.SCHEME)
    default = B.pick_tile(h, w, sch.halo, dev)
    for name, lib in libs.items():
        measure(name, lib, CS.MODE, *default, CS.SCHEME, check=name == "as_is")
    for tile in ((64, 256), (64, 128), (96, 128), (64, 64), (128, 64), (32, 256)):
        measure("as_is", libs["as_is"], CS.MODE, *tile, CS.SCHEME, check=True)
    measure("as_is", libs["as_is"], CS.MODE, *default, CS.SCHEME, shift=True, check=True)
    measure("as_is", libs["as_is"], "paper", *B.pick_tile(h, w, 4, dev), "97m", check=True)
    measure("no_cascade", libs["no_cascade"], "paper", *B.pick_tile(h, w, 4, dev), "97m")
    # the first line once more: the spread within this run
    measure("as_is", libs["as_is"], CS.MODE, *default, CS.SCHEME, check=True)
    # each tiled level of the serve route's pyramid: the C launcher at
    # several tiles, then the Python wrappers (their host work included)
    # at the tile the dispatcher picks
    for lv in range(CS.LEVELS):
        hl, wl = h >> lv, w >> lv
        if not F.plan_2d(hl, wl, dev, CS.SCHEME).startswith("tiled"):
            continue
        xl = torch.from_numpy(
            rng.integers(-128, 128, (CS.SLOTS, hl, wl), dtype=np.int32)).to(dev)
        for tile in ((128, 128), (64, 128), (64, 64), (32, 64), (32, 32)):
            measure("as_is", libs["as_is"], CS.MODE, *tile, CS.SCHEME, check=True, x=xl)
        tile = B.pick_tile(hl, wl, sch.halo, dev)
        bands = F._fwd2d_math(xl, CS.MODE, sch)
        wrap = {"shape": list(xl.shape), "tile": list(tile), "fwd_ms": CS._median_ms(
            lambda: T.fwd2d_tiled_cuda(xl, CS.MODE, *tile, sch), 20), "inv_ms": CS._median_ms(
            lambda: T.inv2d_tiled_cuda(*bands, CS.MODE, *tile, sch), 20)}
        record.setdefault("wrapper", []).append(wrap)
        print(f"wrapper {tuple(xl.shape)} tile {tile}: fwd {wrap['fwd_ms']:.4f} ms, inv "
              f"{wrap['inv_ms']:.4f} ms", flush=True)
    # host work per call, at the smallest tiled level (the card idles
    # behind the host there): calls enqueued back to back, then one sync
    xs = torch.from_numpy(rng.integers(-128, 128, (CS.SLOTS, 256, 256), dtype=np.int32)).to(dev)
    bands = F._fwd2d_math(xs, CS.MODE, sch)
    tile = B.pick_tile(256, 256, sch.halo, dev)
    fwd, inv, _, _ = level_calls(libs["as_is"], xs, bands, CS.MODE, *tile, sch)
    host = {
        "c_launcher_fwd": fwd,
        "c_launcher_inv": inv,
        "wrapper_fwd": lambda: T.fwd2d_tiled_cuda(xs, CS.MODE, *tile, sch),
        "wrapper_inv": lambda: T.inv2d_tiled_cuda(*bands, CS.MODE, *tile, sch),
        "four_band_allocations": lambda: [torch.empty_like(b) for b in bands],
        "one_torch_kernel": lambda: xs.add_(0),
    }
    record["host_us_per_call"] = {}
    for name, fn in host.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize(dev)
        record["host_us_per_call"][name] = us
        print(f"host {name}: {us:.1f} us per call", flush=True)
    if args.json_out:
        out = pathlib.Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
