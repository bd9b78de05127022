"""Where the time of one whole-volume 3-D level goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/whole3d_anatomy.py [--only wrappers] [--src PATH] [--json-out PATH]

1. ``wrappers``: the Python wrappers ``fwd3d_whole_cuda`` /
   ``inv3d_whole_cuda`` at every level the 3-D path gives them (cdf53 /
   jpeg2000: level 4 of 4 x (64, 512, 512), levels 3-4 of the 4 x (16,
   256, 256) bucket, level 3 of one WZRS depth slab) and at cdf22 / paper's
   (4, 16, 128, 128) and three-pass (4, 64, 512, 512) levels: the
   CUDA-event median of 20 calls, the kernel's device ms
   (``torch.profiler``), the host's time per call (200 calls enqueued back
   to back, then one sync) and the cluster size the geometry picks; each
   output checked bit-equal against the plain version.  The same host
   time of the C launcher called directly, and of a ``ctypes`` call that
   launches an empty kernel: the floor of any wrapper call.
2. ``variants``: ``csrc/whole3d.cu`` built as it is and with stages cut
   out, into ``build/whole3d_anatomy/`` (the cut variants compute wrong
   bands: they only time), each through its C launcher at the shapes of
   1, forward and inverse:

     loads_stores  the volume read and the bands written, no lifting
     w_and_d       + the W and D cascades (local to each block)
     as_is         + the H cascade across the cluster: its DSMEM reads
                   and cluster barriers

3. ``sweep``: the committed kernel at every cluster size from 1 to 16
   that fits the shape (``fused3d.cluster_fits``: at least one row pair
   a block, each block's share within one block's shared memory, the
   card admitting the cluster), each checked bit-equal.

Device ms are read only from profiles that hold every kernel record of
their calls (``chip_smoke._pass_ms``), else reported as not measured.

Before each shape the card is kept busy for a few hundred ms, so the SM
clock (printed at the start and the end) is at its maximum when timing
starts.  ``--src PATH`` imports ``repro_torch`` from another checkout's ``src``
(the parent commit unpacked beside this one) for part 1, so one call
times both on one card; parts 2 and 3 need this checkout's kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (label, (B, D, H, W), scheme, mode): every level the 3-D path gives
# the whole-volume kernel, cdf22's level that a cluster holds, and the
# three-pass level 1 of cdf22
SHAPES = (
    ("volume level 4", (4, 8, 64, 64), "cdf53", "jpeg2000"),
    ("bucket level 3", (4, 4, 64, 64), "cdf53", "jpeg2000"),
    ("bucket level 4", (4, 2, 32, 32), "cdf53", "jpeg2000"),
    ("stream level 3", (1, 2, 128, 128), "cdf53", "jpeg2000"),
    ("cdf22 level 3", (4, 16, 128, 128), "cdf22", "paper"),
)
THREE_PASS = ("cdf22 level 1", (4, 64, 512, 512), "cdf22", "paper")

EMPTY_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
// the launchers' argument list, and nothing else: the cost of the call
extern "C" int repro_nop28(int, void*, void*, void*, void*, void*, void*, void*, void*, void*,
                           void*, void*, void*, void*, void*, void*, void*, int, int, int, int,
                           int, int, int, int, int, void*, int, void*) {
  return 0;
}
"""
# a cluster of 16 whose shares each take 229,376 of the block's 232,448
# bytes: the largest configuration the geometry can ask for
FULL_SHARE = ("c=16 at a full share", (1, 7, 256, 512), "cdf22", "paper")

# the three cascades of one direction, as whole3d.cu's cluster kernel
# writes them (cut out to time the stages)
CASCADE_W = "    lift_w(vol, v, c);\n"
CASCADE_H = "    lift_h(vol, v, c, cluster);\n"
CASCADE_D = "    lift_d(vol, v, c);\n"


def variants(source: str) -> dict:
    for cut in (CASCADE_W, CASCADE_H, CASCADE_D):
        if source.count(cut) != 2:
            raise SystemExit(f"whole3d.cu no longer holds {cut.strip()!r} in both directions: "
                             "update this tool")
    no_h = source.replace(CASCADE_H, "")
    return {
        "loads_stores": no_h.replace(CASCADE_W, "").replace(CASCADE_D, ""),
        "w_and_d": no_h,
        "as_is": source,
    }


def _nvcc(d: pathlib.Path, name: str):
    from repro_torch.kernels import _build

    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
         str(d / name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(out: pathlib.Path, texts: dict):
    """The variants' libraries and the empty-launch library, compiled in
    parallel."""
    from repro_torch.kernels import _build

    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "whole3d.cu").write_text(text)
        procs[name] = _nvcc(d, "whole3d.cu")
    d = out / "empty"
    d.mkdir(parents=True, exist_ok=True)
    (d / "empty.cu").write_text(EMPTY_SOURCE)
    procs["empty"] = _nvcc(d, "empty.cu")
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        if name == "empty":
            lib.repro_empty_launch.argtypes = [ctypes.c_void_p]
            lib.repro_empty_launch.restype = ctypes.c_int
            lib.repro_nop28.argtypes = _build._SIGNATURES["whole3d"]["repro_whole3d_fwd"]
            lib.repro_nop28.restype = ctypes.c_int
        else:
            for fn, argtypes in _build._SIGNATURES["whole3d"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def warm(dev) -> None:
    """Keep the card busy for a few hundred ms, so its SM clock is at its
    maximum when a measurement starts (an idle card idles its clock)."""
    a = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    for _ in range(1000):
        a.add_(1)
    torch.cuda.synchronize(dev)


def volume(rng, shape, dev):
    return torch.from_numpy(rng.integers(-2048, 2048, shape, dtype=np.int32)).to(dev)


def launcher_calls(lib, x, bands, mode, sch, c, dev):
    """(forward, inverse) closures calling the C launchers of one level
    with cluster size ``c`` (0: the three passes), and their outputs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused3d as F3

    bsz, d, h, w = x.shape
    g = F3.volume_geometry(bsz, d, h, w, dev)
    outs = [torch.empty_like(b) for b in bands]
    xo = torch.empty_like(x)
    sw = dw = scratch = None
    t = [None] * 4
    if not c:
        sw, dw, t = F3._intermediates(x, bsz, d, h, w)
        scratch = x.new_empty((g["scratch"],)) if g["scratch"] else None
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ints = (bsz, d, h, w, c, g["rb"], g["row_global"], g["cw_h"], g["cw_d"])
    ft, it = (_build.cascade_table(sch, mode, inverse=v) for v in (False, True))
    fargs = [dev.index or 0, *(_build._ptr(a) for a in (x, sw, dw, *t, *outs, scratch)), *ints,
             ft.ctypes.data_as(ctypes.c_void_p), len(ft), stream]
    iargs = [dev.index or 0, *(_build._ptr(a) for a in (*bands, *t, sw, dw, xo, scratch)), *ints,
             it.ctypes.data_as(ctypes.c_void_p), len(it), stream]

    def fwd():
        rc = lib.repro_whole3d_fwd(*fargs)
        if rc:
            raise RuntimeError(f"repro_whole3d_fwd c={c}: CUDA error {rc}")

    def inv():
        rc = lib.repro_whole3d_inv(*iargs)
        if rc:
            raise RuntimeError(f"repro_whole3d_inv c={c}: CUDA error {rc}")

    return fwd, inv, outs, xo


def cluster_of(g: dict) -> int:
    """The cluster size of a geometry (a parent checkout's names the
    one-block path ``fused``)."""
    return g["cluster"] if "cluster" in g else g["fused"]


def wrappers(CS, rng, dev, record, lib_empty=None) -> None:
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused3d as F3

    rows = record.setdefault("wrappers", [])
    for label, shape, name, mode in SHAPES + (THREE_PASS,):
        sch = S.get_scheme(name)
        x = volume(rng, shape, dev)
        bands = [b.contiguous() for b in F3.fwd3d_whole_plain(x, mode, sch)]
        fwd = lambda: F3.fwd3d_whole_cuda(x, mode, sch)  # noqa: E731
        inv = lambda: F3.inv3d_whole_cuda(bands, mode, sch)  # noqa: E731
        exact = (all(torch.equal(a, b) for a, b in zip(fwd(), bands))
                 and torch.equal(inv(), F3.inv3d_whole_plain(bands, mode, sch)))
        if not exact:
            raise AssertionError(f"{label} {shape}: kernel != plain version")
        c = cluster_of(F3.volume_geometry(*shape, dev))
        warm(dev)
        row = {"label": label, "shape": list(shape), "scheme": name, "mode": mode, "cluster": c,
               "bound_ms": 2 * x.numel() * 4 / CS.PEAK_BYTES_PER_S * 1e3}
        for key, fn in (("fwd", fwd), ("inv", inv)):
            row[key + "_ms"] = CS._median_ms(fn, 20)
            row[key + "_device_ms"] = CS._device_ms(fn, 1 if c else 3)
            row[key + "_host_us"] = CS._host_us(fn, dev)
        rows.append(row)
        print(f"wrapper {label} {tuple(shape)} {name}/{mode} c={c}: fwd {row['fwd_ms']:.4f} ms "
              f"(device {CS._fmt_ms(row['fwd_device_ms'])}, host {row['fwd_host_us']:.1f} us), "
              f"inv {row['inv_ms']:.4f} ms (device {CS._fmt_ms(row['inv_device_ms'])}, host "
              f"{row['inv_host_us']:.1f} us); bound {row['bound_ms']:.6f} ms; bit-equal",
              flush=True)
        del x, bands
    if lib_empty is not None:
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        record["empty_launch_host_us"] = CS._host_us(
            lambda: lib_empty.repro_empty_launch(stream), dev)
        args = (0,) + (None,) * 16 + (1,) * 9 + (None, 0, stream)
        record["nop28_host_us"] = CS._host_us(lambda: lib_empty.repro_nop28(*args), dev)
        print(f"host: ctypes call launching an empty kernel "
              f"{record['empty_launch_host_us']:.1f} us per call; a call of the launchers' 28 "
              f"arguments that does nothing {record['nop28_host_us']:.1f} us", flush=True)


def stages(CS, libs, rng, dev, record) -> None:
    """Part 2 and the C launcher's host time: the cut variants at the
    shapes of part 1, each at the cluster size the geometry picks."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused3d as F3

    rows = record.setdefault("variants", [])
    for label, shape, name, mode in SHAPES:
        sch = S.get_scheme(name)
        x = volume(rng, shape, dev)
        bands = [b.contiguous() for b in F3.fwd3d_whole_plain(x, mode, sch)]
        c = F3.volume_geometry(*shape, dev)["cluster"]
        row = {"label": label, "shape": list(shape), "cluster": c}
        warm(dev)
        for var, lib in libs.items():
            fwd, inv, outs, xo = launcher_calls(lib, x, bands, mode, sch, c, dev)
            for key, fn in (("fwd", fwd), ("inv", inv)):
                row[f"{var}_{key}_device_ms"] = CS._device_ms(fn, 1 if c else 3)
            if var == "as_is":
                exact = (all(torch.equal(a, b) for a, b in zip(outs, bands))
                         and torch.equal(xo, x))
                if not exact:
                    raise AssertionError(f"as_is {label}: kernel != plain version")
                row["launcher_fwd_host_us"] = CS._host_us(fwd, dev)
                row["launcher_inv_host_us"] = CS._host_us(inv, dev)
        rows.append(row)
        print(f"stages {label} {tuple(shape)} c={c}, device ms fwd / inv: " + "; ".join(
            f"{v} {CS._fmt_ms(row[v + '_fwd_device_ms'])} / "
            f"{CS._fmt_ms(row[v + '_inv_device_ms'])}"
            for v in libs) + f"; C launcher host {row['launcher_fwd_host_us']:.1f} / "
            f"{row['launcher_inv_host_us']:.1f} us", flush=True)


def sweep(CS, lib, rng, dev, record) -> None:
    """Part 3: every admitted cluster size at the shapes of part 1."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused3d as F3

    rows = record.setdefault("sweep", [])
    for label, shape, name, mode in SHAPES + (FULL_SHARE,):
        sch = S.get_scheme(name)
        bsz, d, h, w = shape
        x = volume(rng, shape, dev)
        bands = [b.contiguous() for b in F3.fwd3d_whole_plain(x, mode, sch)]
        for c in F3.CLUSTER_SIZES:
            if not F3.cluster_fits(d, h, w, c, dev):
                continue
            row = {"label": label, "shape": list(shape), "cluster": c}
            fwd, inv, outs, xo = launcher_calls(lib, x, bands, mode, sch, c, dev)
            try:
                fwd()
                inv()
            except RuntimeError as e:
                row["refused"] = str(e)
                rows.append(row)
                print(f"sweep {label} {tuple(shape)} c={c}: refused ({e})", flush=True)
                continue
            torch.cuda.synchronize(dev)
            if not (all(torch.equal(a, b) for a, b in zip(outs, bands)) and torch.equal(xo, x)):
                raise AssertionError(f"sweep {label} c={c}: kernel != plain version")
            warm(dev)
            for key, fn in (("fwd", fwd), ("inv", inv)):
                row[key + "_ms"] = CS._median_ms(fn, 20)
                row[key + "_device_ms"] = CS._device_ms(fn, 1)
            rows.append(row)
            print(f"sweep {label} {tuple(shape)} c={c}: fwd {row['fwd_ms']:.4f} ms (device "
                  f"{CS._fmt_ms(row['fwd_device_ms'])}), inv {row['inv_ms']:.4f} ms (device "
                  f"{CS._fmt_ms(row['inv_device_ms'])}); bit-equal", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("wrappers",), default="")
    ap.add_argument("--src", default="", help="import repro_torch from this src directory")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("whole3d_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS  # puts this checkout's src on sys.path

    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(f"{card}; SM clock {CS._smi('clocks.sm')}; repro_torch from "
          f"{pathlib.Path(_build.__file__).parents[1]}", flush=True)
    _build.build(["whole3d"])
    texts = {} if args.only else variants((_build.CSRC / "whole3d.cu").read_text())
    libs = build(ROOT / "build" / "whole3d_anatomy", texts)
    rng = np.random.default_rng(0)
    record = {"card": card, "src": str(pathlib.Path(_build.__file__).parents[1])}
    wrappers(CS, rng, dev, record, libs.pop("empty"))
    if not args.only:
        stages(CS, libs, rng, dev, record)
        sweep(CS, libs["as_is"], rng, dev, record)
    record["sm_clock_at_end"] = CS._smi("clocks.sm")
    print(f"SM clock at the end: {record['sm_clock_at_end']}", flush=True)
    if args.json_out:
        out = pathlib.Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
