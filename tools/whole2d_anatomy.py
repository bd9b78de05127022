"""Where the time of the whole-image 2-D levels goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/whole2d_anatomy.py [--only wrappers] [--src PATH] [--json-out PATH]

1. ``wrappers``: at the shapes the serve path gives the whole-image path
   (cdf53 / jpeg2000: level 5 of the 8 x 2048^2 batch, levels 4-5 of the
   8 x 1024^2 batch, the client's one-request inverse of either bucket)
   and at one cdf22 / paper image larger than one block, (2, 257, 383):

     * each level alone through ``fwd2d_whole_cuda`` / ``inv2d_whole_cuda``
       and the run of levels through ``dwt_fwd_2d_multi`` /
       ``dwt_inv_2d_multi`` (every level of the run whole-image): the
       CUDA-event median of 20 calls, the device ms of each kernel it
       launches (``torch.profiler``, by kernel name: the row pass's and
       the column pass's share of a two-pass level), the host's us per
       call (200 calls enqueued back to back, then one sync) and the
       launches a call makes; each output checked bit-equal against the
       plain version;
     * the host us of one ``dwt_inv_2d_multi`` of a 1024^2 request (5
       levels: 3 tiled, 2 whole-image), and of the pieces a call is made
       of, each timed alone: the per-level band copies (``_flat``, where
       the module has it), the launch geometry, the scheme table, the C
       launcher's ctypes call; the rest is validation and Python.

2. ``variants`` (this checkout only): ``csrc/whole2d.cu`` built as it is
   and with stages cut out of the cluster kernel, into
   ``build/whole2d_anatomy/`` (the cut variants compute wrong bands: they
   only time), each through its C launcher at the shapes of 1, each run
   of levels one launch at the plan's cluster size:

     loads_stores  the image read and the bands written, no lifting
     w_only        + the W cascades (local to each block)
     as_is         + the H cascades across the cluster: their DSMEM reads
                   and cluster barriers (the "H share" of the device time)

3. ``sweep`` (this checkout only): the cluster kernel at every cluster
   size from 1 to 16 that the chain admits (``fused2d.chain_fits``), each
   checked bit-equal, at the shapes of 1 and at other batch sizes of the
   serve path's runs (``SWEEP_BATCHES``), beside the size the plan picks
   (``fused2d._pick_cluster``: the rule the sweep is read for).

Device ms are read only from profiles that hold every kernel record of
their calls (``chip_smoke._pass_ms``), else reported as not measured.
Before each shape the card is kept busy for a few hundred ms, so the SM
clock is at its maximum when timing starts.  ``--src PATH`` imports
``repro_torch`` from another checkout's ``src`` (the parent commit
unpacked beside this one) for part 1, so one call times both on one card.
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

# (label, B, [(H, W) of each level of the run], scheme, mode)
SHAPES = (
    ("2048^2 level 5", 8, ((128, 128),), "cdf53", "jpeg2000"),
    ("1024^2 levels 4-5", 8, ((128, 128), (64, 64)), "cdf53", "jpeg2000"),
    ("client 2048^2 level 5", 1, ((128, 128),), "cdf53", "jpeg2000"),
    ("client 1024^2 levels 4-5", 1, ((128, 128), (64, 64)), "cdf53", "jpeg2000"),
    ("cdf22 past one block", 2, ((257, 383),), "cdf22", "paper"),
)

# other batch sizes of the serve path's runs and the run of levels 3-5 of
# a 512^2 pyramid, for the sweep of part 3
SWEEP_BATCHES = tuple(
    (f"{label} B={b}", b, levels, "cdf53", "jpeg2000")
    for label, levels, batches in (
        ("2048^2 level 5", ((128, 128),), (2, 4, 16, 32)),
        ("1024^2 levels 4-5", ((128, 128), (64, 64)), (2, 4, 16, 32)),
        ("512^2 levels 3-5", ((128, 128), (64, 64), (32, 32)), (1, 2, 4, 8, 16)))
    for b in batches)

# the cascades of the cluster kernel, as whole2d.cu writes them (cut out
# to time the other stages)
CASCADE_H = "      lift_h(buf, v, c, cluster);\n"
CASCADE_W = "      lift_w(buf, v, c);\n"


def warm(dev) -> None:
    """Keep the card busy for a few hundred ms, so its SM clock is at its
    maximum when a measurement starts (an idle card idles its clock)."""
    a = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    for _ in range(1000):
        a.add_(1)
    torch.cuda.synchronize(dev)


def image(rng, shape, dev):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int32)).to(dev)


def _launches(fn) -> int:
    from repro_torch import kernels as K

    K.launches.reset()
    fn()
    n = sum(v for k, v in K.launches.snapshot().items() if k.startswith("whole2d"))
    K.launches.reset()
    return n


def _timed(CS, fn, dev, launches) -> dict:
    """Events ms, device ms by kernel (the kernels a call makes counted
    from the profile), host us a call, and the wrapper launches a call
    counts."""
    by_kernel = CS._pass_ms(fn)
    out = {"ms": CS._median_ms(fn, 20), "host_us": CS._host_us(fn, dev),
           "device_ms_by_kernel": by_kernel, "launches": launches}
    vals = list(by_kernel.values())
    out["device_ms"] = sum(vals) if vals and all(isinstance(v, float) for v in vals) else None
    return out


def _fmt(row) -> str:
    parts = ", ".join(f"{k.split('<')[0].split('::')[-1]} {v:.4f}" if isinstance(v, float)
                      else f"{k} {v}" for k, v in row["device_ms_by_kernel"].items())
    dev = f"{row['device_ms']:.4f}" if row["device_ms"] is not None else "not measured"
    return (f"{row['ms']:.4f} ms, device {dev} ({parts}), host {row['host_us']:.1f} us, "
            f"{row['launches']} launches")


def wrappers(CS, rng, dev, record) -> None:
    from repro_torch import kernels as K
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused2d as F

    rows = record.setdefault("wrappers", [])
    for label, bsz, levels, name, mode in SHAPES:
        sch = S.get_scheme(name)
        h0, w0 = levels[0]
        x = image(rng, (bsz, h0, w0), dev)
        warm(dev)
        row = {"label": label, "batch": bsz, "levels": [list(hw) for hw in levels],
               "scheme": name, "mode": mode,
               # x read once, every band written once (they partition x)
               "bound_ms": 2 * bsz * h0 * w0 * 4 / CS.PEAK_BYTES_PER_S * 1e3}
        if any(F.plan_2d(h, w, dev, name) != "whole-cuda" for h, w in levels):
            raise AssertionError(f"{label}: not every level is whole-image")
        # each level alone
        ll = x
        for h, w in levels:
            want = F._fwd2d_math(ll, mode, sch)
            got = F.fwd2d_whole_cuda(ll, mode, sch)
            back = F.inv2d_whole_cuda(*want, mode, sch)
            if not (all(torch.equal(a, b) for a, b in zip(got, want))
                    and torch.equal(back, F._inv2d_math(*want, mode, sch))):
                raise AssertionError(f"{label} level {h}x{w}: kernel != plain version")
            lv = {"shape": [bsz, h, w]}
            for key, fn in (("fwd", lambda ll=ll: F.fwd2d_whole_cuda(ll, mode, sch)),
                            ("inv", lambda want=want: F.inv2d_whole_cuda(*want, mode, sch))):
                lv[key] = _timed(CS, fn, dev, _launches(fn))
                print(f"level {label} {tuple(lv['shape'])} {name}/{mode} {key}: "
                      f"{_fmt(lv[key])}", flush=True)
            row.setdefault("per_level", []).append(lv)
            ll = want[0]
        # the run of levels through the public entry points
        pyr = K.dwt_fwd_2d_multi(x, levels=len(levels), mode=mode, scheme=sch)
        want = F._lift.dwt_fwd_2d_multi(x, levels=len(levels), mode=mode, scheme=sch,
                                        checked=False)
        exact = torch.equal(pyr.ll, want.ll) and all(
            torch.equal(a, b) for la, lb in zip(pyr.details, want.details)
            for a, b in zip(la, lb))
        if not exact or not torch.equal(K.dwt_inv_2d_multi(want, mode=mode, scheme=sch), x):
            raise AssertionError(f"{label}: the run of levels != plain version")
        for key, fn in (
            ("fwd", lambda: K.dwt_fwd_2d_multi(x, levels=len(levels), mode=mode, scheme=sch)),
            ("inv", lambda: K.dwt_inv_2d_multi(want, mode=mode, scheme=sch)),
        ):
            row["run_" + key] = _timed(CS, fn, dev, _launches(fn))
            print(f"run {label} B={bsz} {[tuple(hw) for hw in levels]} {key}: "
                  f"{_fmt(row['run_' + key])}; bound {row['bound_ms']:.6f} ms", flush=True)
        rows.append(row)
        del x, pyr, want
    record["inverse_1024_host"] = inverse_stages(CS, rng, dev)


def inverse_stages(CS, rng, dev) -> dict:
    """Host us of one ``dwt_inv_2d_multi`` of a 1024^2 request and of the
    pieces it is made of, each timed alone."""
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused2d as F

    name, mode = "cdf53", "jpeg2000"
    x = image(rng, (1, 1024, 1024), dev)
    pyr = K.dwt_fwd_2d_multi(x, levels=5, mode=mode, scheme=name)
    if not torch.equal(K.dwt_inv_2d_multi(pyr, mode=mode, scheme=name), x):
        raise AssertionError("1024^2 request: inverse != input")
    out = {"total_us": CS._host_us(lambda: K.dwt_inv_2d_multi(pyr, mode=mode, scheme=name),
                                   dev),
           "launches": _launches(lambda: K.dwt_inv_2d_multi(pyr, mode=mode, scheme=name))}
    bands = [b for lvl in pyr.details for b in lvl]
    if hasattr(F, "_flat"):
        lead = (1,)
        out["flat_us"] = CS._host_us(
            lambda: [F._flat(b, lead) for b in [pyr.ll] + bands], dev)
    whole = [(lh.shape[-2] * 2, hl.shape[-1] * 2) for lh, hl, _ in pyr.details
             if F.plan_2d(lh.shape[-2] * 2, hl.shape[-1] * 2, dev, name) == "whole-cuda"]
    if hasattr(F, "whole_geometry"):
        out["geometry_us"] = CS._host_us(
            lambda: [F.whole_geometry(1, h, w, dev) for h, w in whole], dev)
    out["table_us"] = CS._host_us(
        lambda: [_build.cascade_table(name, mode, True) for _ in whole], dev)
    lib = _build.library("whole2d")
    out["ctypes_call_us"] = CS._host_us(
        lambda: [lib.repro_error_string(0) for _ in whole], dev)
    print("inverse of one 1024^2 request, host us: " + ", ".join(
        f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}" for k, v in out.items()),
        flush=True)
    return out


def variants(source: str) -> dict:
    for cut in (CASCADE_H, CASCADE_W):
        if source.count(cut) != 2:
            raise SystemExit(f"whole2d.cu no longer holds {cut.strip()!r} in both directions: "
                             "update this tool")
    no_h = source.replace(CASCADE_H, "")
    return {"loads_stores": no_h.replace(CASCADE_W, ""), "w_only": no_h, "as_is": source}


def build_variants(out: pathlib.Path, texts: dict) -> dict:
    """The variants' libraries, compiled in parallel."""
    from repro_torch.kernels import _build

    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "whole2d.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
             str(d / "whole2d.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for fn, argtypes in _build._SIGNATURES["whole2d"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher_calls(lib, x, levels, sch, mode, c, dev):
    """(forward, inverse) closures calling a library's chain launchers on
    a run of ``levels`` levels of x at cluster size c, and their outputs:
    the forward's bands (as the plan lays them out) and the inverse's
    image, rebuilt from the plain version's bands."""
    from repro_torch.kernels import fused2d as F

    bsz, h, w = x.shape
    fplan = F._chain_plan(bsz, h, w, levels, sch, mode, False, dev, c)
    iplan = F._chain_plan(bsz, h, w, levels, sch, mode, True, dev, c)
    flat = x.new_empty((fplan.total,))
    fptrs = fplan.offsets[0] + flat.data_ptr()
    bands = [F._views(flat, lv) for lv in fplan.bands]
    ll, details = F.fwd2d_chain_plain(x, levels, mode, sch)
    iptrs = np.zeros(4 * levels, np.int64)
    for k, (lh, hl, hh) in enumerate(details):
        iptrs[4 * k + 1:4 * k + 4] = (hl.data_ptr(), lh.data_ptr(), hh.data_ptr())
    iptrs[4 * levels - 4] = ll.data_ptr()
    xo = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def fwd():
        rc = lib.repro_whole2d_cluster_fwd(dev.index or 0, x.data_ptr(), fptrs.ctypes.data,
                                           *fplan.launches[0].ints, stream)
        if rc:
            raise RuntimeError(f"repro_whole2d_cluster_fwd c={c}: CUDA error {rc}")

    def inv():
        rc = lib.repro_whole2d_cluster_inv(dev.index or 0, iptrs.ctypes.data, xo.data_ptr(),
                                           *iplan.launches[0].ints, stream)
        if rc:
            raise RuntimeError(f"repro_whole2d_cluster_inv c={c}: CUDA error {rc}")

    def exact() -> bool:
        got_ll = bands[-1][0]
        return (torch.equal(got_ll, ll) and torch.equal(xo, x) and all(
            torch.equal(lv[2], lh) and torch.equal(lv[1], hl) and torch.equal(lv[3], hh)
            for lv, (lh, hl, hh) in zip(bands, details)))

    return fwd, inv, exact, (flat, details, ll)


def stages(CS, libs, rng, dev, record) -> None:
    """Part 2: the cut variants at the shapes of part 1, each run of
    levels as one launch at the cluster size the plan picks."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused2d as F

    rows = record.setdefault("variants", [])
    for label, bsz, levels, name, mode in SHAPES:
        sch = S.get_scheme(name)
        h0, w0 = levels[0]
        x = image(rng, (bsz, h0, w0), dev)
        runs = F.chain_launches(bsz, h0, w0, len(levels), dev)
        if len(runs) != 1 or not runs[0][1]:
            raise AssertionError(f"{label}: not one cluster launch ({runs})")
        c = runs[0][1]
        row = {"label": label, "batch": bsz, "levels": [list(hw) for hw in levels], "cluster": c}
        warm(dev)
        for var, lib in libs.items():
            fwd, inv, exact, _held = launcher_calls(lib, x, len(levels), sch, mode, c, dev)
            for key, fn in (("fwd", fwd), ("inv", inv)):
                row[f"{var}_{key}_device_ms"] = CS._device_ms(fn, 1)
            if var == "as_is":
                torch.cuda.synchronize(dev)
                if not exact():
                    raise AssertionError(f"as_is {label}: kernel != plain version")
                row["launcher_fwd_host_us"] = CS._host_us(fwd, dev)
                row["launcher_inv_host_us"] = CS._host_us(inv, dev)
        for key in ("fwd", "inv"):
            full, no_h = row[f"as_is_{key}_device_ms"], row[f"w_only_{key}_device_ms"]
            row[f"h_share_{key}"] = (full - no_h) / full if full and no_h is not None else None
        rows.append(row)
        print(f"stages {label} B={bsz} {[tuple(hw) for hw in levels]} c={c}, device ms fwd / "
              f"inv: " + "; ".join(
                  f"{v} {CS._fmt_ms(row[v + '_fwd_device_ms'])} / "
                  f"{CS._fmt_ms(row[v + '_inv_device_ms'])}" for v in libs)
              + f"; H share {row['h_share_fwd']} / {row['h_share_inv']}; C launcher host "
              f"{row['launcher_fwd_host_us']:.1f} / {row['launcher_inv_host_us']:.1f} us",
              flush=True)


def sweep(CS, lib, rng, dev, record) -> None:
    """Part 3: every admitted cluster size at the shapes of part 1."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused2d as F

    rows = record.setdefault("sweep", [])
    for label, bsz, levels, name, mode in SHAPES + SWEEP_BATCHES:
        sch = S.get_scheme(name)
        h0, w0 = levels[0]
        x = image(rng, (bsz, h0, w0), dev)
        picked = F._pick_cluster(bsz, h0, w0, len(levels), dev)
        for c in F.CLUSTER_SIZES:
            if not F.chain_fits(h0, w0, len(levels), c, dev):
                continue
            row = {"label": label, "batch": bsz, "levels": [list(hw) for hw in levels],
                   "cluster": c, "picked": picked}
            fwd, inv, exact, _held = launcher_calls(lib, x, len(levels), sch, mode, c, dev)
            fwd()
            inv()
            torch.cuda.synchronize(dev)
            if not exact():
                raise AssertionError(f"sweep {label} c={c}: kernel != plain version")
            warm(dev)
            for key, fn in (("fwd", fwd), ("inv", inv)):
                row[key + "_ms"] = CS._median_ms(fn, 20)
                row[key + "_device_ms"] = CS._device_ms(fn, 1)
            rows.append(row)
            mark = " (picked)" if c == picked else ""
            print(f"sweep {label} c={c}{mark}: fwd {row['fwd_ms']:.4f} ms (device "
                  f"{CS._fmt_ms(row['fwd_device_ms'])}), inv {row['inv_ms']:.4f} ms (device "
                  f"{CS._fmt_ms(row['inv_device_ms'])}); bit-equal", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("wrappers",), default="")
    ap.add_argument("--src", default="", help="import repro_torch from this src directory")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("whole2d_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS  # puts this checkout's src on sys.path

    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(f"{card}; SM clock {CS._smi('clocks.sm')}; repro_torch from "
          f"{pathlib.Path(_build.__file__).parents[1]}", flush=True)
    _build.build(["whole2d", "tiled2d"])
    libs = {} if args.only else build_variants(
        ROOT / "build" / "whole2d_anatomy", variants((_build.CSRC / "whole2d.cu").read_text()))
    rng = np.random.default_rng(0)
    record = {"card": card, "src": str(pathlib.Path(_build.__file__).parents[1])}
    wrappers(CS, rng, dev, record)
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
