"""Where the time of the windowed 1-D lifting kernels goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/lift1d_anatomy.py [--only wrappers] [--src PATH] [--json-out PATH]

1. ``wrappers``: for cdf53, 97m and haar in both rounding modes, at (a)
   64 x 65,536 (the ``LARGE`` configs), (b) 1024 x 65,536 and (c) one
   line of 11,534,336 samples (one stablelm-1.6b MLP matrix flattened,
   as the ``wz`` checkpoint codec does):

     * the 4-level pyramid through ``kernels.dwt_fwd`` / ``dwt_inv``
       (unchecked), and each of its levels alone through
       ``kernels.dwt_fwd_1d`` / ``dwt_inv_1d``: the CUDA-event median of
       20 calls, the device ms of each kernel a call launches
       (``torch.profiler``, read from whole profiles only), the host us
       per call (200 calls enqueued back to back, then one sync) of the
       public call and of its C launcher alone (the ctypes calls one
       public call makes, replayed with the same arguments), and the
       launches a call counts; every output checked bit-equal against the
       plain oracle (``core.lifting``) on the card;
     * the bound: a level reads its input once and writes its bands once
       (8 bytes a sample); a run of levels reads the first level's input
       once and writes every band once (8 bytes a level-0 sample).

2. ``variants`` (this checkout only): ``csrc/lift1d.cu`` built as it is
   and with the lifting cut out (``loads_stores``: the windows read, the
   bands written, no cascade; the cut variants compute wrong bands: they
   only time), into ``build/lift1d_anatomy/``; each ctypes call of one
   unchecked 4-level ``dwt_fwd`` / ``dwt_inv`` replayed alone on each
   variant (paper rounding, the three schemes and shapes): device ms.

3. ``sweep`` (this checkout only): the run kernels built with 64, 128
   and 256 threads a block (``kRunThreads``), each at tiles of up to 1024,
   2048 and 4096 level-0 samples (``backend._RUN_MAX_TILE``, with the
   blocks an SM the share allows), into ``build/lift1d_anatomy/``; each
   checked bit-equal against the plain oracle, then the device ms of one
   4-level ``dwt_fwd`` / ``dwt_inv`` (cdf53 and 97m, paper rounding) at
   the three shapes, as is and with the lifting cut out: the sweep the
   committed geometry (128 threads, 4096 samples) was read from.

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

SCHEMES = ("cdf53", "97m", "haar")
MODES = ("paper", "jpeg2000")
SHAPES = {"a": (64, 65536), "b": (1024, 65536), "c": (1, 2048 * 5632)}
LEVELS = 4
PCM16 = (-32768, 32768)

# the cascade calls of csrc/lift1d.cu, one per direction: those of the
# per-level kernels (before the run kernels), of the run kernels, and of
# the run kernels with policy runs; a variant cuts whichever the source
# holds
CASCADES = (
    ("  cascade_ext<false>(win, 1, W, nr, W / 2, c);\n",
     "  cascade_ext<false>(win, 1, W, nr, P, c);\n"),
    ("      lift_row(ev, od, W >> 1, c, lane, tpr, on);\n",
     "      lift_row(ev, od, Wp, c, lane, tpr, on);\n"),
    ("      lift_row<POLICY>(ev, od, W >> 1, c, lane, tpr, on, start >> 1, n, crosses);\n",
     "      lift_row<POLICY>(ev, od, Wp, c, lane, tpr, on, a, n, crosses);\n"),
)


# the argument of each run launcher that points to a host table of band
# addresses (its levels are argument 5)
BAND_TABLE_ARG = {"repro_lift1d_run_fwd": 2, "repro_lift1d_run_inv": 1}


def warm(dev) -> None:
    """Keep the card busy for a few hundred ms, so its SM clock is at its
    maximum when a measurement starts (an idle card idles its clock)."""
    a = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    for _ in range(1000):
        a.add_(1)
    torch.cuda.synchronize(dev)


class Recorder:
    """Records the ctypes calls (library, function, arguments) that the
    kernel wrappers make while active, and keeps every tensor the
    ``*_cuda`` wrappers return alive, so the calls can be replayed."""

    def __enter__(self):
        from repro_torch.kernels import _build
        from repro_torch.kernels import dwt53 as D

        self.calls, self.keep, self.saved = [], [], []
        orig_call = _build.call

        def call(name, fn, args):
            args = tuple(args)
            if fn in BAND_TABLE_ARG:  # the wrapper frees its host table of band
                i = BAND_TABLE_ARG[fn]  # addresses after the call: keep a copy
                count = args[5].value + 1  # levels + 1 addresses
                table = np.frombuffer((ctypes.c_int64 * count).from_address(args[i]),
                                      np.int64).copy()
                self.keep.append(table)
                args = args[:i] + (table.ctypes.data,) + args[i + 1:]
            self.calls.append((name, fn, args))
            return orig_call(name, fn, args)

        self.saved.append((_build, "call", orig_call))
        _build.call = call
        for attr in dir(D):
            if attr.endswith("_cuda"):
                orig = getattr(D, attr)
                self.saved.append((D, attr, orig))
                setattr(D, attr, self._keep(orig))
        return self

    def _keep(self, orig):
        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.keep.append(out)
            return out
        return wrapped

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)
        return False


def record(fn):
    """The ctypes calls ``fn`` makes, and what keeps their buffers alive."""
    with Recorder() as rec:
        out = fn()
        torch.cuda.synchronize()
    return rec.calls, (rec.keep, out)


def replay(calls, lib=None):
    """A closure making ``calls`` again, on ``lib`` (a variant's library)
    or on the loaded libraries of this checkout."""
    from repro_torch.kernels import _build

    bound = [(getattr(lib or _build.library(name), fn), args) for name, fn, args in calls]

    def run():
        for f, args in bound:
            rc = f(*args)
            if rc:
                raise RuntimeError(f"replayed launcher: CUDA error {rc}")
    return run


def _launches(fn) -> int:
    from repro_torch import kernels as K

    K.launches.reset()
    fn()
    n = sum(K.launches.snapshot().values())
    K.launches.reset()
    return n


def _timed(CS, fn, dev, calls) -> dict:
    """Events ms, device ms by kernel, host us of the call and of its C
    launchers alone, and the launches a call counts."""
    by_kernel = CS._pass_ms(fn)
    vals = list(by_kernel.values())
    return {"ms": CS._median_ms(fn, 20), "host_us": CS._host_us(fn, dev),
            "launcher_host_us": CS._host_us(replay(calls), dev),
            "device_ms_by_kernel": by_kernel,
            "device_ms": sum(vals) if vals and all(isinstance(v, float) for v in vals) else None,
            "launches": _launches(fn)}


def _fmt(row) -> str:
    dev = f"{row['device_ms']:.4f}" if row["device_ms"] is not None else "not measured"
    return (f"{row['ms']:.4f} ms, device {dev}, host {row['host_us']:.1f} us (C launchers "
            f"{row['launcher_host_us']:.1f}), {row['launches']} launches")


def _equal(label, got, want) -> None:
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: kernel != plain oracle")


def wrappers(CS, rng, dev, out) -> None:
    from repro_torch import kernels as K
    from repro_torch.core import lifting as L

    rows_out = out.setdefault("wrappers", [])
    for key, (rows, n0) in SHAPES.items():
        x = torch.from_numpy(rng.integers(*PCM16, (rows, n0), dtype=np.int32)).to(dev)
        for name in SCHEMES:
            for mode in MODES:
                kw = dict(mode=mode, scheme=name, checked=False)
                want = L.dwt_fwd(x, levels=LEVELS, mode=mode, scheme=name)
                row = {"shape": key, "dims": [rows, n0], "scheme": name, "mode": mode,
                       "run_bound_ms": 8 * rows * n0 / CS.PEAK_BYTES_PER_S * 1e3}
                warm(dev)
                fcalls, fkeep = record(lambda: K.dwt_fwd(x, levels=LEVELS, **kw))
                pyr = fkeep[1]
                _equal(f"{key} {name}/{mode} dwt_fwd", (pyr.approx,) + pyr.details,
                       (want.approx,) + want.details)
                icalls, ikeep = record(lambda: K.dwt_inv(want, **kw))
                _equal(f"{key} {name}/{mode} dwt_inv", [ikeep[1]], [x])
                row["run_fwd"] = _timed(CS, lambda: K.dwt_fwd(x, levels=LEVELS, **kw), dev,
                                        fcalls)
                row["run_inv"] = _timed(CS, lambda: K.dwt_inv(want, **kw), dev, icalls)
                for d in ("fwd", "inv"):
                    print(f"run ({key}) {rows}x{n0} {name}/{mode} {d} x{LEVELS}: "
                          f"{_fmt(row['run_' + d])}; run bound {row['run_bound_ms']:.4f} ms",
                          flush=True)
                del pyr, fkeep, ikeep
                xs = x
                for lv in range(LEVELS):
                    d = want.details[LEVELS - 1 - lv]
                    n = xs.shape[-1]
                    fcalls, fkeep = record(lambda: K.dwt_fwd_1d(xs, **kw))
                    s = fkeep[1][0]
                    _equal(f"{key} {name}/{mode} level {lv} fwd", fkeep[1][1:], [d])
                    icalls, ikeep = record(lambda: K.dwt_inv_1d(s, d, **kw))
                    _equal(f"{key} {name}/{mode} level {lv} inv", [ikeep[1]], [xs])
                    lvl = {"level": lv, "n": n,
                           "bound_ms": 8 * rows * n / CS.PEAK_BYTES_PER_S * 1e3,
                           "fwd": _timed(CS, lambda: K.dwt_fwd_1d(xs, **kw), dev, fcalls),
                           "inv": _timed(CS, lambda: K.dwt_inv_1d(s, d, **kw), dev, icalls)}
                    row.setdefault("levels", []).append(lvl)
                    for dd in ("fwd", "inv"):
                        print(f"  level {lv} ({key}) {rows}x{n} {name}/{mode} {dd}: "
                              f"{_fmt(lvl[dd])}; bound {lvl['bound_ms']:.4f} ms", flush=True)
                    del fkeep, ikeep
                    xs = s
                rows_out.append(row)
                del want, xs
        del x
        torch.cuda.empty_cache()


def variants(source: str) -> dict:
    for cuts in CASCADES:
        if all(source.count(c) == 1 for c in cuts):
            cut = source
            for c in cuts:
                cut = cut.replace(c, "")
            return {"loads_stores": cut, "as_is": source}
    raise SystemExit("lift1d.cu holds none of the known cascade calls: update this tool")


def build_variants(out: pathlib.Path, texts: dict) -> dict:
    """The variants' libraries, compiled in parallel."""
    from repro_torch.kernels import _build

    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "lift1d.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
             str(d / "lift1d.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for fn, argtypes in _build._SIGNATURES["lift1d"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def stages(CS, libs, rng, dev, out) -> None:
    """Part 2: each launcher call of a 4-level pyramid, on each variant."""
    from repro_torch import kernels as K

    rows_out = out.setdefault("variants", [])
    for key, (rows, n0) in SHAPES.items():
        x = torch.from_numpy(rng.integers(*PCM16, (rows, n0), dtype=np.int32)).to(dev)
        for name in SCHEMES:
            kw = dict(mode="paper", scheme=name, checked=False)
            fcalls, fkeep = record(lambda: K.dwt_fwd(x, levels=LEVELS, **kw))
            icalls, ikeep = record(lambda: K.dwt_inv(fkeep[1], **kw))
            warm(dev)
            for direction, calls in (("fwd", fcalls), ("inv", icalls)):
                calls = [c for c in calls if c[0] == "lift1d"]
                row = {"shape": key, "dims": [rows, n0], "scheme": name, "direction": direction,
                       "calls": []}
                for i, call in enumerate(calls):
                    ms = {var: CS._device_ms(replay([call], lib), 1) for var, lib in libs.items()}
                    row["calls"].append(ms)
                    print(f"stages ({key}) {rows}x{n0} {name}/paper {direction} call {i + 1} of "
                          f"{len(calls)}: " + ", ".join(f"{v} {CS._fmt_ms(m)}"
                                                        for v, m in ms.items()), flush=True)
                rows_out.append(row)
            del fkeep, ikeep
        del x
        torch.cuda.empty_cache()


THREADS = "constexpr int kRunThreads = 128;\n"
SWEEP_TILES = ((4096, 4), (2048, 8), (1024, 16))  # (largest tile, blocks an SM)


def sweep(CS, rng, dev, out) -> None:
    """Part 3: thread counts x tile sizes."""
    from repro_torch import kernels as K
    from repro_torch.core import lifting as L
    from repro_torch.kernels import _build
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import dwt53 as D

    source = (_build.CSRC / "lift1d.cu").read_text()
    if source.count(THREADS) != 1:
        raise SystemExit("lift1d.cu no longer sets kRunThreads = 128: update this tool")
    texts = {}
    for threads in (64, 128, 256):
        text = source.replace(THREADS, f"constexpr int kRunThreads = {threads};\n")
        texts[f"t{threads}"] = text
        texts[f"t{threads}_cut"] = variants(text)["loads_stores"]
    libs = build_variants(ROOT / "build" / "lift1d_anatomy" / "sweep", texts)
    rows_out = out.setdefault("sweep", [])
    saved = B._RUN_MAX_TILE, B._RUN_BLOCKS_PER_SM
    try:
        for (cap, per_sm), (key, (rows, n0)) in ((c, s) for c in SWEEP_TILES
                                                  for s in SHAPES.items()):
            B._RUN_MAX_TILE, B._RUN_BLOCKS_PER_SM = cap, per_sm
            D._run_launches.cache_clear()
            D._run_plan.cache_clear()
            x = torch.from_numpy(rng.integers(*PCM16, (rows, n0), dtype=np.int32)).to(dev)
            for name in ("cdf53", "97m"):
                kw = dict(mode="paper", scheme=name, checked=False)
                want = L.dwt_fwd(x, levels=LEVELS, mode="paper", scheme=name)
                fcalls, fkeep = record(lambda: K.dwt_fwd(x, levels=LEVELS, **kw))
                icalls, ikeep = record(lambda: K.dwt_inv(want, **kw))
                row = {"shape": key, "scheme": name, "tile": D.run_launches(
                    rows, n0, LEVELS, name, dev)[0][1]}
                warm(dev)
                for var, lib in libs.items():
                    for direction, calls in (("fwd", fcalls), ("inv", icalls)):
                        run = replay(calls, lib)
                        run()
                        torch.cuda.synchronize(dev)
                        if not var.endswith("_cut"):
                            pyr = fkeep[1]
                            got = ((pyr.approx,) + pyr.details if direction == "fwd"
                                   else (ikeep[1],))
                            _equal(f"sweep {var} {key} {name} {direction}", got,
                                   (want.approx,) + want.details if direction == "fwd" else (x,))
                        row[f"{var}_{direction}_ms"] = CS._device_ms(run, len(calls))
                rows_out.append(row)
                print(f"sweep ({key}) {rows}x{n0} {name}/paper tile {row['tile']}: " + ", ".join(
                    f"{k[:-3]} {CS._fmt_ms(v)}" for k, v in row.items() if k.endswith("_ms")),
                    flush=True)
                del fkeep, ikeep, want
            del x
            torch.cuda.empty_cache()
    finally:
        B._RUN_MAX_TILE, B._RUN_BLOCKS_PER_SM = saved
        D._run_launches.cache_clear()
        D._run_plan.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("wrappers",), default="")
    ap.add_argument("--src", default="", help="import repro_torch from this src directory")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lift1d_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS  # puts this checkout's src on sys.path

    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(f"{card}; SM clock {CS._smi('clocks.sm')}; repro_torch from "
          f"{pathlib.Path(_build.__file__).parents[1]}", flush=True)
    _build.build(["lift1d", "whole2d"])
    libs = {} if args.only else build_variants(
        ROOT / "build" / "lift1d_anatomy", variants((_build.CSRC / "lift1d.cu").read_text()))
    rng = np.random.default_rng(0)
    out = {"card": card, "src": str(pathlib.Path(_build.__file__).parents[1])}
    wrappers(CS, rng, dev, out)
    if not args.only:
        stages(CS, libs, rng, dev, out)
        sweep(CS, rng, dev, out)
    out["sm_clock_at_end"] = CS._smi("clocks.sm")
    print(f"SM clock at the end: {out['sm_clock_at_end']}", flush=True)
    if args.json_out:
        path = pathlib.Path(args.json_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
