"""Where the time of the 1-D band-policy levels goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/rows1d_anatomy.py [--only wrappers|variants] [--src PATH] [--json-out PATH]

The band-policy levels are those of cdf22 (at every length) and of haar
on odd lengths: the levels whose reflection the windowed dataflow cannot
apply once a level.  A checkout runs them on whichever kernel its level
dispatcher picks: the row pass of ``csrc/whole2d.cu`` (one launch a
level), or a policy run of ``csrc/lift1d.cu`` (one launch a pyramid).

1. ``wrappers``: cdf22 at (a) 64 x 65,536, (b) 1024 x 65,536 and (c) one
   line of 11,534,336 samples, and cdf22 and haar at their odd
   neighbours (a') 64 x 65,537, (b') 1024 x 65,537, (c') 1 x 11,534,337
   (every haar level there is odd), paper rounding:

     * the 4-level pyramid through ``kernels.dwt_fwd`` / ``dwt_inv``
       (unchecked), and each of its levels alone through
       ``kernels.dwt_fwd_1d`` / ``dwt_inv_1d``: the CUDA-event median of
       up to 20 calls, the device ms of the kernels a call launches
       (``torch.profiler``, read from whole profiles only), the host us
       per call (calls enqueued back to back, then one sync) and the
       launches a call counts (fewer calls where one takes tens of ms);
       every output checked bit-equal against the plain oracle
       (``core.lifting``) on the card;
     * the bound: a level reads its input once and writes its bands once
       (8 bytes a sample); a pyramid as one run reads the level-0 signal
       once and writes every band once (8 bytes a level-0 sample).

2. ``variants``: the sources of the kernels the pyramids launched, built
   as they are and with the lifting cut out (``loads_stores``: the row
   pass's ``cascade_policy`` calls, or the run kernels' ``lift_row``
   calls, removed; the cut variants compute wrong bands: they only
   time), into ``build/rows1d_anatomy/``; each ctypes call of one
   unchecked 4-level ``dwt_fwd`` / ``dwt_inv`` replayed alone on each
   variant: device ms, so the share of loads and stores is known
   (``--only variants`` runs this part alone).

Device ms are read only from profiles that hold every kernel record of
their calls (``chip_smoke._pass_ms``), else reported as not measured.
``--src PATH`` imports ``repro_torch`` (and its ``csrc``) from another
checkout's ``src``, so one call times the parent commit and this one on
one card: parent, change, change, parent.
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
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

SHAPES = {"a": (64, 65536), "b": (1024, 65536), "c": (1, 2048 * 5632),
          "a'": (64, 65537), "b'": (1024, 65537), "c'": (1, 2048 * 5632 + 1)}
# (shape, scheme): cdf22 everywhere, haar where every level is odd
CASES = tuple((k, "cdf22") for k in SHAPES) + tuple((k, "haar") for k in SHAPES if "'" in k)
LEVELS = 4
MODE = "paper"
PCM16 = (-32768, 32768)
BUDGET_MS = 1500.0  # timed calls of one measurement take about this long

# the cascade calls a variant cuts: the row pass's (passes.cuh, in
# row_fwd_kernel / row_inv_kernel) and the run kernels' (lift1d.cu)
CUTS = {
    "whole2d": ("passes.cuh", "  cascade_policy<false>(buf, 1, W, nr, W, c);\n", 2),
    "lift1d": ("lift1d.cu", None, 2),
}


def _reps(fn, most: int) -> int:
    """Calls of ``fn`` that fit BUDGET_MS, from 3 to ``most``."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return int(max(3, min(most, BUDGET_MS // max(ms, 1e-3))))


def _timed(CS, fn, dev) -> dict:
    """Events ms, device ms by kernel, host us a call, launches a call."""
    from repro_torch import kernels as K

    reps = _reps(fn, 20)
    K.launches.reset()
    fn()
    launches = sum(K.launches.snapshot().values())
    K.launches.reset()
    by_kernel = CS._pass_ms(fn, reps=min(reps, 5), per_call=launches, warm=1)
    vals = list(by_kernel.values())
    return {"ms": CS._median_ms(fn, reps),
            "host_us": CS._host_us(fn, dev, calls=_reps(fn, 200)),
            "device_ms_by_kernel": by_kernel,
            "device_ms": sum(vals) if vals and all(isinstance(v, float) for v in vals) else None,
            "launches": launches}


def _fmt(row) -> str:
    dev = f"{row['device_ms']:.4f}" if row["device_ms"] is not None else "not measured"
    return (f"{row['ms']:.4f} ms, device {dev}, host {row['host_us']:.1f} us, "
            f"{row['launches']} launches")


def _equal(label, got, want) -> None:
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: kernel != plain oracle")


def wrappers(CS, A, rng, dev, out) -> None:
    from repro_torch import kernels as K
    from repro_torch.core import lifting as L

    rows_out = out.setdefault("wrappers", [])
    for key, name in CASES:
        rows, n0 = SHAPES[key]
        x = torch.from_numpy(rng.integers(*PCM16, (rows, n0), dtype=np.int32)).to(dev)
        kw = dict(mode=MODE, scheme=name, checked=False)
        want = L.dwt_fwd(x, levels=LEVELS, mode=MODE, scheme=name)
        pyr = K.dwt_fwd(x, levels=LEVELS, **kw)
        _equal(f"{key} {name} dwt_fwd", (pyr.approx,) + pyr.details,
               (want.approx,) + want.details)
        _equal(f"{key} {name} dwt_inv", [K.dwt_inv(want, **kw)], [x])
        del pyr
        row = {"shape": key, "dims": [rows, n0], "scheme": name, "mode": MODE,
               "run_bound_ms": 8 * rows * n0 / CS.PEAK_BYTES_PER_S * 1e3,
               "plans": [K.plan_1d(v, dev, name) for v in _lens(n0)]}
        A.warm(dev)
        row["run_fwd"] = _timed(CS, lambda: K.dwt_fwd(x, levels=LEVELS, **kw), dev)
        row["run_inv"] = _timed(CS, lambda: K.dwt_inv(want, **kw), dev)
        for d in ("fwd", "inv"):
            print(f"pyramid ({key}) {rows}x{n0} {name}/{MODE} {d} x{LEVELS}: "
                  f"{_fmt(row['run_' + d])}; run bound {row['run_bound_ms']:.4f} ms "
                  f"(plans {row['plans']})", flush=True)
        xs = x
        for lv in range(LEVELS):
            d = want.details[LEVELS - 1 - lv]
            n = xs.shape[-1]
            s = K.dwt_fwd_1d(xs, **kw)[0]
            lvl = {"level": lv, "n": n, "bound_ms": 8 * rows * n / CS.PEAK_BYTES_PER_S * 1e3,
                   "fwd": _timed(CS, lambda: K.dwt_fwd_1d(xs, **kw), dev),
                   "inv": _timed(CS, lambda: K.dwt_inv_1d(s, d, **kw), dev)}
            row.setdefault("levels", []).append(lvl)
            for dd in ("fwd", "inv"):
                print(f"  level {lv} ({key}) {rows}x{n} {name} {dd}: {_fmt(lvl[dd])}; "
                      f"bound {lvl['bound_ms']:.4f} ms", flush=True)
            xs = s
        for d in ("fwd", "inv"):
            tot = [lv[d]["device_ms"] for lv in row["levels"]]
            row[f"levels_{d}_device_ms"] = sum(tot) if None not in tot else None
            row[f"levels_{d}_ms"] = sum(lv[d]["ms"] for lv in row["levels"])
            print(f"  levels alone ({key}) {name} {d}, summed: {row[f'levels_{d}_ms']:.4f} ms, "
                  f"device {CS._fmt_ms(row[f'levels_{d}_device_ms'])}", flush=True)
        rows_out.append(row)
        del x, want, xs, s
        torch.cuda.empty_cache()


def _lens(n):
    out = [n]
    for _ in range(LEVELS - 1):
        out.append(out[-1] - out[-1] // 2)
    return out


def variant_texts(csrc: pathlib.Path, lib: str) -> dict:
    """{variant: {file: text}} for library ``lib``: as it is, and with the
    lifting calls cut."""
    fname, line, count = CUTS[lib]
    text = (csrc / fname).read_text()
    if line is None:  # the run kernels: every call of lift_row
        lines = [ln for ln in text.splitlines(keepends=True)
                 if ln.lstrip().startswith("lift_row")]
        cut = "".join(ln for ln in text.splitlines(keepends=True) if ln not in lines)
    else:
        lines = [line] * text.count(line)
        cut = text.replace(line, "")
    if len(lines) != count:
        raise SystemExit(f"{fname}: {len(lines)} lifting calls, want {count}: update this tool")
    return {"as_is": {}, "loads_stores": {fname: cut}}


def build_variants(CS, csrc: pathlib.Path, libs: set, out: pathlib.Path) -> dict:
    """{(lib, variant): CDLL}, one nvcc each, started together."""
    from repro_torch.kernels import _build

    procs = {}
    for lib in libs:
        for var, files in variant_texts(csrc, lib).items():
            d = out / f"{lib}_{var}"
            if d.exists():
                shutil.rmtree(d)
            shutil.copytree(csrc, d)
            for fname, text in files.items():
                (d / fname).write_text(text)
            procs[(lib, var)] = (d, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
                 str(d / f"{lib}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    loaded = {}
    for key, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {key} failed:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, argtypes in _build._SIGNATURES[key[0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        loaded[key] = lib
    return loaded


def variants(CS, A, rng, dev, out) -> None:
    """Part 2: each launcher call of a 4-level pyramid on each variant."""
    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    recorded = []
    for key, name in CASES:
        rows, n0 = SHAPES[key]
        x = torch.from_numpy(rng.integers(*PCM16, (rows, n0), dtype=np.int32)).to(dev)
        kw = dict(mode=MODE, scheme=name, checked=False)
        fcalls, fkeep = A.record(lambda: K.dwt_fwd(x, levels=LEVELS, **kw))
        icalls, ikeep = A.record(lambda: K.dwt_inv(fkeep[1], **kw))
        recorded.append((key, name, fcalls, icalls, (x, fkeep, ikeep)))
    libs = build_variants(CS, _build.CSRC, {c[0] for r in recorded for c in r[2] + r[3]},
                          ROOT / "build" / "rows1d_anatomy")
    rows_out = out.setdefault("variants", [])
    A.warm(dev)
    for key, name, fcalls, icalls, _ in recorded:
        rows, n0 = SHAPES[key]
        for direction, calls in (("fwd", fcalls), ("inv", icalls)):
            row = {"shape": key, "dims": [rows, n0], "scheme": name, "direction": direction,
                   "calls": []}
            for call in calls:
                ms = {var: CS._device_ms(A.replay([call], libs[(call[0], var)]), 1)
                      for var in ("as_is", "loads_stores")}
                row["calls"].append({"fn": call[1], **ms})
            for var in ("as_is", "loads_stores"):
                vals = [c[var] for c in row["calls"]]
                row[var] = sum(vals) if None not in vals else None
            rows_out.append(row)
            share = (f"{row['loads_stores'] / row['as_is']:.3f}"
                     if row["as_is"] and row["loads_stores"] else "not measured")
            print(f"variants ({key}) {rows}x{n0} {name} {direction}: {len(calls)} calls "
                  f"({calls[0][1]}), device as is {CS._fmt_ms(row['as_is'])} ms, loads and "
                  f"stores only {CS._fmt_ms(row['loads_stores'])} ms (share {share})",
                  flush=True)
    del recorded
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("wrappers", "variants"), default="")
    ap.add_argument("--src", default="", help="import repro_torch from this src directory")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rows1d_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS  # puts this checkout's src on sys.path
    import lift1d_anatomy as A

    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    src = str(pathlib.Path(_build.__file__).parents[1])
    print(f"{card}; SM clock {CS._smi('clocks.sm')}; repro_torch from {src}", flush=True)
    _build.build(["lift1d", "whole2d"])
    rng = np.random.default_rng(0)
    out = {"card": card, "src": src}
    if args.only != "variants":
        wrappers(CS, A, rng, dev, out)
    if args.only != "wrappers":
        variants(CS, A, rng, dev, out)
    out["sm_clock_at_end"] = CS._smi("clocks.sm")
    print(f"SM clock at the end: {out['sm_clock_at_end']}", flush=True)
    if args.json_out:
        path = pathlib.Path(args.json_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
