"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N] [--requests N] [--json-out PATH]

Phases (any failure raises and the script exits nonzero):

1. Print the card's name and power limit and the torch version; build
   every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   in parallel) and print the build time.
2. Hold each of the four 2-D kernels (whole-image forward / inverse,
   halo-tiled forward / inverse) against its plain PyTorch version on the
   card with ``torch.equal``: 4 schemes x 2 rounding modes, odd sizes,
   multi-tile grids, int32 extremes, and lines too long for shared memory.
3. Serve: ``WaveletServeEngine`` with 1024^2 and 2048^2 buckets, 8 slots,
   5 levels of the reversible 5/3 lift (cdf53, jpeg2000 rounding — JPEG
   2000 Part 1's lossless path) on 8-bit samples with the DC level shift,
   a quarter of the requests undersized.  Every response is
   reconstructed on the card with ``dwt_inv_2d_multi`` and must equal its
   request after the crop; each bucket's first response must equal the
   plain oracle.  The launch counters are reset just before this phase
   and read just after it: every kernel must have launched.
4. Time each kernel with CUDA events at the shapes the serve path gives
   it (one 2048^2 batch of 8 slots, every level), beside its plain
   version and its memory bound, comparing outputs once more.
5. Print the ``{"kernels": [...]}`` line, the card line, and last the
   ``{"ok": true, ...}`` line.  ``--json-out PATH`` also writes the whole
   record (every batch latency, every level's time) to PATH.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# float32 non-tensor-core rate, the closest published entry to the int32
# add/shift work of a lifting step
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)

KERNELS = {
    "whole2d_fwd": ("src/repro_torch/csrc/whole2d.cu", "src/repro/kernels/fused2d.py:107"),
    "whole2d_inv": ("src/repro_torch/csrc/whole2d.cu", "src/repro/kernels/fused2d.py:133"),
    "tiled2d_fwd": ("src/repro_torch/csrc/tiled2d.cu", "src/repro/kernels/tiled2d.py:141"),
    "tiled2d_inv": ("src/repro_torch/csrc/tiled2d.cu", "src/repro/kernels/tiled2d.py:183"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def _equal_or_raise(label, got, want) -> int:
    """Raise unless every pair is bit-equal; returns the max |got - want|."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{label}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: kernel != plain version (max |err| {err})")
    return err


# ---------------------------------------------------------------------------
# Phase 2: parity sweep.
# ---------------------------------------------------------------------------


def parity_sweep(rng, dev) -> dict:
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused2d as F
    from repro_torch.kernels import tiled2d as T

    shapes = [(2, 2), (3, 3), (7, 9), (33, 17), (257, 383), (512, 512)]
    counts = {k: 0 for k in KERNELS}
    for sch in SCHEMES:
        sc = S.get_scheme(sch)
        for mode in MODES:
            cases = [(2, h, w, kind) for h, w in shapes for kind in ("rand", "min", "max")]
            if mode == "paper":  # lines longer than shared memory: global staging
                cases += [(1, 60001, 3, "rand"), (1, 3, 60001, "rand")]
            for b, h, w, kind in cases:
                if kind == "rand":
                    x = rng.integers(-(1 << 20), 1 << 20, (b, h, w), dtype=np.int32)
                else:
                    x = np.full((b, h, w), I32.min if kind == "min" else I32.max, np.int32)
                xt = torch.from_numpy(x).to(dev)
                label = f"{sch}/{mode}/{b}x{h}x{w}/{kind}"
                want = F._fwd2d_math(xt, mode, sch)
                _equal_or_raise("whole2d_fwd " + label, F.fwd2d_whole_cuda(xt, mode, sch), want)
                _equal_or_raise("whole2d_inv " + label, [F.inv2d_whole_cuda(*want, mode, sch)],
                                [F._inv2d_math(*want, mode, sch)])
                counts["whole2d_fwd"] += 1
                counts["whole2d_inv"] += 1
                if not (sc.can_window(h) and sc.can_window(w)) or max(h, w) > 1000:
                    continue
                for th, tw in ((4, 6), (64, 64)):
                    lab = f"{label}/tile{th}x{tw}"
                    _equal_or_raise("tiled2d_fwd " + lab,
                                    T.fwd2d_tiled_cuda(xt, mode, th, tw, sch),
                                    T.fwd2d_tiled_plain(xt, mode, th, tw, sch))
                    _equal_or_raise("tiled2d_inv " + lab,
                                    [T.inv2d_tiled_cuda(*want, mode, th, tw, sch)],
                                    [T.inv2d_tiled_plain(*want, mode, th, tw, sch)])
                    counts["tiled2d_fwd"] += 1
                    counts["tiled2d_inv"] += 1
    torch.cuda.synchronize(dev)
    return counts


# ---------------------------------------------------------------------------
# Phase 3: the serve route.
# ---------------------------------------------------------------------------

BUCKETS = ((1024, 1024), (2048, 2048))
SLOTS, LEVELS, SCHEME, MODE = 8, 5, "cdf53", "jpeg2000"


def make_requests(rng, n):
    from repro_torch.serve import TransformRequest

    reqs = []
    for uid in range(n):
        bh, bw = BUCKETS[uid % 2]
        if uid % 4 == 3:  # undersized: rides the smallest bucket holding it
            h, w = int(rng.integers(bh // 2 + 1, bh)), int(rng.integers(bw // 2 + 1, bw))
        else:
            h, w = bh, bw
        # 8-bit samples with the DC level shift applied: -128 .. 127
        img = rng.integers(-128, 128, (h, w), dtype=np.int32)
        reqs.append(TransformRequest(uid=uid, image=img))
    return reqs


def serve(rng, dev, n_requests) -> dict:
    from repro_torch import kernels as K
    from repro_torch.core import lifting as L
    from repro_torch.serve import WaveletServeEngine, crop_result

    eng = WaveletServeEngine(buckets=BUCKETS, batch_slots=SLOTS, levels=LEVELS,
                             scheme=SCHEME, mode=MODE, device=str(dev))
    t = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t
    reqs = make_requests(rng, n_requests)
    for r in reqs:
        eng.submit(r)

    K.launches.reset()
    lat_ms, served = [], []
    t_all = time.perf_counter()
    while eng.scheduler.pending():
        t = time.perf_counter()
        done = eng.step()
        torch.cuda.synchronize(dev)
        lat_ms.append((time.perf_counter() - t) * 1e3)
        served.extend(done)
    serve_s = time.perf_counter() - t_all
    fwd_counts = K.launches.snapshot()

    checked_oracle = set()
    for r in served:
        if r.error is not None or not r.done:
            raise AssertionError(f"request {r.uid} failed: {r.error}")
        ll_shape, det = L.band_shapes_2d(*r.bucket, LEVELS)
        if tuple(r.pyramid.ll.shape) != ll_shape or [
            tuple(tuple(b.shape) for b in lvl) for lvl in r.pyramid.details
        ] != [tuple(s) for s in det]:
            raise AssertionError(f"request {r.uid}: pyramid shapes differ from band_shapes_2d")
        xr = crop_result(K.dwt_inv_2d_multi(r.pyramid, mode=MODE, scheme=SCHEME), r)
        if not torch.equal(xr, torch.from_numpy(r.image).to(dev)):
            raise AssertionError(f"request {r.uid}: reconstruction is not bit-exact")
        if r.bucket not in checked_oracle:  # the plain oracle on the same padded input
            padded = torch.zeros(r.bucket, dtype=torch.int32, device=dev)
            padded[: r.image.shape[0], : r.image.shape[1]] = torch.from_numpy(r.image).to(dev)
            want = L.dwt_fwd_2d_multi(padded, levels=LEVELS, mode=MODE, scheme=SCHEME)
            got_leaves = [r.pyramid.ll] + [b for lvl in r.pyramid.details for b in lvl]
            want_leaves = [want.ll] + [b for lvl in want.details for b in lvl]
            _equal_or_raise(f"serve oracle {r.bucket}", got_leaves, want_leaves)
            checked_oracle.add(r.bucket)
    torch.cuda.synchronize(dev)
    counts = K.launches.snapshot()
    if len(served) != n_requests:
        raise AssertionError(f"served {len(served)} of {n_requests} requests")
    for k in KERNELS:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the serve path: {counts}")
    plans = {
        f"{h}x{w}": [K.plan_2d(h >> lv, w >> lv, dev, SCHEME) for lv in range(LEVELS)]
        for h, w in BUCKETS
    }
    # where one 2048^2 batch's time goes: the phases of engine.step()
    # (host assembly, host-to-device copy, transform) and one client
    # reconstruction, each timed alone with a device sync
    big = [r for r in served if r.bucket == BUCKETS[-1]][:SLOTS]
    t = time.perf_counter()
    batch = np.zeros((SLOTS,) + BUCKETS[-1], np.int32)
    for i, r in enumerate(big):
        batch[(i,) + tuple(slice(0, s) for s in r.image.shape)] = r.image
    host_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    xb = torch.from_numpy(batch).to(dev)
    torch.cuda.synchronize(dev)
    h2d_ms = (time.perf_counter() - t) * 1e3
    fwd_ms = _median_ms(lambda: K.dwt_fwd_2d_multi(xb, levels=LEVELS, mode=MODE, scheme=SCHEME), 10)
    inv_ms = _median_ms(lambda: K.dwt_inv_2d_multi(big[0].pyramid, mode=MODE, scheme=SCHEME), 10)
    lat = sorted(lat_ms)
    return {
        "warmup_s": warm_s,
        "requests": len(served),
        "undersized": sum(r.padded for r in served),
        "batches": len(lat_ms),
        "serve_s": serve_s,
        "requests_per_s": len(served) / serve_s,
        "batch_ms_p50": statistics.median(lat),
        "batch_ms_p99": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))],
        "batch_ms": lat_ms,
        "launches_forward": fwd_counts,
        "launches": counts,
        "plans": plans,
        "breakdown_2048_ms": {"host_assembly": host_ms, "host_to_device": h2d_ms,
                              "forward_all_levels": fwd_ms, "inverse_one_request": inv_ms},
    }


# ---------------------------------------------------------------------------
# Phase 4: kernel times at the serve path's shapes.
# ---------------------------------------------------------------------------


def _median_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_kernels(rng, dev) -> list:
    from repro_torch.core import schemes as S
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import fused2d as F
    from repro_torch.kernels import tiled2d as T

    sch = S.get_scheme(SCHEME)
    h0, w0 = BUCKETS[-1]
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "err": 0, "levels": []}
           for k in KERNELS}
    # a level lifts every row pair, then every column pair: H*W pairs in all
    ops_per_sample = sum(sch.pair_op_counts()[k] for k in ("adders", "shifters"))
    for lv in range(LEVELS):
        h, w = h0 >> lv, w0 >> lv
        tiled = F.plan_2d(h, w, dev, SCHEME).startswith("tiled")
        x = torch.from_numpy(rng.integers(-128, 128, (SLOTS, h, w), dtype=np.int32)).to(dev)
        bands = F._fwd2d_math(x, MODE, SCHEME)
        if tiled:
            th, tw = B.pick_tile(h, w, sch.halo, dev)
            runs = {
                "tiled2d_fwd": (lambda: T.fwd2d_tiled_cuda(x, MODE, th, tw, SCHEME),
                                lambda: T.fwd2d_tiled_plain(x, MODE, th, tw, SCHEME)),
                "tiled2d_inv": (lambda: [T.inv2d_tiled_cuda(*bands, MODE, th, tw, SCHEME)],
                                lambda: [T.inv2d_tiled_plain(*bands, MODE, th, tw, SCHEME)]),
            }
        else:
            runs = {
                "whole2d_fwd": (lambda: F.fwd2d_whole_cuda(x, MODE, SCHEME),
                                lambda: F._fwd2d_math(x, MODE, SCHEME)),
                "whole2d_inv": (lambda: [F.inv2d_whole_cuda(*bands, MODE, SCHEME)],
                                lambda: [F._inv2d_math(*bands, MODE, SCHEME)]),
            }
        for name, (kern, plain) in runs.items():
            e = per[name]
            err = _equal_or_raise(f"{name} {SLOTS}x{h}x{w}", kern(), plain())
            ms = _median_ms(kern, 30)
            pms = _median_ms(plain, 5)
            nbytes = 2 * SLOTS * h * w * 4  # read every sample once, write every band once
            e["ms"] += ms
            e["plain_ms"] += pms
            e["bytes"] += nbytes
            e["ops"] += int(ops_per_sample * SLOTS * h * w)
            e["err"] = max(e["err"], err)
            e["levels"].append({"shape": [SLOTS, h, w], "ms": ms, "plain_ms": pms,
                                "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3})
    out = []
    for name, (source, replaces) in KERNELS.items():
        e = per[name]
        t_bytes = e["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = e["ops"] / PEAK_OPS_PER_S * 1e3
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "levels": e["levels"],
        })
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--json-out", default="", help="also write the full record here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda})", flush=True)

    from repro_torch.kernels import _build

    t = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t:.2f} s for {list(_build.SOURCES)}", flush=True)
    for name in _build.SOURCES:
        regs = [ln.strip() for ln in _build.build_log(name).splitlines() if "registers" in ln]
        print(f"  {name}: {regs}")

    rng = np.random.default_rng(args.seed)
    t = time.perf_counter()
    checks = parity_sweep(rng, dev)
    print(f"parity: kernel == plain version on every case {checks} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    srv = serve(rng, dev, args.requests)
    for bucket, plan in srv["plans"].items():
        print(f"plan_2d {bucket}: {plan}")
    print(f"serve: {srv['requests']} requests ({srv['undersized']} undersized) in "
          f"{srv['batches']} batches, {srv['requests_per_s']:.2f} req/s, batch latency "
          f"p50 {srv['batch_ms_p50']:.2f} ms p99 {srv['batch_ms_p99']:.2f} ms; every "
          f"response reconstructs bit-exact", flush=True)
    print(f"launches on the serve path: forward {srv['launches_forward']}, "
          f"with reconstruction {srv['launches']}")
    print("one 2048^2 batch, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in srv["breakdown_2048_ms"].items()))

    kernels = time_kernels(rng, dev)
    for k in kernels:
        k["launches"] = srv["launches"][k["name"]]
        for lv in k.pop("levels"):
            print(f"  {k['name']} {lv['shape']}: {lv['ms']:.4f} ms (plain {lv['plain_ms']:.3f} ms,"
                  f" bound {lv['bound_ms']:.4f} ms)")
    if args.json_out:
        record = {"card": card, "torch": torch.__version__, "seed": args.seed,
                  "parity_cases": checks, "serve": srv, "kernels": kernels}
        out = pathlib.Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
