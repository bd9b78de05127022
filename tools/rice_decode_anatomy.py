"""Where the time of the Rice decode goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/rice_decode_anatomy.py [--only wrappers,variants] [--src PATH]
                                         [--json-out PATH]

Two sets of bands, each coded on the card by ``codec.rice.encode_bands``:
the 16 bands of one 8 x 2048^2 cdf53 / jpeg2000 batch, 5 levels (half
random, half smooth 8-bit images, as ``chip_smoke.py``'s ``time_rice``
and ``tools/rice_anatomy.py``), and the 29 bands of one 4 x (64, 512, 512)
``KIND_ND`` batch, 4 levels (two 12-bit CT-like phantoms with +-2 noise
and two volumes of uniform 12-bit noise, as the 3-D encoded serve path's
largest bucket).

1. ``wrappers``: the decode as the imported ``repro_torch`` has it.
   Where ``codec.rice`` has no ``decode_bands`` (the parent: one launch a
   band), for each band the kernel's CUDA-event median and device ms
   (``torch.profiler``, read through ``chip_smoke._pass_ms``) with its
   inputs already on the card, and the host us of one ``decode_band``
   call (host bytes to the returned tensor); then all bands back to back
   (events, device, and the host us of the ``decode_band`` calls).  Where
   it has ``decode_bands`` (one launch over every band): the launcher
   with the staged bytes already on the card (events, device), the host
   us of one ``decode_bands`` call and of its host stages (table checks,
   staging into pinned memory, the copy to the card).  Every decode is
   checked equal to the coded bands.  Each kernel's occupancy: the blocks
   an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) times
   its warps over the SM's 64, and the share of it the launch's grid can
   fill; the card's own achieved occupancy needs a profiler counter that
   the machine does not give (no ``ncu``).
2. ``variants`` (``decode_bands`` only): ``csrc/rice.cu`` built as it is
   and with stages of the decode kernel cut out, into
   ``build/rice_decode_anatomy/`` (the cut variants write wrong values:
   they only time), each through its C launcher on the 16 bands:

     loads     each warp finds its block's bytes and stages them in
               shared memory, then stores its row of zeros
     rounds    + the synchronising rounds: every lane's exact first code
               and code count (the values are not decoded)
     as_is     + the scan of the counts and the value walk: the kernel as
               committed, checked equal to the bands
     host_offs as_is with each tile's first byte taken from a table that
               a host ``np.cumsum`` over every block's length made (its
               time is given beside it) instead of the look-back over
               tiles, checked equal too
     bounds6   as_is held to 6 thread blocks an SM (``__launch_bounds__``),
               checked equal
     thread    the other exact form, ``decode_thread_kernel`` (kept here,
               not in rice.cu): one thread a Rice block walking its 256
               codes through a 64-bit buffer fed from 16-byte loads, 256
               blocks a tile; checked equal
     thread_host_offs  thread with the host's offsets, checked equal

``--src PATH`` imports ``repro_torch`` from another checkout's ``src``
(the parent commit unpacked beside this one) for part 1, so one call
times both on one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OCCUPANCY = ('\nextern "C" int anatomy_occupancy(int threads, int* blocks) {\n'
             "  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, rice::KERNEL, threads,"
             " 0);\n}\n")
PARENT_THREADS, THREADS = 32, 256  # the parent's 32 blocks a thread block; 8 warps
SM_WARPS = 64


def batch_2d(dev):
    import chip_smoke as CS
    from repro_torch import kernels as K

    rng = np.random.default_rng(0)
    h, w = CS.BUCKETS[-1]
    imgs = [rng.integers(-128, 128, (h, w), dtype=np.int32) if i % 2
            else CS.smooth_image(rng, h, w) for i in range(CS.SLOTS)]
    x = torch.from_numpy(np.stack(imgs)).to(dev)
    pyr = K.dwt_fwd_2d_multi(x, levels=CS.LEVELS, mode=CS.MODE, scheme=CS.SCHEME)
    return [b.reshape(-1) for b in [pyr.ll] + [b for lvl in pyr.details for b in lvl]]


def batch_3d(dev):
    import chip_smoke as CS
    from repro_torch import kernels as K

    rng = np.random.default_rng(1)
    vols = [CS.phantom(rng, CS.VOLUME, dev, noise=2) if i % 2
            else torch.from_numpy(rng.integers(*CS.CT12, CS.VOLUME, dtype=np.int32)).to(dev)
            for i in range(CS.VOL_SLOTS)]
    pyr = K.dwt_fwd_nd(torch.stack(vols), levels=CS.VOL_LEVELS, mode=CS.VOL_MODE,
                       scheme=CS.VOL_SCHEME)
    return [b.reshape(-1) for b in CS._leaves3(pyr)]


def host_us(fn, calls: int) -> float:
    """Host us per call: ``calls`` calls back to back after two warm
    ones, then one sync."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def occupancy(dev, source: str, kernel: str, threads: int, grid: int,
              out: pathlib.Path) -> dict:
    """``kernel``'s blocks per SM as ``source`` builds it, its occupancy,
    and the share of it a grid of ``grid`` blocks can fill."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    (out / "rice.cu").write_text(source + OCCUPANCY.replace("KERNEL", kernel))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"),
                           str(out / "rice.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc (occupancy helper) failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    blocks = ctypes.c_int(0)
    rc = lib.anatomy_occupancy(threads, ctypes.byref(blocks))
    if rc:
        raise SystemExit(f"occupancy query failed: CUDA error {rc}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = blocks.value * threads // 32
    return {"kernel": kernel, "blocks_per_sm": blocks.value, "warps_per_sm": per_sm,
            "occupancy": per_sm / SM_WARPS,
            "grid_fill": min(1.0, grid / (blocks.value * sms)) if blocks.value else 0.0}


def parent_wrappers(label, bands, coded, dev) -> dict:
    """One launch a band: per band and all bands, events, device, host."""
    import chip_smoke as CS
    from repro_torch.codec import rice as R

    rows, ins = [], []
    for b, (pay, ks, lens) in zip(bands, coded):
        offs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))[:-1]])
        ins.append((torch.from_numpy(np.frombuffer(pay, np.uint8).copy()).to(dev),
                    torch.from_numpy(offs).to(dev), torch.from_numpy(lens.astype(np.int32)).to(dev),
                    torch.from_numpy(ks.copy()).to(dev)))
    for i, (b, c, inp) in enumerate(zip(bands, coded, ins)):
        if not torch.equal(R.rice_decode_cuda(*inp)[: b.numel()], b):
            raise SystemExit(f"{label} band {i}: the parent's kernel differs from the band")
        if not torch.equal(R.decode_band(*c, b.numel(), device=dev), b):
            raise SystemExit(f"{label} band {i}: decode_band differs from the band")
        rows.append({"band": i, "values": b.numel(), "blocks": len(c[1]),
                     "payload_bytes": len(c[0]),
                     "ms": CS._median_ms(lambda: R.rice_decode_cuda(*inp), 20),
                     "device_ms": CS._device_ms(lambda: R.rice_decode_cuda(*inp), 1),
                     "host_us": host_us(lambda: R.decode_band(*c, b.numel(), device=dev), 10)})
    everything = lambda: [R.rice_decode_cuda(*inp) for inp in ins]  # noqa: E731
    calls = lambda: [R.decode_band(*c, b.numel(), device=dev)  # noqa: E731
                     for b, c in zip(bands, coded)]
    return {"bands": rows, "ms": CS._median_ms(everything, 10),
            "device_ms": CS._device_ms(everything, len(bands)),
            "host_us": host_us(calls, 5),
            "launches": len(bands)}


def new_wrappers(label, bands, coded, dev) -> dict:
    """One launch over every band: the launcher with the bytes staged on
    the card, the host stages, and the whole ``decode_bands`` call."""
    import chip_smoke as CS
    from repro_torch.codec import rice as R

    items = [(c[0], c[1], c[2], b.numel()) for b, c in zip(bands, coded)]
    got = R.decode_bands(items, device=dev)
    for i, (g, b) in enumerate(zip(got, bands)):
        if not torch.equal(g, b):
            raise SystemExit(f"{label} band {i}: decode_bands differs from the band")
    checked = [R.check_band(*it) for it in items]
    host, table, nb = R.stage_bands(checked)
    staged = host.to(dev)
    launch = lambda: R.rice_decode_cuda(staged, table, nb)  # noqa: E731
    out = launch()
    torch.cuda.synchronize()
    firsts = table[R.TABLE_HEAD:R.TABLE_HEAD + len(bands)]
    for i, (f, b) in enumerate(zip(firsts, bands)):
        if not torch.equal(out[256 * int(f): 256 * int(f) + b.numel()], b):
            raise SystemExit(f"{label} band {i}: the launcher differs from the band")
    pinned = torch.empty(host.numel(), dtype=torch.uint8, pin_memory=True)
    return {"ms": CS._median_ms(launch, 20), "device_ms": CS._pass_ms(launch, per_call=1),
            "host_us": host_us(lambda: R.decode_bands(items, device=dev), 10),
            "stages_host_us": {
                "check_band": host_us(lambda: [R.check_band(*it) for it in items], 10),
                "stage_bands": host_us(lambda: R.stage_bands(checked), 10),
                "copy_to_card": host_us(lambda: staged.copy_(pinned, non_blocking=True), 10),
                "launch": host_us(launch, 10)},
            "staged_bytes": host.numel(), "blocks": nb, "launches": 1}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="wrappers,variants")
    ap.add_argument("--src", default="", help="import repro_torch from this src directory")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rice_decode_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS  # puts this checkout's src on sys.path

    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.codec import rice as R
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(f"card: {card}; repro_torch from {pathlib.Path(_build.__file__).parents[1]}", flush=True)
    parts = args.only.split(",")
    batched = hasattr(R, "decode_bands")
    record = {"card": card, "src": str(pathlib.Path(_build.__file__).parents[1]),
              "api": "decode_bands" if batched else "decode_band", "sets": {}}
    for label, make in (("16 bands of 8 x 2048^2", batch_2d), ("29 bands of 4 x (64, 512, 512)",
                                                                batch_3d)):
        bands = make(dev)
        coded = R.encode_bands(bands)
        nb = sum(len(c[1]) for c in coded)
        payload = sum(len(c[0]) for c in coded)
        values = sum(b.numel() for b in bands)
        nbytes = payload + 3 * nb + 4 * values
        rec = {"values": values, "blocks": nb, "payload_bytes": payload,
               "bound_ms": nbytes / CS.PEAK_BYTES_PER_S * 1e3}
        print(f"{label}: {values} values, {nb} blocks, {payload} payload bytes, byte bound "
              f"{rec['bound_ms']:.4f} ms", flush=True)
        if "wrappers" in parts:
            source = (_build.CSRC / "rice.cu").read_text()
            occ = ROOT / "build" / "rice_decode_anatomy" / "occupancy"
            if batched:
                rec["wrappers"] = new_wrappers(label, bands, coded, dev)
                rec["occupancy"] = [
                    occupancy(dev, source, "decode_kernel", THREADS, -(-nb // TILE["warp"]),
                              occ / "warp"),
                    occupancy(dev, thread_form(source), "decode_thread_kernel", THREADS,
                              -(-nb // THREADS), occ / "thread")]
            else:
                rec["wrappers"] = parent_wrappers(label, bands, coded, dev)
                grid = max(-(-len(c[1]) // PARENT_THREADS) for c in coded)
                rec["occupancy"] = occupancy(dev, source, "decode_kernel", PARENT_THREADS, grid,
                                             occ / "parent")
            wr = rec["wrappers"]
            print(f"  {record['api']}: {wr['launches']} launches, events {wr['ms']:.4f} ms, "
                  f"device {CS._fmt_ms(wr['device_ms'])} ms, host {wr['host_us']:.1f} us; "
                  f"occupancy {rec['occupancy']}", flush=True)
            for row in wr.get("bands", []):
                print(f"    band {row['band']:2d} {row['values']:8d} values {row['blocks']:6d} "
                      f"blocks {row['payload_bytes']:8d} B: events {row['ms']:.4f} ms, device "
                      f"{CS._fmt_ms(row['device_ms'])} ms, host {row['host_us']:.1f} us")
            if "stages_host_us" in wr:
                print("    host us by stage: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in wr["stages_host_us"].items()))
        record["sets"][label] = rec
        del bands, coded
        torch.cuda.empty_cache()
    if "variants" in parts and batched:
        record["variants"] = variants_section(dev)
    if args.json_out:
        out = pathlib.Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    print(card)
    return 0


# stage cuts of the warp kernel, and the switch to the thread kernel
ROUNDS = ("    // the rounds: each lane's exact first code and its code count\n",
          "    __syncwarp();\n    const int32_t* v = r + skew(lane * kPerLane);\n")
LOADS = ("    for (int i = lane; i < kRow; i += kLanes) r[i] = 0;\n"
         "    r[lane] = static_cast<int32_t>(sw[lane]) + kj;\n"
         "    __syncwarp();\n    const int32_t* v = r + skew(lane * kPerLane);\n")
WALK = ("    for (int p = start, i = first; p < seg1 && i < kBlock; ++i) {\n",
        "      p += len;\n    }\n")
WALK_CUT = "    if (lane == 0) r[0] = first + start;\n"
# the other exact form, measured beside the committed one: one thread a
# Rice block (spliced into rice.cu, and launched in place of decode_kernel)
THREAD_KERNEL = r"""
// The same decode with one thread per Rice block, kWarps x 32 blocks a
// tile: each thread walks its block's 256 codes through a 64-bit bit
// buffer refilled a big-endian word at a time from two 16-byte loads held
// in registers (the next one issued as the first is used); every 8 codes
// the warp passes its 32 blocks' values through shared memory so that the
// stores are 16 bytes a lane, two lanes a row.
__global__ void __launch_bounds__(kWarps * kLanes)
    decode_thread_kernel(const uint8_t* __restrict__ coded, const int64_t* __restrict__ table,
                         int nbands, int64_t nblocks, int32_t* __restrict__ out,
                         unsigned long long* __restrict__ status, unsigned int* __restrict__ ticket) {
  __shared__ int32_t vals[kWarps][kLanes][kPerLane + 1];
  __shared__ uint32_t warp_bytes[kWarps];
  __shared__ int64_t tile, tile_base;
  const int lane = threadIdx.x & (kLanes - 1), warp = threadIdx.x / kLanes;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t g = tile * (kWarps * kLanes) + threadIdx.x;  // this thread's Rice block
  const bool live = g < nblocks;
  const int64_t* firsts = table + kTableHead;
  const int64_t* counts = firsts + nbands + 1;

  int band = 0, valid = 0;
  uint32_t n = 0;
  if (live) {
    int lo = 0, hi = nbands - 1;  // the last band whose first block is <= g
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (firsts[mid] <= g) lo = mid; else hi = mid - 1;
    }
    band = lo;
    n = reinterpret_cast<const uint16_t*>(coded + table[0])[g];
    const int64_t left = counts[band] - (g - firsts[band]) * kBlock;
    valid = left < kBlock ? static_cast<int>(left) : kBlock;
  }

  // byte offsets: a scan of the tile's lengths, then the look-back
  uint32_t incl = n;
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const uint32_t v = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == kLanes - 1) warp_bytes[warp] = incl;
  __syncthreads();
  uint32_t off = incl - n, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t m = warp_bytes[w];
    off += w < warp ? m : 0u;
    agg += m;
  }
  if (threadIdx.x == 0) publish(status + tile, (tile == 0 ? kInclusive : kAggregate) | agg);
  if (warp == 0) {
    const uint64_t prefix = look_back(status, tile, agg, lane);
    if (lane == 0) tile_base = static_cast<int64_t>(prefix);
  }
  __syncthreads();

  const uint8_t* src = coded + table[2] + (live ? tile_base + off : 0);
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15u);
  const int end = live ? s + min(static_cast<int>(n), kBytesCap) : 0;  // bytes from `from`
  const uint4* from = reinterpret_cast<const uint4*>(src - s);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 cur = end > 0 ? __ldg(from) : zero, nxt = end > 16 ? __ldg(from + 1) : zero;
  int word = s >> 2;  // the next word of the stream from `from`
  uint64_t buf = 0;   // the next `have` stream bits, MSB first
  int have = 0;
  auto refill = [&]() {
    while (have < 32) {
      const int i = word & 3;
      const uint32_t w = i == 0 ? cur.x : i == 1 ? cur.y : i == 2 ? cur.z : cur.w;
      buf |= static_cast<uint64_t>(be_word(w, 4 * word, end)) << (32 - have);
      have += 32;
      if ((++word & 3) == 0) {
        cur = nxt;
        const int c = (word >> 2) + 1;
        nxt = 16 * c < end ? __ldg(from + c) : zero;
      }
    }
  };
  refill();
  buf <<= 8 * (s & 3);  // the bytes before the block's first
  have -= 8 * (s & 3);
  const int k = live ? coded[table[1] + g] : 0;  // 0..K_MAX, checked on the host

  const int64_t row0 = tile * (kWarps * kLanes) + warp * kLanes;  // the warp's first block
  for (int c = 0; c < kBlock / kPerLane; ++c) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      refill();  // >= 32 bits
      const int ones = leading_ones(static_cast<uint32_t>(buf >> 32));
      uint32_t u;
      if (ones >= kQMax) {  // escape: the 32 bits after Q_MAX ones
        buf <<= kQMax;
        have -= kQMax;
        refill();
        u = static_cast<uint32_t>(buf >> 32);
        buf <<= 32;
        have -= 32;
      } else {
        const int len = ones + 1 + k;  // <= 32
        u = (static_cast<uint32_t>(ones) << k) |
            (k ? static_cast<uint32_t>((buf << (ones + 1)) >> (64 - k)) : 0u);
        buf <<= len;
        have -= len;
      }
      vals[warp][lane][j] = static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
    }
    __syncwarp();
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows 16 half..16 half + 15, 4 values a lane
      const int r = half * 16 + (lane >> 1), at = c * kPerLane + (lane & 1) * 4;
      const int row_valid = __shfl_sync(~0u, valid, r);
      const int32_t* v = vals[warp][r] + (lane & 1) * 4;
      int32_t* dst = out + (row0 + r) * kBlock + at;
      if (at + 4 <= row_valid) {
        *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
        for (int i = 0; i < 4 && at + i < row_valid; ++i) dst[i] = v[i];
      }
    }
    __syncwarp();
  }
}

"""
LAUNCH = ("""  decode_kernel<<<static_cast<unsigned>(tiles), kWarps * kLanes, 0, s>>>(
      coded, work + nblocks + 1, nblocks, out, reinterpret_cast<unsigned long long*>(work),
      reinterpret_cast<unsigned int*>(work + tiles));
""", """  const int64_t wide = (nblocks + kWarps * kLanes - 1) / (kWarps * kLanes);
  decode_thread_kernel<<<static_cast<unsigned>(wide), kWarps * kLanes, 0, s>>>(
      coded, work + nblocks + 1, nbands, nblocks, out, reinterpret_cast<unsigned long long*>(work),
      reinterpret_cast<unsigned int*>(work + wide));
""")
BOUNDS = ("__launch_bounds__(kWarps * kLanes)\n    decode_kernel(",
          "__launch_bounds__(kWarps * kLanes, 6)\n    decode_kernel(")
LOOK = ("look_back(status, tile, agg, lane)",
        "static_cast<uint64_t>(reinterpret_cast<const int64_t*>(coded)[tile])")
TILE = {"warp": 32, "thread": 256}  # Rice blocks a tile: kWarps x kDecodePerWarp, kWarps x 32


def _cut(source: str, span, repl: str = "") -> str:
    a = source.find(span[0])
    b = source.find(span[1], a)
    if a < 0 or b < 0:
        raise SystemExit(f"rice.cu no longer holds {span[0].strip()!r} .. {span[1].strip()!r}: "
                         "update this tool")
    return source[:a] + repl + source[b + len(span[1]):]


def _in_decode(source: str, edit) -> str:
    """``edit`` applied to the decode kernels only (the text from the
    first one on), the encode left as it is."""
    at = source.index("decode_kernel(")
    return source[:at] + edit(source[at:])


def _swap(source: str, pair) -> str:
    if pair[0] not in source:
        raise SystemExit(f"rice.cu no longer holds {pair[0]!r}: update this tool")
    return source.replace(pair[0], pair[1])


def thread_form(source: str) -> str:
    """``source`` with ``decode_thread_kernel`` in place of ``decode_kernel``."""
    end = "}  // namespace rice\n"
    return _swap(_swap(source, (end, THREAD_KERNEL + end)), LAUNCH)


def variants(source: str) -> dict:
    thread = thread_form(source)
    return {
        "loads": _in_decode(source, lambda t: _cut(t, ROUNDS, LOADS)),
        "rounds": _in_decode(source, lambda t: _cut(t, WALK, WALK_CUT)),
        "as_is": source,
        "host_offs": _in_decode(source, lambda t: _swap(t, LOOK)),
        "bounds6": _swap(source, BOUNDS),
        "thread": thread,
        "thread_host_offs": _in_decode(thread, lambda t: _swap(t, LOOK)),
    }


def build_variants(out: pathlib.Path, texts: dict) -> dict:
    from repro_torch.kernels import _build

    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "rice.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "rice.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {regs}", flush=True)
        fn = ctypes.CDLL(str(out / name / "lib.so")).repro_rice_decode
        fn.argtypes = _build._SIGNATURES["rice"]["repro_rice_decode"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def tile_offsets(lens: np.ndarray, tile: int) -> np.ndarray:
    """The host form of the look-back: each tile's first byte, from one
    ``np.cumsum`` over every block's length."""
    return np.ascontiguousarray(np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])[
        : lens.size: tile])


def variants_section(dev) -> dict:
    """Each variant through its C launcher on the 16 bands: CUDA events
    and device ms; the exact ones checked equal to the bands."""
    import chip_smoke as CS
    from repro_torch.codec import rice as R
    from repro_torch.kernels import _build

    libs = build_variants(ROOT / "build" / "rice_decode_anatomy" / "variants",
                          variants((_build.CSRC / "rice.cu").read_text()))
    bands = batch_2d(dev)
    coded = R.encode_bands(bands)
    checked = [R.check_band(*c, b.numel()) for b, c in zip(bands, coded)]
    host, table, nb = R.stage_bands(checked)
    firsts = table[R.TABLE_HEAD:R.TABLE_HEAD + len(bands)]
    lens = host.numpy()[: 2 * nb].view(np.uint16)
    staged, tables = {}, {}
    for form, tile in TILE.items():  # the host offsets ahead of the staged bytes
        offs = tile_offsets(lens, tile)
        head = -(-8 * offs.size // 16) * 16
        buf = np.zeros(head + host.numel(), np.uint8)
        buf[: 8 * offs.size] = offs.view(np.uint8)
        buf[head:] = host.numpy()
        staged[form] = torch.from_numpy(buf).to(dev)
        tables[form] = table.copy()
        tables[form][: R.TABLE_HEAD] += head
    plain = host.to(dev)
    out = torch.empty(nb * R.BLOCK_VALUES, dtype=torch.int32, device=dev)
    work = torch.empty(nb + 1 + len(table), dtype=torch.int64, device=dev)
    stream = _build.current_stream_handle(0)
    record = {"lines": [], "host_cumsum_us": {
        form: host_us(lambda: tile_offsets(lens, tile), 50) for form, tile in TILE.items()}}
    for name, fn in libs.items():
        form = "thread" if name.startswith("thread") else "warp"
        coded_dev, tab = ((staged[form], tables[form]) if name.endswith("host_offs")
                          else (plain, table))

        def run(fn=fn, coded_dev=coded_dev, tab=tab):
            rc = fn(0, coded_dev.data_ptr(), out.data_ptr(), work.data_ptr(), nb,
                    tab.ctypes.data, len(tab), stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        if name not in ("loads", "rounds"):
            run()
            for i, (f, b) in enumerate(zip(firsts, bands)):
                if not torch.equal(out[256 * int(f): 256 * int(f) + b.numel()], b):
                    raise SystemExit(f"variant {name}: band {i} differs")
        line = {"variant": name, "ms": CS._median_ms(run, 20),
                "device_ms": CS._device_ms(run, 1)}
        record["lines"].append(line)
        print(f"  {name:16s} events {line['ms']:.4f} ms, device {CS._fmt_ms(line['device_ms'])} ms",
              flush=True)
    print("  host np.cumsum for the offsets, us: " + ", ".join(
        f"{k} {v:.1f}" for k, v in record["host_cumsum_us"].items()), flush=True)
    return record


if __name__ == "__main__":
    sys.exit(main())
