"""Where the time of the one-launch Rice encode goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/rice_anatomy.py [--json-out PATH]

Builds ``src/repro_torch/csrc/rice.cu`` as it is and in variants with
stages of the encode kernel cut out, into ``build/rice_anatomy/`` (the
cut variants write wrong bytes: they only time), and runs each, through
its C launcher, on the 16 bands of one 8 x 2048^2 cdf53 / jpeg2000 batch
(half random, half smooth 8-bit images, as ``chip_smoke.py``'s
``time_rice``):

  loads    each warp reads its block's 1 KB (two 16-byte loads a lane)
           and folds it into its k table entry: no cost scan, no
           packing, no look-back, no payload
  cost     + the bins and the argmin: k and byte lengths into the tables
  pack     + code lengths, their scan, the bit run into shared memory and
           each block's bytes written at a padded row offset (block x
           BYTES_CAP): everything but the look-back
  as_is    + the decoupled look-back and compact offsets: the kernel as
           committed, checked byte-equal against the plain encode
  tile4    as_is with tiles of 4 Rice blocks (128-thread blocks) instead
           of 8, checked byte-equal too
  padded   as_is, but each block's bytes written at its padded row offset
           (block x BYTES_CAP) instead of its compact one: what the
           compact stores cost beyond the look-back
  blockidx as_is with each tile's id taken from blockIdx.x instead of
           the global ticket: what the ticket costs (the order in which
           thread blocks start is then the hardware's, which CUDA leaves
           open)

Each line gives the CUDA-event median of 20 calls of the C launcher
(workspace memset, the bands' table copied to the card, the kernel) and
the kernel's device ms (``torch.profiler``); then the wrapper
(``codec.rice.rice_encode_cuda``) and the first line once more, for the
spread within one run.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

COST = ("    // each lane's column of bins", "    nbytes = ((best >> 5) + 7u) >> 3;\n")
PACK = ("    // this lane's code lengths", "    run.finish(flush);\n")
LOOKBACK = ("look_back(status, tile, agg, lane)",
            "static_cast<uint64_t>(tile) * kWarps * (kWords * 4)")  # padded rows
STORES = ("  uint8_t* out = payload + dst;\n",
          "  if (lane < n - tail) out[tail + lane] = static_cast<uint8_t>(stream_byte(sw, tail + lane));\n")
FOLD = ("    uint32_t fold = 0;\n"
        "    for (int j = 0; j < kPerLane; ++j) fold ^= u[j];\n"
        "    fold = __reduce_or_sync(~0u, fold);\n"
        "    k = static_cast<int>(fold % 25u);\n"
        "    nbytes = 128u;\n")
TILE = ("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")
DST = ("  const int64_t dst = tile_base + off;\n", "  const int64_t dst = g * (kWords * 4);\n")
TICKET = ("  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1u);\n",
          "  if (threadIdx.x == 0) tile = blockIdx.x;\n")


def _cut(source: str, span, repl: str = "") -> str:
    start, end = span
    a = source.find(start)
    b = source.find(end, a)
    if a < 0 or b < 0:
        raise SystemExit(f"rice.cu no longer holds {start.strip()!r} .. {end.strip()!r}: "
                         "update this tool")
    return source[:a] + repl + source[b + len(end):]


def _swap(source: str, *pairs) -> str:
    for old, new in pairs:
        if old not in source:
            raise SystemExit(f"rice.cu no longer holds {old.strip()!r}: update this tool")
        source = source.replace(old, new)
    return source


def variants(source: str) -> dict:
    pack = _swap(source, LOOKBACK)
    cost = _cut(_cut(pack, PACK), STORES)
    loads = _cut(cost, COST, FOLD)
    return {"loads": loads, "cost": cost, "pack": pack, "as_is": source,
            "tile4": _swap(source, TILE), "padded": _swap(source, DST),
            "blockidx": _swap(source, TICKET)}


def build(out: pathlib.Path, texts: dict) -> dict:
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
        print(f"{name}: {[ln.strip() for ln in log.splitlines() if 'registers' in ln or 'spill' in ln]}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        fn = lib.repro_rice_encode
        fn.argtypes = _build._SIGNATURES["rice"]["repro_rice_encode"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rice_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch import kernels as K
    from repro_torch.codec import rice as R
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    libs = build(ROOT / "build" / "rice_anatomy", variants((_build.CSRC / "rice.cu").read_text()))

    rng = np.random.default_rng(0)
    h, w = CS.BUCKETS[-1]
    imgs = [rng.integers(-128, 128, (h, w), dtype=np.int32) if i % 2
            else CS.smooth_image(rng, h, w) for i in range(CS.SLOTS)]
    x = torch.from_numpy(np.stack(imgs)).to(dev)
    pyr = K.dwt_fwd_2d_multi(x, levels=CS.LEVELS, mode=CS.MODE, scheme=CS.SCHEME)
    bands = [b.reshape(-1) for b in [pyr.ll] + [b for lvl in pyr.details for b in lvl]]
    counts = [b.numel() for b in bands]
    firsts = np.concatenate([[0], np.cumsum([R.n_blocks(c) for c in counts])])
    nb = int(firsts[-1])
    table = np.concatenate([firsts, [b.data_ptr() for b in bands], counts]).astype(np.int64)
    payload = torch.empty(nb * R.BYTES_CAP, dtype=torch.uint8, device=dev)
    tables = torch.empty(8 * (len(bands) + 1) + 3 * nb, dtype=torch.uint8, device=dev)
    work = torch.empty(nb + 1 + len(table), dtype=torch.int64, device=dev)
    stream = _build.current_stream_handle(0)

    def call(fn):
        def run():
            rc = fn(0, payload.data_ptr(), tables.data_ptr(), work.data_ptr(), nb,
                    table.ctypes.data, len(table), stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return run

    want = [R.encode_band_plain(b, chunk_blocks=8192) for b in bands]
    for name in ("as_is", "tile4", "blockidx"):
        call(libs[name])()
        offs, ks, lens = R.tables_to_host(tables, len(bands))
        got = R.split_bands(payload[: int(offs[-1])].cpu().numpy(), offs, ks, lens, counts)
        if not all(g[0] == v[0] and np.array_equal(g[1], v[1]) and np.array_equal(g[2], v[2])
                   for g, v in zip(got, want)):
            raise SystemExit(f"{name}: the encode differs from the plain version")
    coded = sum(len(v[0]) for v in want)
    nbytes = 4 * sum(counts) + coded + 3 * nb + 8 * (len(bands) + 1)
    print(f"16 bands, {sum(counts)} values, {nb} blocks, {coded} payload bytes; byte bound "
          f"{nbytes / CS.PEAK_BYTES_PER_S * 1e3:.4f} ms; as_is, tile4 and blockidx byte-equal to "
          "the plain encode",
          flush=True)

    record = {"card": card, "values": sum(counts), "blocks": nb, "payload_bytes": coded,
              "bound_ms": nbytes / CS.PEAK_BYTES_PER_S * 1e3, "lines": []}
    lines = [(name, call(fn)) for name, fn in libs.items()]
    lines += [("wrapper", lambda: R.rice_encode_cuda(bands)), lines[0]]
    for name, run in lines:
        ms = CS._median_ms(run, 20)
        dev_ms = CS._pass_ms(run)
        record["lines"].append({"variant": name, "ms": ms, "device_ms": dev_ms})
        print(f"  {name:8s} {ms:.4f} ms; device: "
              + ", ".join(f"{a} {b:.4f}" if isinstance(b, float) else f"{a} {b}"
                          for a, b in dev_ms.items()), flush=True)
    if args.json_out:
        out = pathlib.Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
