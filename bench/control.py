"""The output check's controls, run through a whole cell on the card.

    python3 bench/control.py --workload <name> --seeds 11 12 13 [--seconds 2] [--out FILE]

For each seed it runs the cell as ``bench/run.py`` does, once with each
stand-in in the port's place, and prints one JSON line per run with the
numbers the check compared:

  * ``program``: the port as the benchmark runs it (the lower reading);
  * ``int16``: the plain reference computed in int16, the integer
    precision below the configuration's int32, put in the port's place;
  * ``int16-values``: the same, its results widened back to int32, so
    only a wrong value can fail it;
  * ``paper``: the port's own ``mode="paper"`` path, whose update step
    drops the Annex F rounding offset (+2): still lossless, no longer
    the standard's bands.

The benchmark's own runs never run these.  ``bench/test_portbench_control.py``
runs them on the CPU at a small size.
"""
import argparse
import json
import pathlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import harness  # noqa: E402


def reference_in_place(cell: harness.Cell, dtype, widen: bool):
    """Forward and inverse by the plain reference computed in ``dtype``,
    item by item on the host, handing back tensors on the input's device
    (int32 where ``widen``)."""
    ref = harness.reference(cell)
    levels, ndim = cell.config["levels"], cell.config["ndim"]
    out_dtype = np.int32 if widen else dtype

    def stack(arrays, device):
        return torch.from_numpy(np.stack(arrays).astype(out_dtype)).to(device)

    def fwd(x):
        xs = x.cpu().numpy()
        with ThreadPoolExecutor(8) as ex:
            res = list(ex.map(lambda a: ref.forward(a, levels, ndim, dtype), xs))
        approx = stack([r[0] for r in res], x.device)
        details = tuple(
            tuple(stack([r[1][lvl][b] for r in res], x.device) for b in range(len(res[0][1][lvl])))
            for lvl in range(levels))
        return approx, details

    def inv(pyr):
        approx = pyr[0].cpu().numpy().astype(dtype)
        details = [[b.cpu().numpy().astype(dtype) for b in lvl] for lvl in pyr[1]]
        with ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(
                lambda i: ref.inverse(approx[i], [[b[i] for b in lvl] for lvl in details], ndim),
                range(approx.shape[0])))
        return stack(outs, pyr[0].device)

    return fwd, inv


def variants(cell: harness.Cell) -> dict:
    """Each stand-in by name (None: the port itself)."""
    paper = dict(cell.config, mode="paper")
    return {
        "program": None,
        "int16": reference_in_place(cell, np.int16, widen=False),
        "int16-values": reference_in_place(cell, np.int16, widen=True),
        "paper": harness.driver(cell).transforms(paper),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", help="also append each line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench/control.py: no CUDA card")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        for name, fwd_inv in variants(harness.find_cell(args.workload)).items():
            cell = harness.find_cell(args.workload)
            if fwd_inv is not None and name != "paper":
                # the host reference takes seconds a batch: keep the
                # sampled batch the first one the window retires
                cell.traffic["check_span"] = 1
            t = time.perf_counter()
            res = harness.measure(cell, seed, args.seconds, False, device, t, fwd_inv=fwd_inv)
            line = json.dumps({"workload": args.workload, "seed": seed, "control": name,
                               "correct": res["correct"], "checks": res["checks"],
                               "attempted": res["attempted"], "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
