"""The port's paper benchmarks: Table 2, Table 3 and Fig. 5 on
``repro_torch``, and the gradient-sync and checkpoint compression
experiments (``gradsync``, ``ckpt``), and the roofline table of the dry
run's artifacts (``roofline``: run ``python -m repro_torch.launch.dryrun
--all`` first).  Prints ``name,value,notes`` CSV, as ``benchmarks/run.py``
does for the reference, and exits nonzero if any benchmark failed.

    PYTHONPATH=src python -m benchmarks.torch_run
        [--only table2,table3,fig5,gradsync,ckpt,roofline] [--device cuda|cpu] [--small]

``--device`` defaults to the card (``cuda``), where Table 3 times the
kernels; ``--device cpu`` runs the plain versions (Table 3 then only
checks its rows: host clock, ``--small`` shapes).
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import traceback

ALL = ["table2", "table3", "fig5", "gradsync", "ckpt", "roofline"]

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def _load(name: str):
    if name == "table2":
        from benchmarks import torch_table2_opcounts as m
    elif name == "table3":
        from benchmarks import torch_table3_timing as m
    elif name == "fig5":
        from benchmarks import torch_fig5_lossless as m
    elif name == "gradsync":
        from benchmarks import torch_grad_compression as m
    elif name == "ckpt":
        from benchmarks import torch_ckpt_compression as m
    elif name == "roofline":
        from benchmarks import torch_roofline_table as m
    else:
        raise KeyError(name)
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma-separated subset")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="Table 3 at small shapes")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else ALL

    print("name,value,notes")
    failures = 0
    for name in names:
        try:
            mod = _load(name)
            kw = {"small": args.small} if name == "table3" else {}
            for key, value, notes in mod.run(device=args.device, **kw):
                print(f"{key},{value},{notes}")
        except Exception as e:  # noqa: BLE001  every benchmark runs; the exit code reports
            failures += 1
            print(f"{name}.ERROR,{type(e).__name__},{e}")
            traceback.print_exc(file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
