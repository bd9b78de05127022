"""Run one cell of the port's benchmark once, on the CUDA card(s) here.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic
mix and metrics are found from ``BENCHMARK.json`` (``bench/harness.py``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the output check compared,
with its limit; the last lines of standard error repeat them.  Without a
CUDA card, or with fewer than the cell asks for, it prints no result and
exits 3; with JAX or the JAX package loaded after the window, it exits 4.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _process_age_s() -> float:
    """Seconds since this process started (0.0 where /proc cannot say)."""
    try:
        start = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = T0 - _process_age_s()
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

T_TORCH = time.perf_counter()


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def _fail(code: int, msg: str) -> None:
    print(f"bench/run.py: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        _fail(3, "no CUDA card: the benchmark measures the port on the card only")
    if torch.cuda.device_count() < cell.chips:
        _fail(3, f"{args.workload} needs {cell.chips} cards, found {torch.cuda.device_count()}")
    device = torch.device("cuda", 0)
    print(f"set-up: process start to torch imported {T_TORCH - T_START:.3f} s", file=sys.stderr)

    result = harness.measure(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = harness.banned_modules()
    if found:
        _fail(4, f"loaded after the window: {', '.join(found)}")
    if args.trace and "busy_s" not in result["device"]:
        _fail(5, "the traced window holds no device operation")
    result["device"]["power_limit"] = _power_limit()
    result["checks"] = result.pop("checks")  # the key that comes last
    for name, v in result["checks"].items():
        bound = f"max {v['max']}" if "max" in v else f"min {v['min']}"
        print(f"check {name} {v['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
