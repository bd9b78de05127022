"""Markdown tables of the port's dry run, from
``artifacts/dryrun_torch/*.json`` (port of
``benchmarks/experiments_tables.py``).

    PYTHONPATH=src python -m benchmarks.torch_experiments_tables > tables.md

The FLOPs and bytes are counted from a ``meta``-tensor trace of each
cell's step and priced at the H100's published peaks
(``repro_torch.roofline``): a count, not a measurement.
"""
from __future__ import annotations

import json
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts" / "dryrun_torch"


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b / 1e9:.1f}"


def _cells(mesh: str, artifacts: Path):
    return [json.loads(f.read_text()) for f in sorted(artifacts.glob(f"*__{mesh}.json"))]


def dryrun_table(mesh: str, artifacts: Path = ARTIFACTS) -> str:
    lines = [
        "| arch | cell | status | trace s | peak GB | fits | FLOPs (global) | bytes | "
        "wire bytes/dev | collective ops |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in _cells(mesh, artifacts):
        if d["status"] == "SKIP":
            lines.append(f"| {d['arch']} | {d['cell']} | SKIP | - | - | - | - | - | - | "
                         f"{d['reason'][:40]} |")
            continue
        if d["status"] != "OK":
            lines.append(f"| {d['arch']} | {d['cell']} | FAIL | - | - | - | - | - | - | "
                         f"{d.get('error', '')[:40]} |")
            continue
        mem = d["memory_analysis"]
        coll = d["collectives"]
        ops = " ".join(f"{k}:{v}" for k, v in sorted(coll.get("counts", {}).items()))
        rl = d["roofline"]
        lines.append(
            f"| {d['arch']} | {d['cell']} | OK | {d['lower_s']} | "
            f"{fmt_bytes(mem['peak_bytes_est'])} | {'yes' if mem['fits'] else 'no'} | "
            f"{rl['hlo_flops']:.3e} | {rl['hlo_bytes']:.3e} | "
            f"{coll['wire_bytes_per_device']:.3e} | {ops[:60] or '-'} |"
        )
    return "\n".join(lines)


def roofline_table(artifacts: Path = ARTIFACTS) -> str:
    """One row per (arch, cell) of the single-pod sweep: status, FLOPs and
    bytes of the full-depth trace, peak GB and whether it fits one card,
    the dominant term, the three terms, the useful ratio, and whether the
    probes' extrapolation equals the trace (``-`` where none ran)."""
    lines = [
        "| arch | cell | status | FLOPs | bytes | peak GB | fits | dominant | compute s "
        "| memory s | collective s | useful | probes = trace |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in _cells("h100x1", artifacts):
        if d["status"] != "OK":
            why = d["reason"].split(":")[0] if d["status"] == "SKIP" else d.get("error", "")[:48]
            lines.append(f"| {d['arch']} | {d['cell']} | {d['status']} | {why} | | | | | | | | | |")
            continue
        r, mem, probe = d["roofline"], d["memory_analysis"], d.get("probe") or {}
        same = {True: "yes", False: "no"}.get(probe.get("equals_trace"), "-")
        lines.append(
            f"| {d['arch']} | {d['cell']} | OK | {r['hlo_flops']:.3e} | {r['hlo_bytes']:.3e} "
            f"| {fmt_bytes(mem['peak_bytes_est'])} | {'yes' if mem['fits'] else 'no'} "
            f"| {r['dominant']} | {r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"| {r['collective_s']:.4g} | {r['useful_ratio']:.3f} | {same} |"
        )
    return "\n".join(lines)


def main() -> None:
    print("## Dry run - one H100 a pod\n")
    print(dryrun_table("h100x1"))
    print("\n## Dry run - two pods of one H100\n")
    print(dryrun_table("pod2xh100x1"))
    print("\n## Roofline (one H100, the full-depth trace's counts; a count at the published "
          "peaks, not a measurement)\n")
    print(roofline_table())


if __name__ == "__main__":
    main()
