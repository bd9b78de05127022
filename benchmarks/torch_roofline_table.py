"""Roofline summary from the port's dry-run artifacts (single pod: one
H100), port of ``benchmarks/roofline_table.py``.

Run ``python -m repro_torch.launch.dryrun --all`` first; this bench
aggregates ``artifacts/dryrun_torch/*__h100x1.json`` into rows of the
roofline table.  The terms are counts priced at the H100's published
peaks (``repro_torch.roofline``), not measurements.

    PYTHONPATH=src python -m benchmarks.torch_run --only roofline
"""
from __future__ import annotations

import json
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts" / "dryrun_torch"


def load_reports(mesh: str = "h100x1", artifacts: Path = ARTIFACTS):
    return [json.loads(f.read_text()) for f in sorted(artifacts.glob(f"*__{mesh}.json"))]


def run(device: str = "cuda", artifacts: Path = ARTIFACTS) -> list:
    """``(name, value, notes)`` rows; ``device`` is not used (the table
    reads artifacts)."""
    reports = load_reports(artifacts=artifacts)
    if not reports:
        return [("roofline.missing", 0, "run python -m repro_torch.launch.dryrun --all first")]
    n_ok = sum(1 for r in reports if r["status"] == "OK")
    n_skip = sum(1 for r in reports if r["status"] == "SKIP")
    n_fail = sum(1 for r in reports if r["status"] == "FAIL")
    rows = [("roofline.cells_ok", n_ok, f"skip {n_skip} fail {n_fail} (one H100 a pod)")]
    for r in reports:
        if r["status"] != "OK":
            continue
        rl = r["roofline"]
        total = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        mem = r["memory_analysis"]
        rows.append((
            f"roofline.{r['arch']}.{r['cell']}.dominant_s",
            f"{total:.4f}",
            f"{rl['dominant']} | C {rl['compute_s']:.4f} M {rl['memory_s']:.4f} "
            f"N {rl['collective_s']:.4f} | useful {rl['useful_ratio']:.3f} | peak "
            f"{mem['peak_bytes_est'] / 1e9:.1f} GB fits {mem['fits']}",
        ))
    return rows
