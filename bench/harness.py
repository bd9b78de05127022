"""Find a cell's pieces by name, as files.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric.  Everything else is found from those names, so a new
configuration, traffic mix, driver, input generator or per-layer metric
is a new file and never an edit:

  * a configuration: the JSON file its entry names (``bench/configs/``);
    its ``content`` names ``bench/inputs/<content>.py`` and its
    ``reference`` names ``bench/<reference>.py``;
  * a traffic mix: ``bench/traffic/<traffic>.json``, whose ``driver``
    names ``bench/drivers/<driver>.py``;
  * a per-layer metric: ``bench/metrics/<name>.py``, whose ``read(ctx)``
    returns the metric or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional, Tuple

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded where the port is measured
BANNED_TOP_LEVEL = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: pathlib.Path  # the checkout whose files the cell's pieces are


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its configuration
    and traffic mix read and the metrics it reports."""
    manifest = load_manifest(root)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{entry['traffic']}.json").read_text())
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
        root=root,
    )


def load_file(path: pathlib.Path) -> ModuleType:
    """Import the Python file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(path)
    key = "bench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell) -> ModuleType:
    return load_file(cell.root / "bench" / "drivers" / f"{cell.traffic['driver']}.py")


def content(cell: Cell) -> ModuleType:
    return load_file(cell.root / "bench" / "inputs" / f"{cell.config['content']}.py")


def reference(cell: Cell) -> ModuleType:
    return load_file(cell.root / "bench" / f"{cell.config['reference']}.py")


def metric_reader(cell: Cell, name: str) -> ModuleType:
    return load_file(cell.root / "bench" / "metrics" / f"{name}.py")


def read_per_layer(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Every per-layer metric of ``cell`` that its reader finds in ``ctx``."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = metric_reader(cell, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is banned, compared whole
    (``repro_torch`` is the port and allowed; ``repro`` is not)."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in BANNED_TOP_LEVEL)


def judge(checks: dict) -> Tuple[bool, Dict[str, dict]]:
    """``correct``, and each number the output check compared beside its
    limit: the transform is integer and lossless, so every band and
    every output sample must equal the reference's (limit 0), and both
    the sampled batch and the window's last one must have been checked."""
    limits = {
        "band_mismatches": {"value": checks["band_mismatches"], "max": 0},
        "recon_mismatches": {"value": checks["recon_mismatches"], "max": 0},
        "batches_checked": {"value": checks["batches_checked"], "min": 2},
    }
    correct = all(v["value"] <= v["max"] if "max" in v else v["value"] >= v["min"]
                  for v in limits.values())
    return correct, limits


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            fwd_inv=None) -> dict:
    """One run of ``cell`` on ``device``: the result line's keys, with
    ``checks`` last.  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock; ``fwd_inv`` stands in for the port's
    transforms (controls and planted faults)."""
    import torch

    out = driver(cell).run(cell, seed, seconds, trace, device, fwd_inv=fwd_inv)
    correct, limits = judge(out["checks"])
    if trace:
        metrics = read_per_layer(cell, out["ctx"])
    else:
        values = dict(out["e2e"], setup_s=out["t_first"] - t_start)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    cuda = device.type == "cuda"
    result = {
        "correct": correct,
        "attempted": out["attempted"],
        "failed": out["checks"]["batches_failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": cell.chips,
            "memory_peak_bytes": out["memory_peak_bytes"],
        },
    }
    tr = out["trace"]
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [list(p) for p in tr.device_ops],
                               "idle_gaps": [list(p) for p in tr.idle_gaps]}
    result["checks"] = limits
    return result
