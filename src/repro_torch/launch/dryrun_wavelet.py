"""Dry run of the WAVELET multi-pod train step's pod sync against the plain
baseline's.

Port of ``repro.launch.dryrun_wavelet``.  The reference lowers both steps
on the 2x16x16 mesh and parses their collectives from HLO; the data and
model axes' collectives are the same in both, so the difference is the
pod-axis gradient sync.  The port runs a pod as one rank, so the pod
sync is all there is: each side's wire comes from the shape-only
schedule of ``grad_compress.pod_sync_tree`` (``pod_sync_schedule``) over
the podded state's leaves, with no DWT run.  The baseline is the plain
step's sync, every leaf all-reduced in float32 (``codec="none"``); the
wavelet side ships the integer band payload (``codec="bands"``).

  python -m repro_torch.launch.dryrun_wavelet --arch granite-3-8b [--cell train_4k] [--levels 2]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

from repro_torch import roofline as RL
from repro_torch.configs import get_config, shape_cell
from repro_torch.launch.dryrun import ARTIFACT_DIR, make_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.grad_compress import (
    WaveletSyncConfig,
    pod_collective_bytes,
    pod_sync_schedule,
)
from repro_torch.train.train_step import podded, unpodded


def lower_wavelet_cell(arch: str, cell_name: str, levels: int, mesh=None, *,
                       n_layers: Optional[int] = None, **sync):
    """(cfg, the schedule of the wavelet step's pod sync, mesh): one pod's
    block of the step's parameters on ``meta`` tensors (a leading pod axis
    of 1, as ``make_wavelet_train_step`` takes them), and the
    ``CollectiveStats`` of syncing gradients shaped like them.
    ``n_layers`` cuts the depth; ``sync`` overrides ``WaveletSyncConfig``'s
    fields (``min_size``, ``spatial_2d``, ...)."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape_cell(cell_name)  # the cell must exist; the sync does not depend on it
    mesh = mesh or make_mesh(True)[0]
    n_pods = mesh.axes["pod"]
    params = podded(L.abstract_params(T.model_defs(cfg), T._dtype(cfg.param_dtype)), 1)
    grads = unpodded(params)
    return cfg, pod_sync_schedule(grads, _sync_cfg(levels, n_pods, sync), n_pods), mesh


def _sync_cfg(levels: int, n_pods: int, sync: dict) -> WaveletSyncConfig:
    return WaveletSyncConfig(**{"levels": levels, "codec": "bands", "n_pods": n_pods, **sync})


def wavelet_result(arch: str, cell_name: str, levels: int, *, n_layers: Optional[int] = None,
                   **sync) -> dict:
    """The reference's result keys for one arch: the baseline's and the
    wavelet step's wire a device, both all on the pod axis, the counts,
    and ``pod_collective_bytes``' analytic payloads."""
    cfg, wave, mesh = lower_wavelet_cell(arch, cell_name, levels, n_layers=n_layers, **sync)
    n_pods = mesh.axes["pod"]
    params = L.abstract_params(T.model_defs(cfg), T._dtype(cfg.param_dtype))
    base = pod_sync_schedule(params, WaveletSyncConfig(codec="none", n_pods=n_pods), n_pods)
    sync_cfg = _sync_cfg(levels, n_pods, sync)
    raw, comp = pod_collective_bytes(params, sync_cfg)
    return {
        "arch": arch,
        "cell": cell_name,
        "levels": levels,
        "n_layers": cfg.n_layers,
        "sync": dataclasses.asdict(sync_cfg),
        "baseline_wire_per_device": base.wire_bytes_per_device,
        "wavelet_wire_per_device": wave.wire_bytes_per_device,
        "baseline_pod_axis_wire_per_device": base.wire_bytes_per_device,
        "wavelet_pod_axis_wire_per_device": wave.wire_bytes_per_device,
        "pod_axis_reduction": (base.wire_bytes_per_device / wave.wire_bytes_per_device
                               if wave.wire_bytes_per_device else None),
        "baseline_pod_counts": base.counts,
        "wavelet_pod_counts": wave.counts,
        "baseline_counts": base.counts,
        "wavelet_counts": wave.counts,
        "wavelet_by_op_bytes": wave.by_op_bytes,
        "ring_bytes_per_hop": wave.by_op_bytes.get("ring", 0.0) / max(n_pods - 1, 1),
        "collective_s": {"baseline": base.wire_bytes_per_device / RL.LINK_BW,
                         "wavelet": wave.wire_bytes_per_device / RL.LINK_BW},
        "analytic_pod_bytes_fp32": raw,
        "analytic_pod_bytes_codec": comp,
        "analytic_ratio": raw / comp,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--cell", default="train_4k")
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--no-save", action="store_true",
                    help="don't write artifacts/dryrun_torch JSON")
    args = ap.parse_args(argv)
    result = wavelet_result(args.arch, args.cell, args.levels)
    print(json.dumps(result, indent=2))
    if not args.no_save:
        ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
        name = f"wavelet__{args.arch}__{args.cell}__L{args.levels}.json"
        (ARTIFACT_DIR / name).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
