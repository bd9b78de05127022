"""Three-term roofline of one H100 from a counted torch program.

Port of ``repro.roofline``:

    compute    = FLOPs / (chips * PEAK_FLOPS of the cell's compute dtype)
    memory     = bytes / (chips * HBM_BW)
    collective = wire_bytes_per_device / LINK_BW

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and wire
bytes from the partitioned HLO.  The port has neither; its counts come
from the program itself (``launch/dryrun.py``):

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step run
    on ``meta`` tensors.  It counts the matmul family (``mm``, ``bmm``,
    ``addmm``, convolutions), the numerator of an MFU share.  XLA's
    ``cost_analysis`` also counts elementwise FLOPs, so the two are not
    the same number; elementwise work is priced by the bytes term.
  * bytes: for each aten op, the bytes of its tensor inputs and outputs,
    each input read once and each output written once.  Ops whose outputs
    alias an input (views, reshapes, slices, transposes, ``as_strided``)
    move nothing and count 0; an in-place op counts its inputs once and
    its write once.  This is the traffic of the eager program the port
    runs, op by op: nothing is fused.
  * wire bytes: the ring-cost formula of each collective the program
    issues (:func:`wire_bytes`), fed from a schedule of its ops
    (``train.grad_compress.pod_sync_schedule``).  There is no HLO to
    parse, so ``parse_collectives`` is absent by design.

Hardware model, one H100 SXM (NVIDIA's H100 data sheet, 700 W):
  * ``PEAK_FLOPS``: 989e12 dense bfloat16 FLOP/s on the tensor cores.
  * float32: ``timing.PEAK_FP32_FLOPS`` (67e12, outside the tensor cores:
    TF32 stays off in the port).
  * ``HBM_BW``: ``timing.PEAK_BYTES_PER_S`` (HBM3, 3.35e12 B/s).
  * ``LINK_BW``: 450e9 B/s a direction (NVLink 4: 900 GB/s in total).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.timing import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

PEAK_FLOPS = 989e12  # dense bfloat16 on the tensor cores (H100 SXM data sheet)
HBM_BW = PEAK_BYTES_PER_S
LINK_BW = 450e9  # NVLink 4, one direction (H100 SXM data sheet: 900 GB/s in total)


def peak_flops(compute_dtype: str = "bfloat16") -> float:
    """The card's peak FLOP/s for matmuls in ``compute_dtype``."""
    if compute_dtype == "bfloat16":
        return PEAK_FLOPS
    if compute_dtype == "float32":
        return PEAK_FP32_FLOPS
    raise ValueError(f"no peak for compute dtype {compute_dtype!r}")


def wire_bytes(op: str, out_bytes: float, in_bytes: float, k: int) -> float:
    """Bytes one device sends for one collective over a group of ``k``
    (the reference's ring formulas): all-reduce 2 * local * (k-1)/k;
    all-gather max(out - in, out * (k-1)/k); reduce-scatter max(in - out,
    in * (k-1)/k); all-to-all out * (k-1)/k; collective-permute the local
    payload (pairwise, k = 2).  A group of one sends nothing."""
    if k <= 1:
        return 0.0
    if op == "collective-permute":
        return float(out_bytes)
    frac = (k - 1) / k
    if op == "all-reduce":
        return 2.0 * out_bytes * frac
    if op == "all-gather":
        return max(out_bytes - in_bytes, out_bytes * frac)
    if op == "reduce-scatter":
        return max(in_bytes - out_bytes, in_bytes * frac)
    if op in ("all-to-all", "ragged-all-to-all"):
        return out_bytes * frac
    raise ValueError(f"unknown collective {op!r}")


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    wire_bytes_per_device: float = 0.0
    by_op_bytes: Dict[str, float] = field(default_factory=dict)

    def add(self, op: str, b: float) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1
        self.by_op_bytes[op] = self.by_op_bytes.get(op, 0.0) + b
        self.wire_bytes_per_device += b


@dataclass
class RooflineReport:
    arch: str
    cell: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float  # global (= per-device * chips)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / counted FLOPs
    per_device_peak_memory: Optional[float] = None
    notes: str = ""

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def build_report(
    *,
    arch: str,
    cell: str,
    mesh_name: str,
    chips: int,
    cost: Dict[str, float],
    collectives: CollectiveStats,
    model_flops: float,
    per_device_peak_memory: Optional[float] = None,
    notes: str = "",
    compute_dtype: str = "bfloat16",
) -> RooflineReport:
    """The three terms of one cell.  ``cost`` holds one device's counts
    (``flops``, ``bytes accessed``), as the reference's per-device
    ``cost_analysis``; the report's FLOPs and bytes are the global ones
    (times ``chips``)."""
    flops_pd = float(cost.get("flops", 0.0))
    bytes_pd = float(cost.get("bytes accessed", 0.0))
    flops_global = flops_pd * chips
    bytes_global = bytes_pd * chips
    compute_s = flops_global / (chips * peak_flops(compute_dtype))
    memory_s = bytes_global / (chips * HBM_BW)
    collective_s = collectives.wire_bytes_per_device / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineReport(
        arch=arch,
        cell=cell,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=flops_global,
        hlo_bytes=bytes_global,
        collective_bytes=collectives.wire_bytes_per_device * chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops_global) if flops_global else 0.0,
        per_device_peak_memory=per_device_peak_memory,
        notes=notes,
    )


def model_flops_for(cfg, cell, param_count: int, active_param_count: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (single forward token batch)."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    n = active_param_count
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n * tokens
