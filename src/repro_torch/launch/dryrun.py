"""Dry run of every (arch x shape x mesh) cell of the LM stack, priced for
the H100 from a ``meta``-tensor trace.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell on 512 emulated TPU devices and reads XLA's analyses.  Here each
cell's step runs once on ``meta`` tensors (shapes and dtypes, no
allocation, no kernel), under three counters (:func:`count_step`):

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the matmul
    family; ``repro_torch.roofline``'s docstring says what it leaves out);
  * bytes: each aten op's tensor inputs read once and outputs written
    once, ops whose outputs alias an input (by the op schema's
    ``alias_info``, or a result on an input's storage) counted 0;
  * peak memory: the bytes of the storages created during the step and
    still alive, keyed on ``untyped_storage()`` and released when the
    storage itself is freed (autograd's saved tensors and
    ``torch.utils.checkpoint`` keep storages alive without Python
    tensors), at their highest.

For each cell:

  * abstract params / optimizer state / caches (``meta`` tensors)
  * the full-depth step traced with the cell's real config: the counts
    (the artifact's ``trace``, ``cost_analysis`` and the roofline) and
    ``memory_analysis``
  * a cross-check: the 1- and 2-layer probes (3 / 6 / 5 for the hybrid)
    of the same config, linearly extrapolated to the full depth; the
    port's layers are a Python loop, so the extrapolation equals the
    trace (``probe["equals_trace"]``)
  * the collective schedule: none within a pod (a pod is one rank);
    across pods the plain step's float32 gradient all-reduce
    (``grad_compress.pod_sync_schedule`` with ``codec="none"``)
  -> ``artifacts/dryrun_torch/<arch>__<cell>__<mesh>.json``

Meshes: ``h100x1`` (one card a pod) and ``pod2xh100x1`` (two pods of one
card).  The port runs ``data`` and ``model`` within a pod as one rank, so
a mesh whose ``data`` or ``model`` axis exceeds 1 records ``SKIP``.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --cell train_4k [--multipod]
  python -m repro_torch.launch.dryrun --all [--multipod] [--no-probe] [--no-save]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import roofline as RL
from repro_torch import sharding as SH
from repro_torch import tree as TR
from repro_torch.configs import ARCH_IDS, cell_applicable, get_config, shape_cell
from repro_torch.configs.base import SHAPE_SUITE, ArchConfig, ShapeCell
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import grad_compress as G
from repro_torch.train import optim
from repro_torch.train.train_step import make_train_step

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
H100_MEMORY_BYTES = 80e9  # the H100 SXM's 80 GB, where no card is present
NO_CARD = "H100 published figures, no card"
SKIP_SHARDED = ("SKIP(sharded): the port runs data and model within a pod as one rank "
                "(ROADMAP Queue 3)")


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@functools.lru_cache(maxsize=None)
def _alias_kind(func) -> Tuple[bool, bool]:
    """(an output is a view of an input, an output is an input written in
    place), from the op schema's ``alias_info``."""
    infos = [r.alias_info for r in func._schema.returns if r.alias_info is not None]
    return any(not a.is_write for a in infos), any(a.is_write for a in infos)


class StepCounter(TorchDispatchMode):
    """Bytes and live storages of every aten op run under it.

    ``bytes``: each op's tensor inputs and outputs, once each.  An op
    whose schema makes an output a view of an input moves nothing; so
    does one whose every output lands on an input's storage without the
    schema saying it writes there (``_unsafe_view``, the tail of
    ``matmul`` and ``reshape``).  ``ops``: aten ops seen.
    ``peak``: the highest sum of the bytes of storages created under the
    counter and not yet freed; the storages of ``args`` (the step's
    arguments) are not counted."""

    def __init__(self, args=()):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.cur = 0
        self.peak = 0
        self._known = {_key(t) for t in _tensors(args)}
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}

    def _free(self, key: int, _ref) -> None:
        self.cur -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._known:
            return
        n = st.nbytes()
        self._live[key] = n
        self._refs[key] = weakref.ref(st, lambda r, k=key: self._free(k, r))
        self.cur += n
        self.peak = max(self.peak, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        view, inplace = _alias_kind(func)
        aliased = view or (not inplace and bool(outs)
                           and {_key(t) for t in outs} <= {_key(t) for t in ins})
        if not aliased:
            self.bytes += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        for t in outs:
            self._track(t)
        return out


def count_step(fn: Callable, args: tuple) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the FLOP counter and a
    :class:`StepCounter`: ``flops``, ``bytes``, ``ops``, the peak of the
    storages it creates (``temp_bytes``), the bytes of its results
    (``output_bytes``) and ``seconds``.  The results are dropped."""
    t0 = time.perf_counter()
    counter = StepCounter(args)
    with FlopCounterMode(display=False) as flops, counter:
        out = fn(*args)
        output_bytes = counter.cur
    del out
    return {"flops": int(flops.get_total_flops()), "bytes": int(counter.bytes),
            "ops": counter.ops, "temp_bytes": int(counter.peak),
            "output_bytes": int(output_bytes), "seconds": time.perf_counter() - t0}


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in _tensors(tree):
        seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


# ---------------------------------------------------------------------------
# Meshes, rules and cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes only: what ``sharding.rules_for`` reads of a mesh."""

    shape: Tuple[Tuple[str, int], ...]

    @property
    def axes(self) -> Dict[str, int]:
        return dict(self.shape)

    @property
    def size(self) -> int:
        return math.prod(k for _, k in self.shape)


def make_mesh(multi_pod: bool, debug_mesh: Optional[Tuple[int, ...]] = None):
    """(mesh, its name, multi_pod): ``h100x1`` / ``pod2xh100x1``, or a
    debug mesh of (data, model) or (pod, data, model) sizes."""
    if debug_mesh is not None:
        names = ("pod", "data", "model") if len(debug_mesh) == 3 else ("data", "model")
        return (AbstractMesh(tuple(zip(names, map(int, debug_mesh)))),
                "debug" + "x".join(map(str, debug_mesh)), len(debug_mesh) == 3)
    if multi_pod:
        return AbstractMesh((("pod", 2), ("data", 1), ("model", 1))), "pod2xh100x1", True
    return AbstractMesh((("data", 1), ("model", 1))), "h100x1", False


# The switches that change the traced program, and so tag an artifact:
# hillclimb_overrides' and models/attention.py's.
OPT_SWITCHES = ("REPRO_OPT_ATTN_BF16_PROBS", "REPRO_OPT_ATTN_CHUNK", "REPRO_OPT_CE_CHUNK",
                "REPRO_OPT_MOE_CF", "REPRO_OPT_MOE_INT16", "REPRO_OPT_REMAT_DOTS")


def hillclimb_overrides(cfg: ArchConfig) -> ArchConfig:
    """Env-gated beyond-baseline knobs, with the reference's meaning:

      REPRO_OPT_CE_CHUNK=<n>    chunked fp32 cross-entropy (memory/bytes)
      REPRO_OPT_REMAT_DOTS=1    save matmul outputs in remat (compute)
      REPRO_OPT_ATTN_CHUNK=<n>  attention chunk size
      REPRO_OPT_MOE_INT16=1     int16 MoE dispatch bookkeeping
      REPRO_OPT_MOE_CF=<f>      MoE capacity factor
    """
    kw = {}
    if os.environ.get("REPRO_OPT_CE_CHUNK"):
        kw["ce_chunk"] = int(os.environ["REPRO_OPT_CE_CHUNK"])
    if os.environ.get("REPRO_OPT_REMAT_DOTS"):
        kw["remat_policy"] = "dots"
    if os.environ.get("REPRO_OPT_ATTN_CHUNK"):
        kw["attn_chunk"] = int(os.environ["REPRO_OPT_ATTN_CHUNK"])
    if os.environ.get("REPRO_OPT_MOE_INT16") and cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, dispatch_dtype="int16")
    if os.environ.get("REPRO_OPT_MOE_CF"):
        kw["moe"] = dataclasses.replace(
            kw.get("moe", cfg.moe), capacity_factor=float(os.environ["REPRO_OPT_MOE_CF"]))
    return dataclasses.replace(cfg, **kw) if kw else cfg


def rules_for_cell(cfg: ArchConfig, cell: ShapeCell, mesh, multi_pod: bool):
    """``sharding.rules_for`` on the cell.  The port does not shard heads
    (a pod is one rank), so the reference's head-replication knobs
    (REPRO_OPT_KV_REPLICATE / REPRO_OPT_ATTN_REPLICATE) would change no
    count and are not read."""
    return SH.rules_for(
        mesh,
        multi_pod=multi_pod,
        fsdp=cfg.fsdp and cell.kind == "train",
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        vocab=cfg.vocab_size,
        global_batch=cell.global_batch,
        prefer_replicated_kv=False,
        prefer_replicated_attn=False,
    )


def _pods(mesh) -> int:
    return mesh.axes.get("pod", 1)


def _pod_batch(cell: ShapeCell, rules, mesh) -> int:
    """The rows one pod runs: the global batch split over the pods where
    the rules shard it, else all of it (replicated)."""
    batch_rule = rules.get("batch")
    split = "pod" in ((batch_rule,) if isinstance(batch_rule, str) else tuple(batch_rule or ()))
    return cell.global_batch // _pods(mesh) if split else cell.global_batch


def input_specs(cfg: ArchConfig, cell: ShapeCell, batch: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell (``batch``
    rows, the cell's global batch by default)."""
    b, s = batch or cell.global_batch, cell.seq_len
    cdt = T._dtype(cfg.compute_dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind == "train":
        if cfg.input_mode == "tokens":
            return {"tokens": meta((b, s), torch.int32), "labels": meta((b, s), torch.int32)}
        return {"embeds": meta((b, s, cfg.d_model), cdt), "labels": meta((b, s), torch.int32)}
    if cell.kind == "prefill":
        if cfg.input_mode == "tokens":
            return {"tokens": meta((b, s), torch.int32)}
        return {"embeds": meta((b, s, cfg.d_model), cdt)}
    # decode: one new token, cache of length s
    if cfg.input_mode == "tokens":
        return {"tokens": meta((b, 1), torch.int32)}
    return {"embeds": meta((b, 1, cfg.d_model), cdt)}


def abstract_opt_state(params) -> optim.AdamWState:
    """float32 moments of ``meta`` leaves shaped like ``params``."""
    def f32(p):
        return torch.empty(tuple(p.shape), dtype=torch.float32, device="meta")

    return optim.AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                            m=TR.map_leaves(f32, params), v=TR.map_leaves(f32, params))


def build_cell(cfg: ArchConfig, cell: ShapeCell, mesh, multi_pod: bool
               ) -> Tuple[Callable, tuple, Dict]:
    """Returns (step function, its abstract arguments, rules): one pod's
    program of the cell on ``meta`` tensors."""
    rules = rules_for_cell(cfg, cell, mesh, multi_pod)
    params = L.abstract_params(T.model_defs(cfg), T._dtype(cfg.param_dtype))
    ins = input_specs(cfg, cell, _pod_batch(cell, rules, mesh))
    if cell.kind == "train":
        return make_train_step(cfg, ce_chunk=cfg.ce_chunk), (
            params, abstract_opt_state(params), ins), rules
    if cell.kind == "prefill":
        def prefill(p, batch):
            return T.prefill(p, cfg, **batch)

        return prefill, (params, ins), rules
    caches = T.abstract_caches(cfg, next(iter(ins.values())).shape[0], cell.seq_len)

    def decode(p, c, batch):
        return T.decode_step(p, cfg, c, **batch)

    return decode, (params, caches, ins), rules


def cell_collectives(cfg: ArchConfig, cell: ShapeCell, mesh) -> RL.CollectiveStats:
    """What one device sends in a step of the cell: across pods, a train
    step's float32 gradient all-reduce (the plain multi-pod step's pod
    sync, ``codec="none"``); nothing else (a pod is one rank)."""
    n = _pods(mesh)
    if cell.kind != "train" or n <= 1:
        return RL.CollectiveStats()
    params = L.abstract_params(T.model_defs(cfg), T._dtype(cfg.param_dtype))
    return G.pod_sync_schedule(params, G.WaveletSyncConfig(codec="none", n_pods=n), n)


def _probe_layer_counts(cfg: ArchConfig) -> Tuple[int, ...]:
    """Layer counts for the cost probes (see _probe_costs)."""
    if cfg.family == "hybrid":
        return (3, 6, 5)  # 1 super | 2 supers | 1 super + 2 tail rec
    return (1, 2)


def probe_cfg(cfg: ArchConfig, cell: ShapeCell, n_layers: int) -> ArchConfig:
    """Cost-probe variant: the cell's own program at ``n_layers``.  The
    chunk sizes stay the config's (the reference's probes widen them,
    which would price a program the port never runs); the unroll flags
    change nothing in the port, whose loops are Python loops."""
    return dataclasses.replace(cfg, n_layers=n_layers, scan_layers=False, unroll_loops=True)


def _cost_of(cfg: ArchConfig, cell: ShapeCell, mesh, multi_pod: bool, chips: int):
    fn, args, _ = build_cell(cfg, cell, mesh, multi_pod)
    counts = count_step(fn, args)
    coll = cell_collectives(cfg, cell, mesh)
    return float(counts["flops"]), float(counts["bytes"]), float(coll.wire_bytes_per_device)


def _probe_costs(cfg: ArchConfig, cell: ShapeCell, mesh, multi_pod: bool, chips: int
                 ) -> Dict[str, Any]:
    """(flops, bytes, wire/device) at the full depth by linear extrapolation
    over the 1- / 2-layer probes (hybrid: 1 / 2 supers + tail): a
    cross-check of the full-depth trace, which it equals."""
    counts = _probe_layer_counts(cfg)
    probes = {lc: _cost_of(probe_cfg(cfg, cell, lc), cell, mesh, multi_pod, chips)
              for lc in counts}

    def extrap(idx: int) -> float:
        if cfg.family == "hybrid":
            c3, c6, c5 = probes[3][idx], probes[6][idx], probes[5][idx]
            n_super, n_tail = hybrid_layout_counts(cfg)
            return c3 + (n_super - 1) * (c6 - c3) + (c5 - c3) * (n_tail / 2.0)
        c1, c2 = probes[counts[0]][idx], probes[counts[1]][idx]
        return c1 + (cfg.n_layers - 1) * (c2 - c1)

    return {
        "flops": extrap(0),
        "bytes": extrap(1),
        "wire_per_device": extrap(2),
        "probe_points": {str(k): v for k, v in probes.items()},
    }


def hybrid_layout_counts(cfg: ArchConfig) -> Tuple[int, int]:
    p = cfg.hybrid.attn_period
    return cfg.n_layers // p, cfg.n_layers % p


def device_info() -> Dict[str, Any]:
    """The card's ``nvidia-smi`` name and power limit and its memory, or
    the H100's published figures where there is no card."""
    if torch.cuda.is_available():
        from repro_torch.timing import card_line

        return {"card": card_line(),
                "total_memory": int(torch.cuda.get_device_properties(0).total_memory)}
    return {"card": NO_CARD, "total_memory": int(H100_MEMORY_BYTES)}


def run_cell(
    arch: str,
    cell_name: str,
    multi_pod: bool,
    save: bool = True,
    debug_mesh: Optional[Tuple[int, ...]] = None,
    probe: bool = True,
    cfg: Optional[ArchConfig] = None,
    cell: Optional[ShapeCell] = None,
) -> Dict[str, Any]:
    """Trace, count and price one cell.  ``cfg`` and ``cell`` stand in for
    ``get_config(arch)`` and ``shape_cell(cell_name)`` where given (a
    reduced config, a cell outside ``SHAPE_SUITE``)."""
    cfg = hillclimb_overrides(cfg or get_config(arch))
    cell = cell or shape_cell(cell_name)
    ok, why = cell_applicable(cfg, cell)
    mesh, mesh_name, multi_pod = make_mesh(multi_pod, debug_mesh)
    result: Dict[str, Any] = {"arch": arch, "cell": cell_name, "mesh": mesh_name,
                              "status": "SKIP", "reason": why}
    if ok and (mesh.axes.get("data", 1) > 1 or mesh.axes.get("model", 1) > 1):
        ok, why = False, SKIP_SHARDED
        result["reason"] = why
    if not ok:
        print(f"[dryrun] {arch} x {cell_name} x {mesh_name}: {why}")
        if save:
            _save(result)
        return result

    chips = mesh.size
    dev = device_info()
    t0 = time.time()
    try:
        fn, args, rules = build_cell(cfg, cell, mesh, multi_pod)
        trace = count_step(fn, args)
        t_lower = time.time() - t0
        coll = cell_collectives(cfg, cell, mesh)
        trace["wire_per_device"] = coll.wire_bytes_per_device
        arg_bytes = tree_bytes(args)
        del fn, args
        cost = {"flops": float(trace["flops"]), "bytes accessed": float(trace["bytes"])}
        model_flops = RL.model_flops_for(cfg, cell, cfg.param_count(), cfg.active_param_count())
        probe_data = None
        if probe:
            try:
                probe_data = _probe_costs(cfg, cell, mesh, multi_pod, chips)
                probe_data["equals_trace"] = (
                    (probe_data["flops"], probe_data["bytes"], probe_data["wire_per_device"])
                    == (cost["flops"], cost["bytes accessed"], coll.wire_bytes_per_device))
            except Exception as pe:  # noqa: BLE001
                probe_data = {"error": f"{type(pe).__name__}: {pe}"}
        t_probe = time.time() - t0 - t_lower
        peak_mem = float(arg_bytes + trace["temp_bytes"])
        fits = peak_mem <= dev["total_memory"]
        report = RL.build_report(
            arch=arch, cell=cell_name, mesh_name=mesh_name, chips=chips, cost=cost,
            collectives=coll, model_flops=model_flops, per_device_peak_memory=peak_mem,
            notes="" if fits else "does not fit one card", compute_dtype=cfg.compute_dtype,
        )
        result.update({
            "status": "OK",
            "reason": "",
            "lower_s": round(t_lower, 1),
            "compile_s": round(t_probe, 1),
            "device": dev,
            "trace": trace,
            "memory_analysis": {
                "argument_bytes": arg_bytes,
                "output_bytes": trace["output_bytes"],
                "temp_bytes": trace["temp_bytes"],
                "alias_bytes": None,
                "peak_bytes_est": peak_mem,
                "total_memory": dev["total_memory"],
                "fits": fits,
            },
            "cost_analysis": {"flops": cost.get("flops"),
                              "bytes_accessed": cost.get("bytes accessed"),
                              "transcendentals": None},
            "collectives": {"counts": coll.counts, "by_op_bytes": coll.by_op_bytes,
                            "wire_bytes_per_device": coll.wire_bytes_per_device},
            "roofline": report.as_dict(),
            "probe": probe_data,
            "rules": {k: str(v) for k, v in rules.items()},
        })
        same = "" if not probe_data else f" (= trace: {probe_data.get('equals_trace')})"
        print(f"[dryrun] OK {arch} x {cell_name} x {mesh_name}: trace {t_lower:.0f}s probes "
              f"{t_probe:.0f}s{same} | flops {report.hlo_flops:.3e} bytes {report.hlo_bytes:.3e} "
              f"wire/dev {coll.wire_bytes_per_device:.3e} peakmem/dev {peak_mem / 2**30:.2f} GiB "
              f"fits={fits} | dominant={report.dominant}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result.update({"status": "FAIL", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
        print(f"[dryrun] FAIL {arch} x {cell_name} x {mesh_name}: {e}")
    if save:
        _save(result)
    return result


def _opt_tag() -> str:
    """Suffix for artifacts produced under the hillclimb overrides."""
    tags = []
    for k in OPT_SWITCHES:
        v = os.environ.get(k)
        if v:
            tags.append(f"{k[10:].lower()}{v if v != '1' else ''}")
    return ("__opt_" + "-".join(tags)) if tags else ""


def _save(result: Dict[str, Any]) -> None:
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['cell']}__{result['mesh']}{_opt_tag()}.json"
    (ARTIFACT_DIR / name).write_text(json.dumps(result, indent=2, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument(
        "--debug-mesh",
        default=None,
        help="comma ints, e.g. 1,1 or 2,1,1: (data, model) or (pod, data, model) sizes",
    )
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the cost probes (faster; raw full-depth counts only)")
    ap.add_argument("--no-save", action="store_true",
                    help="don't write artifacts/dryrun_torch JSON")
    args = ap.parse_args(argv)
    debug_mesh = (
        tuple(int(x) for x in args.debug_mesh.split(",")) if args.debug_mesh else None
    )

    if args.all:
        combos = [(a, c.name) for a in ARCH_IDS for c in SHAPE_SUITE]
    else:
        if not (args.arch and args.cell):
            ap.error("--arch and --cell (or --all)")
        combos = [(args.arch, args.cell)]

    failures = 0
    for arch, cell in combos:
        r = run_cell(
            arch, cell, args.multipod, debug_mesh=debug_mesh,
            probe=not args.no_probe and not args.multipod,
            save=not args.no_save,
        )
        if r["status"] == "FAIL":
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
