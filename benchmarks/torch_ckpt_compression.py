"""Checkpoint compression experiment on the port: zlib vs wavelet codecs.

The counterpart of ``benchmarks/ckpt_compression.py``, row for row, on a
reduced stablelm-2-1.6b train state (``launch.train.init_train_state``)
whose optimizer moments are given realistic statistics.  LM weight
matrices are not smooth signals, so the DWT mostly helps through the
int16 quantization plus mild band decorrelation.  The leaves live on
``device``: on the card quantize and transform run the kernels there.
``save_s`` is host clock around a blocking save (it ends with an fsync).
"""
from __future__ import annotations

import tempfile
import time

import torch

from repro_torch import tree as T
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import init_train_state


def run(device: str = "cuda") -> list:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ckpt: device='cuda' but no CUDA card; pass device='cpu'")
    rows = []
    cfg = reduced(get_config("stablelm-1.6b"))
    state = init_train_state(cfg, seed=0, device=device)
    # give the optimizer state realistic (non-zero, smooth-ish) statistics
    state["opt"] = state["opt"]._replace(
        m=T.map_leaves(lambda p: p.float() * 0.01, state["params"]),
        v=T.map_leaves(lambda p: p.float().abs() * 1e-4 + 1e-8, state["params"]),
    )
    for codec in ("z", "wz", "wz-rice"):
        with tempfile.TemporaryDirectory() as td:
            mgr = CheckpointManager(td, keep=1, codec=codec, device=device)
            t0 = time.perf_counter()
            mgr.save(1, state, blocking=True)
            t_save = time.perf_counter() - t0
            rep = mgr.compression_report(1)
            _, restored = mgr.restore(1, template=state)
            if codec == "z":
                exact = all(torch.equal(a, b) for a, b in zip(T.leaves(state),
                                                              T.leaves(restored)))
                rows.append(("ckpt.z.lossless_roundtrip", int(exact), "must be 1"))
            else:
                errs = [float((a.float() - b.float()).abs().max()) / (float(a.float().abs().max())
                                                                     + 1e-12)
                        for a, b in zip(T.leaves(state["params"]), T.leaves(restored["params"]))]
                note = ("bounded by int16 quantization (~3e-5)" if codec == "wz"
                        else "full int16 step: bound does not grow with levels")
                rows.append((f"ckpt.{codec}.max_rel_error", round(max(errs), 6), note))
            rows.append((f"ckpt.{codec}.ratio", round(rep["ratio"], 3),
                         f"raw {rep['raw_bytes']} -> {rep['stored_bytes']}"))
            rows.append((f"ckpt.{codec}.save_s", round(t_save, 3), "blocking save"))
    return rows
