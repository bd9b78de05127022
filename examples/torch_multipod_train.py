"""Multi-pod training with wavelet-codec gradient sync on the port
(``examples/multipod_train.py`` on ``repro_torch``): the paper's transform
in the distributed-optimization path.

    PYTHONPATH=src python examples/torch_multipod_train.py [--device cpu] [--steps 30]

Spawns 2 ranks, one pod each, and compares the compressed-sync step with
the full-fidelity single-process step on the same batches.  Ranks join a
``file://`` rendezvous (no network): gloo on the CPU (``--device cpu``);
on the card NCCL with one card a rank, or, with one card, both ranks on
it over gloo (CUDA payloads staged through pinned host buffers).
"""
import argparse
import os
import pathlib
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree as T
from repro_torch.collectives import AxisComm
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.launch.train import batch_to_device, init_train_state
from repro_torch.train import optim
from repro_torch.train.grad_compress import WaveletSyncConfig, pod_collective_bytes
from repro_torch.train.train_step import (
    init_podded_error_feedback,
    make_train_step,
    make_wavelet_train_step,
    podded,
    podded_opt,
)

PODS = 2


def rank_main(rank: int, init: str, device: str, steps: int) -> None:
    if device == "cuda":
        card = rank if torch.cuda.device_count() >= PODS else 0
        torch.cuda.set_device(card)
        dev = torch.device("cuda", card)
        backend = "nccl" if torch.cuda.device_count() >= PODS else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(max(1, (os.cpu_count() or PODS) // PODS))
    dist.init_process_group(backend, init_method=init, world_size=PODS, rank=rank)
    try:
        mesh = make_mesh_compat((PODS,), ("pod",), dev.type)
        cfg = reduced(get_config("stablelm-1.6b"))
        state = init_train_state(cfg, 0, dev)  # the same seed: identical replicas
        opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
        sync = WaveletSyncConfig(levels=2, codec="bands", n_pods=PODS, min_size=256)
        if rank == 0:
            raw, comp = pod_collective_bytes(state["params"], sync)
            print(f"inter-pod gradient sync: {raw} -> {comp} wire bytes "
                  f"({raw / comp:.2f}x reduction via integer-DWT band codec); "
                  f"transport {AxisComm(mesh, 'pod').route(dev)}")
        wstep = make_wavelet_train_step(cfg, mesh, opt_cfg, sync)
        bstep = make_train_step(cfg, opt_cfg)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8))
        pw, ow = podded(state["params"], 1), podded_opt(state["opt"], 1)
        err = init_podded_error_feedback(state["params"], 1)
        pb, ob = state["params"], state["opt"]
        for s in range(steps):
            b = batch_to_device(cfg, data.batch(s), dev)
            pw, ow, err, mw = wstep(pw, ow, err, b)
            if rank == 0:
                pb, ob, mb = bstep(pb, ob, b)
                if s % 5 == 0:
                    print(f"step {s:3d}: compressed-sync loss {float(mw['loss']):.4f} | "
                          f"full-fidelity loss {float(mb['loss']):.4f}", flush=True)
        comm = AxisComm(mesh, "pod")
        same = all(torch.equal(leaf, comm.shift(leaf, op="check")) for leaf in T.leaves(pw))
        if rank == 0:
            print("pod replicas bit-identical:", same)
        if not same:
            raise SystemExit(f"rank {rank}: the pod replicas differ")
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA card: pass --device cpu")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{pathlib.Path(tmp) / 'rendezvous'}"
        mp.spawn(rank_main, args=(init, args.device, args.steps), nprocs=PODS, join=True)


if __name__ == "__main__":
    main()
