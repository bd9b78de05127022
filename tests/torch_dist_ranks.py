"""Rank programs for the port's multi-rank CPU tests (gloo, one process a rank).

Run by ``run_world`` below, never collected by pytest:

    python tests/torch_dist_ranks.py JOB RANK WORLD INIT_FILE WORKDIR

Each rank joins a ``file://`` rendezvous at INIT_FILE, reads its inputs
from WORKDIR/inputs.npz (written by the test), runs JOB and writes
WORKDIR/out_<RANK>.npz for the test to compare.  These programs import
torch, numpy and the port only, so a rank starts in about a second.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run_world(job: str, world: int, workdir: Path, timeout: float = 240.0) -> list:
    """Start ``world`` ranks of ``job`` and wait for all; returns each
    rank's outputs (``np.load`` of out_<rank>.npz).  Fails with every
    rank's output if any rank fails or the world outlives ``timeout``."""
    init = workdir / "rendezvous"
    init.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), str(init), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs))
    return [dict(np.load(workdir / f"out_{r}.npz", allow_pickle=False)) for r in range(world)]


# ---------------------------------------------------------------------------
# Rank programs.
# ---------------------------------------------------------------------------


def _cases(inputs) -> list:
    return json.loads(str(inputs["cases"]))


def _leaves(pyr) -> list:
    return [pyr.ll] + [b for lvl in pyr.details for b in lvl]


def job_sharded(rank: int, world: int, inputs, out: dict) -> None:
    """The sharded transform over each case's mesh: forward, inverse,
    placements and local shapes, the inverse from full bands, and the
    serve engine on the mesh."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_mesh_compat

    meshes = {"4": make_mesh_compat((world,), ("data",), "cpu"),
              "2x2": make_mesh_compat((2, 2), ("data", "model"), "cpu")}
    for i, c in enumerate(_cases(inputs)):
        mesh = meshes[c["mesh"]]
        x = torch.from_numpy(inputs[f"x{i}"])
        if c["dtensor_in"]:  # this rank's rows only, as a DTensor
            rows = x.shape[-2] // world if c["mesh"] == "4" else x.shape[-2] // 2
            idx = mesh.get_local_rank("data")
            local = x[..., idx * rows:(idx + 1) * rows, :].contiguous()
            x = DTensor.from_local(local, mesh, K.sharded._row_placements(mesh, x.ndim, "data"))
        kw = dict(mode=c["mode"], scheme=c["scheme"], checked=c["checked"])
        pyr = K.dwt_fwd_2d_sharded(x, mesh, levels=c["levels"], **kw)
        for j, b in enumerate(_leaves(pyr)):
            out[f"c{i}_b{j}"] = b.full_tensor().numpy()
            out[f"c{i}_b{j}_local"] = np.asarray(b.to_local().shape)
        out[f"c{i}_sharded"] = np.asarray(all(
            isinstance(b, DTensor) and b.placements[0] == Shard(b.ndim - 2)
            and b.to_local().shape[-2] * mesh.size(0) == b.shape[-2] for b in _leaves(pyr)))
        xr = K.dwt_inv_2d_sharded(pyr, mesh, **kw)
        out[f"c{i}_inv"] = xr.full_tensor().numpy()
        full = type(pyr)(pyr.ll.full_tensor(),
                         tuple(tuple(b.full_tensor() for b in lvl) for lvl in pyr.details))
        out[f"c{i}_inv_full"] = K.dwt_inv_2d_sharded(full, mesh, **kw).full_tensor().numpy()
    _serve_on_mesh(meshes["4"], inputs, out)


def _serve_on_mesh(mesh, inputs, out: dict) -> None:
    from repro_torch.serve import TransformRequest, WaveletServeEngine

    eng = WaveletServeEngine(buckets=[(32, 32), (64, 64)], batch_slots=2, levels=2,
                             scheme="cdf53", mode="jpeg2000", device="cpu",
                             encode_response=True, mesh=mesh)
    eng.warmup()
    n = int(inputs["n_requests"])
    done = eng.run([TransformRequest(uid=i, image=inputs[f"req{i}"]) for i in range(n)])
    for r in done:
        for j, b in enumerate(_leaves(r.pyramid)):
            out[f"req{r.uid}_b{j}"] = b.numpy()
        out[f"req{r.uid}_enc"] = np.frombuffer(r.encoded, np.uint8)
        out[f"req{r.uid}_idx"] = np.asarray(r.batch_index)


def job_pod_sync(rank: int, world: int, inputs, out: dict) -> None:
    """``pod_sync_tree`` on each config, this rank's block of each leaf."""
    import torch

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train.grad_compress import WaveletSyncConfig, pod_sync_tree

    mesh = make_mesh_compat((world,), ("pod",), "cpu")
    for i, c in enumerate(_cases(inputs)):
        cfg = WaveletSyncConfig(**c["cfg"])
        names = c["leaves"]
        grads = {k: torch.from_numpy(inputs[f"c{i}_g_{k}"][rank:rank + 1]) for k in names}
        err = {k: torch.from_numpy(inputs[f"c{i}_e_{k}"]) for k in names}
        synced, new_err = pod_sync_tree(grads, err, cfg, axis_name="pod", mesh=mesh)
        for k in names:
            out[f"c{i}_s_{k}"] = synced[k].numpy()
            out[f"c{i}_e_{k}"] = new_err[k].numpy()
    from repro_torch import obs

    out["ring_bytes"] = np.asarray(sum(
        v for k, v in obs.snapshot()["metrics"].items()
        if k.startswith("collectives.wire_bytes") and 'op="ring"' in k))


def job_pod_sync_wire(rank: int, world: int, inputs, out: dict) -> None:
    """``pod_sync_tree`` on each config; the ``collectives.wire_bytes``
    counters of each sync, by ``op`` label (bytes this rank sent)."""
    import re

    import torch

    from repro_torch import obs
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train.grad_compress import WaveletSyncConfig, pod_sync_tree

    mesh = make_mesh_compat((world,), ("pod",), "cpu")
    for i, c in enumerate(_cases(inputs)):
        names = c["leaves"]
        grads = {k: torch.from_numpy(inputs[f"c{i}_g_{k}"][rank]) for k in names}
        err = {k: torch.zeros(grads[k].shape) for k in names}
        obs.reset()
        pod_sync_tree(grads, err, WaveletSyncConfig(**c["cfg"]), axis_name="pod", mesh=mesh)
        wire: dict = {}
        for key, v in obs.snapshot()["metrics"].items():
            if key.startswith("collectives.wire_bytes"):
                op = re.search(r'op="([^"]+)"', key).group(1)
                wire[op] = wire.get(op, 0) + int(v)
        out[f"c{i}_wire"] = np.asarray(json.dumps(wire))


def job_reshard(rank: int, world: int, inputs, out: dict) -> None:
    """``ckpt.ft.reshard_to_mesh`` of a host tree onto a mesh."""
    from repro_torch import sharding as SH
    from repro_torch.ckpt.ft import reshard_to_mesh
    from repro_torch.launch.mesh import make_mesh_compat

    mesh = make_mesh_compat((world,), ("data",), "cpu")
    tree = {"w": inputs["w"], "b": [inputs["b"]]}
    axes = {"w": ("batch", "embed"), "b": [("embed",)]}
    placed = reshard_to_mesh(tree, SH.tree_shardings(axes, SH.base_rules(False), mesh))
    out["w_local"] = placed["w"].to_local().numpy()
    out["b_local"] = placed["b"][0].to_local().numpy()
    out["w_full"] = placed["w"].full_tensor().numpy()
    out["w_placements"] = np.asarray(str(tuple(placed["w"].placements)))
    out["b_placements"] = np.asarray(str(tuple(placed["b"][0].placements)))


def job_train_pod(rank: int, world: int, inputs, out: dict) -> None:
    """``make_wavelet_train_step`` on a reduced stablelm: each case's steps
    from the same parameters, this rank's replica and metrics after each
    step, and the ring's bytes a step."""
    import torch

    from repro_torch import obs
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.train import optim as O
    from repro_torch.train import train_step as S
    from repro_torch.train.grad_compress import WaveletSyncConfig

    cfg = reduced(get_config("stablelm-1.6b"))
    mesh = make_mesh_compat((world,), ("pod",), "cpu")
    defs = TF.model_defs(cfg)
    params = L.params_from_numpy(
        T.unflatten(defs, [inputs[f"p{j}"] for j in range(len(T.leaves(defs)))]), "cpu")
    opt_cfg = O.AdamWConfig(**json.loads(str(inputs["opt_cfg"])))
    for i, c in enumerate(_cases(inputs)):
        step = S.make_wavelet_train_step(cfg, mesh, opt_cfg, WaveletSyncConfig(**c["sync"]))
        p = S.podded(params, 1)
        o = S.podded_opt(O.adamw_init(params), 1)
        err = S.init_podded_error_feedback(params, 1)
        for s in range(c["steps"]):
            batch = {k: torch.from_numpy(inputs[f"b{s}_{k}"]) for k in ("tokens", "labels")}
            obs.reset()
            p, o, err, metrics = step(p, o, err, batch)
            out[f"c{i}_s{s}_ring_bytes"] = np.asarray(sum(
                v for k, v in obs.snapshot()["metrics"].items()
                if k.startswith("collectives.wire_bytes") and 'op="ring"' in k))
            for k, v in metrics.items():
                out[f"c{i}_s{s}_{k}"] = v.numpy()
            for j, leaf in enumerate(T.leaves(p)):
                out[f"c{i}_s{s}_p{j}"] = leaf.numpy()
        for j, (m, v) in enumerate(zip(T.leaves(o.m), T.leaves(o.v))):
            out[f"c{i}_m{j}"], out[f"c{i}_v{j}"] = m.numpy(), v.numpy()
        out[f"c{i}_step"] = o.step.numpy()


JOBS = {"sharded": job_sharded, "pod_sync": job_pod_sync, "reshard": job_reshard,
        "train_pod": job_train_pod, "pod_sync_wire": job_pod_sync_wire}


def main() -> int:
    job, rank, world, init, workdir = sys.argv[1:6]
    rank, world, workdir = int(rank), int(world), Path(workdir)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank)
    try:
        out: dict = {}
        with np.load(workdir / "inputs.npz", allow_pickle=False) as inputs:
            JOBS[job](rank, world, inputs, out)
        np.savez(workdir / f"out_{rank}.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
