"""The port's cross-pod gradient sync (``pod_sync_tree``) against ``repro``'s.

The same seeded pod-local gradients and error feedback go through the
reference's ``pod_sync_tree`` under ``shard_map`` on a forced 2-device
CPU mesh (in a subprocess, as ``tests/test_sharded2d.py`` runs it) and
through the port's on a 2-rank gloo world (one process a rank,
``tests/torch_dist_ranks.py``).  Synced gradients and new error feedback
must be equal exactly, on every route: the 2-D and 3-D band codecs, the
last-axis 1-D codec, the ``lowband`` ablation, the ``none`` codec and
leaves under ``min_size`` (raw ``pmean``).  The ring must ship the int16
/ int8 payload: its bytes are counted and held against the analytic
figure.
"""
import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.train import grad_compress as TG
from torch_dist_ranks import run_world

ROOT = Path(__file__).resolve().parents[1]

TREE_2D = {"w": (64, 96), "skinny": (2, 4096), "v": (8000,), "small": (100,)}
TREE_3D = {"act": (6, 16, 24), "w": (64, 96), "v": (8000,)}
BASE = dict(levels=2, n_pods=2, min_size=256)
CONFIGS = [
    (TREE_2D, dict(codec="bands", spatial_2d=True)),  # the reference tests' trees
    (TREE_3D, dict(codec="bands", spatial_3d=True, spatial_2d=True)),
    (TREE_2D, dict(codec="bands")),  # every leaf on the last-axis 1-D route
    (TREE_2D, dict(codec="bands", scheme="97m", mode="jpeg2000", spatial_2d=True)),
    (TREE_3D, dict(codec="bands", scheme="haar", spatial_3d=True)),
    (TREE_2D, dict(codec="lowband")),
    (TREE_2D, dict(codec="none")),
]

REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {src!r})
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh_compat
from repro.train.grad_compress import WaveletSyncConfig, pod_sync_tree
try:
    from jax.experimental.shard_map import shard_map
except ImportError:
    shard_map = jax.shard_map
work = {work!r}
inputs = np.load(os.path.join(work, "inputs.npz"))
mesh = make_mesh_compat((2,), ("pod",))
out = {{}}
for i, c in enumerate(json.loads(str(inputs["cases"]))):
    cfg = WaveletSyncConfig(**c["cfg"])
    grads = {{k: jnp.asarray(inputs[f"c{{i}}_g_{{k}}"]) for k in c["leaves"]}}
    err = {{k: jnp.asarray(inputs[f"c{{i}}_e_{{k}}"]) for k in c["leaves"]}}
    f = shard_map(lambda g, e: pod_sync_tree(g, e, cfg, axis_name="pod"), mesh=mesh,
                  in_specs=(P("pod"), P()), out_specs=(P(), P()), check_rep=False)
    synced, new_err = jax.jit(f)(grads, err)
    for k in c["leaves"]:
        out[f"c{{i}}_s_{{k}}"] = np.asarray(synced[k])
        out[f"c{{i}}_e_{{k}}"] = np.asarray(new_err[k])
np.savez(os.path.join(work, "reference.npz"), **out)
print("OK")
"""


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    work = tmp_path_factory.mktemp("pod_sync")
    rng = np.random.default_rng(5)
    cases, inputs = [], {}
    for i, (tree, cfg) in enumerate(CONFIGS):
        cases.append({"cfg": {**BASE, **cfg}, "leaves": sorted(tree)})
        for k, shape in tree.items():
            # pod-local gradients on a lead axis of 2 pods; error feedback
            # as a previous step would leave it
            inputs[f"c{i}_g_{k}"] = rng.normal(size=(2,) + shape).astype(np.float32)
            inputs[f"c{i}_e_{k}"] = (0.01 * rng.normal(size=shape)).astype(np.float32)
    inputs["cases"] = np.asarray(json.dumps(cases))
    np.savez(work / "inputs.npz", **inputs)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(src=str(ROOT / "src"),
                                                                work=str(work)))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    outs = run_world("pod_sync", 2, work)
    log, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, log[-4000:]
    return cases, inputs, outs, dict(np.load(work / "reference.npz"))


@pytest.mark.sharded
@pytest.mark.parametrize("case", range(len(CONFIGS)),
                         ids=[json.dumps(c, sort_keys=True) for _, c in CONFIGS])
def test_pod_sync_equals_reference_shard_map(synced, case):
    """Every leaf's synced mean and new error feedback equal the
    reference's exactly (the reference's ``P()`` outputs are pod 0's;
    every port rank's synced leaf is the same)."""
    cases, _inputs, outs, ref = synced
    for k in cases[case]["leaves"]:
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(out[f"c{case}_s_{k}"], ref[f"c{case}_s_{k}"],
                                          err_msg=f"synced {k} rank {r}")
        np.testing.assert_array_equal(outs[0][f"c{case}_e_{k}"], ref[f"c{case}_e_{k}"],
                                      err_msg=f"error feedback {k}")


@pytest.mark.sharded
def test_pod_sync_converges_to_mean(synced):
    """As the reference's tests: band codecs reconstruct ~the pod mean."""
    cases, inputs, outs, _ref = synced
    for i, c in enumerate(cases):
        if c["cfg"]["codec"] != "bands":
            continue
        for k in c["leaves"]:
            want = inputs[f"c{i}_g_{k}"].mean(axis=0)
            e = inputs[f"c{i}_e_{k}"]
            got = outs[0][f"c{i}_s_{k}"][0]
            rel = np.linalg.norm(got - want - e) / np.linalg.norm(want)
            assert rel < 0.05, (c, k, rel)


@pytest.mark.sharded
def test_ring_ships_the_quantized_payload(synced):
    """The ring's bytes per hop (one hop with 2 pods) are the int16 / int8
    band payloads: ``pod_collective_bytes``'s figure for the banded
    leaves, less its 8 bytes a slice for the scale and shifts, which go
    by ``all_reduce`` and not by the ring."""
    cases, _inputs, outs, _ref = synced
    want = 0
    for c in cases:
        cfg = TG.WaveletSyncConfig(**c["cfg"])
        tree = {k: np.zeros((1,) + shape, np.float32) for k, shape in
                (TREE_2D if "skinny" in c["leaves"] else TREE_3D).items()}
        for k, leaf in tree.items():
            route = TG.leaf_route(leaf, cfg)
            if route in ("raw", "lowband"):
                continue
            _raw, comp = TG.pod_collective_bytes({k: leaf}, cfg)
            slices = 1 if route == "1d" else leaf.size // math.prod(
                leaf.shape[-3:] if route == "3d" else leaf.shape[-2:])
            want += comp - 8 * slices
    assert want > 0
    for out in outs:
        assert int(out["ring_bytes"]) == want


def test_pod_sync_refuses_a_mismatched_ring(tmp_path):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat

    g = {"w": torch.zeros(4)}
    with pytest.raises(ValueError, match="mesh"):
        TG.pod_sync_tree(g, g, TG.WaveletSyncConfig())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh_compat((1,), ("pod",), "cpu")
        with pytest.raises(ValueError, match="n_pods=2"):
            TG.pod_sync_tree(g, g, TG.WaveletSyncConfig(), mesh=mesh)
        one = TG.WaveletSyncConfig(n_pods=1, min_size=1)
        out, err = TG.pod_sync_tree({"w": torch.ones(64)}, {"w": torch.zeros(64)}, one,
                                    mesh=mesh)
        assert out["w"].shape == (64,) and torch.isfinite(err["w"]).all()
    finally:
        dist.destroy_process_group()
