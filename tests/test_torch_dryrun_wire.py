"""The pod sync's wire accounting (``train.grad_compress``:
``pod_collective_bytes``, ``pod_sync_ops``, ``pod_sync_schedule``) and
``launch/dryrun_wavelet.py``.

* ``pod_collective_bytes`` equals the reference's on full-width trees of
  every arch (``meta`` tensors against ``ShapeDtypeStruct`` leaves), for
  1-3 levels with the spatial codecs on and off.
* The shape-only schedule equals what ``pod_sync_tree`` sends: its
  payload bytes by op equal the ``collectives.wire_bytes{route,op}``
  counters of a real sync on 2 gloo ranks (``tests/torch_dist_ranks.py``,
  one world for the file), on a tree that takes every route (raw, 1d,
  2d, 3d; lowband and the ``codec="none"`` baseline on their own).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RLAY
from repro.models import transformer as RT
from repro.train import grad_compress as RG
from repro_torch import roofline as RL
from repro_torch import tree as TR
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun_wavelet as DW
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import grad_compress as G

from torch_dist_ranks import run_world

# every route: odd and even last axes for the 1-D route, a matrix for 2-D,
# a volume for 3-D, leaves under min_size for raw
TREE = {"vol": (6, 16, 24), "w": (64, 96), "odd": (3, 1001), "v": (8000,), "small": (100,),
        "stack": (2, 9, 40, 12)}
BASE = dict(levels=2, n_pods=2, min_size=256)
CONFIGS = [
    dict(codec="bands", spatial_2d=True, spatial_3d=True),
    dict(codec="bands"),
    dict(codec="bands", levels=3, scheme="haar", spatial_2d=True),
    dict(codec="lowband"),
    dict(codec="none"),
]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pod_collective_bytes_equal_reference_full_width(arch):
    cfg = get_config(arch)
    port = L.abstract_params(T.model_defs(cfg), torch.bfloat16)
    ref = jax.tree_util.tree_map(lambda d: jax.ShapeDtypeStruct(d.shape, jnp.bfloat16),
                                 RT.model_defs(cfg),
                                 is_leaf=lambda x: isinstance(x, RLAY.ParamDef))
    for levels in (1, 2, 3):
        for s2, s3 in ((False, False), (True, False), (True, True)):
            kw = dict(levels=levels, spatial_2d=s2, spatial_3d=s3)
            assert G.pod_collective_bytes(port, G.WaveletSyncConfig(**kw)) == \
                RG.pod_collective_bytes(ref, RG.WaveletSyncConfig(**kw)), (arch, kw)


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    work = tmp_path_factory.mktemp("pod_sync_wire")
    rng = np.random.default_rng(11)
    inputs = {f"c0_g_{k}": rng.normal(size=(2,) + shape).astype(np.float32)
              for k, shape in TREE.items()}
    for i in range(1, len(CONFIGS)):
        inputs.update({f"c{i}_g_{k}": inputs[f"c0_g_{k}"] for k in TREE})
    cases = [{"cfg": {**BASE, **c}, "leaves": sorted(TREE)} for c in CONFIGS]
    inputs["cases"] = np.asarray(json.dumps(cases))
    np.savez(work / "inputs.npz", **inputs)
    outs = run_world("pod_sync_wire", 2, work)
    return [[json.loads(str(out[f"c{i}_wire"])) for out in outs] for i in range(len(CONFIGS))]


def _abstract(tree):
    return {k: torch.empty(shape, device="meta") for k, shape in tree.items()}


@pytest.mark.parametrize("case", range(len(CONFIGS)),
                         ids=[json.dumps(c, sort_keys=True) for c in CONFIGS])
def test_schedule_equals_what_the_sync_sends(synced, case):
    cfg = G.WaveletSyncConfig(**{**BASE, **CONFIGS[case]})
    routes = {G.leaf_route(v, cfg) for v in _abstract(TREE).values()}
    if CONFIGS[case].get("spatial_3d"):
        assert routes == {"raw", "1d", "2d", "3d"}
    payload = {}
    for label, _op, b, _k in G.pod_sync_ops(_abstract(TREE), cfg):
        payload[label] = payload.get(label, 0) + b
    for rank_wire in synced[case]:
        assert rank_wire == payload
    # two pods: every op's ring-formula wire is its payload
    assert G.pod_sync_schedule(_abstract(TREE), cfg).by_op_bytes == {
        k: float(v) for k, v in payload.items()}


def test_schedule_counts_and_ring_formulas_at_four_pods():
    cfg = G.WaveletSyncConfig(**{**BASE, "n_pods": 4, "spatial_2d": True, "spatial_3d": True})
    ops = G.pod_sync_ops(_abstract(TREE), cfg)
    stats = G.pod_sync_schedule(_abstract(TREE), cfg)
    ring = [b for label, _, b, _ in ops if label == "ring"]
    assert stats.counts["ring"] == len(ring) and len(ring) % 3 == 0  # n - 1 hops a band
    assert stats.by_op_bytes["ring"] == sum(ring)
    reduces = sum(b for label, _, b, _ in ops if label != "ring")
    assert stats.wire_bytes_per_device == sum(ring) + 2 * reduces * 3 / 4
    assert RL.wire_bytes("all-reduce", 4, 4, 4) == 6.0


def test_dryrun_wavelet_against_the_baseline():
    r = DW.wavelet_result("stablelm-1.6b", "train_4k", 2)
    params = L.abstract_params(T.model_defs(get_config("stablelm-1.6b")), torch.bfloat16)
    n = sum(p.numel() for p in TR.leaves(params))
    assert r["baseline_wire_per_device"] == 4 * n  # float32, 2 pods: 2 x (1/2) x payload
    assert r["analytic_pod_bytes_fp32"] == 4 * n
    assert r["pod_axis_reduction"] > 3 and r["analytic_ratio"] > 3
    assert r["wavelet_pod_counts"]["ring"] == r["wavelet_pod_counts"]["pmax"] * 3 // 2
    assert r["ring_bytes_per_hop"] == r["wavelet_by_op_bytes"]["ring"]
    cfg, stats, mesh = DW.lower_wavelet_cell("stablelm-1.6b", "train_4k", 2, n_layers=4,
                                             min_size=256, spatial_2d=True, spatial_3d=True)
    assert cfg.n_layers == 4 and mesh.axes["pod"] == 2 and stats.counts["ring"] > 0
    assert DW.main(["--arch", "rwkv6-7b", "--levels", "1", "--no-save"]) == 0

