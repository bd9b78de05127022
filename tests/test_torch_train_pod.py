"""The port's wavelet-synced multi-pod train step against ``repro``'s.

The reference's ``make_wavelet_train_step`` runs under ``shard_map`` on a
forced 2-device CPU mesh (in a subprocess, as ``tests/test_torch_pod_sync.py``
runs the sync); the port's runs SPMD on a 2-rank gloo world (one process
a rank, ``tests/torch_dist_ranks.py``).  Both start from the same reduced
stablelm-2-1.6b parameters (drawn with numpy by the reference's rule) and
train on the same ``SyntheticLM`` batches for 3 steps, once with the
last-axis 1-D codec and once with the 2-D and 3-D codecs on
(``WaveletSyncConfig(levels=2, codec="bands", n_pods=2, min_size=256)``).

Held: the pod replicas (params, moments, step) are bit-identical across
the ranks after every step; the loss is within 1e-4 relative of the
reference's at each step and within 5% of the port's own plain step on
the same batches (the reference's ``tests/test_distributed.py`` bound);
the ring ships each step's int16 / int8 band payload, no more.
"""
import json
import math
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import reduced as r_reduced
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import tree as TT
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.train import grad_compress as TG
from repro_torch.train import optim as O
from repro_torch.train import train_step as S
from torch_dist_ranks import run_world

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ = 3, 8, 32
SYNC = dict(levels=2, codec="bands", n_pods=2, min_size=256)
CASES = [dict(SYNC), dict(SYNC, spatial_2d=True, spatial_3d=True)]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=6)

REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {src!r})
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.launch.mesh import make_mesh_compat
from repro.models import layers as L, transformer as T
from repro.train import optim
from repro.train.grad_compress import WaveletSyncConfig
from repro.train.train_step import (make_wavelet_train_step, init_podded_error_feedback,
                                    podded, podded_opt)
work = {work!r}
inputs = np.load(os.path.join(work, "inputs.npz"))
cfg = reduced(get_config("stablelm-1.6b"))
defs = T.model_defs(cfg)
treedef = jax.tree_util.tree_structure(defs, is_leaf=lambda x: isinstance(x, L.ParamDef))
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(inputs[f"p{{j}}"]) for j in range(treedef.num_leaves)])
mesh = make_mesh_compat((2, 1, 1), ("pod", "data", "model"))
opt_cfg = optim.AdamWConfig(**json.loads(str(inputs["opt_cfg"])))
out = {{}}
for i, c in enumerate(json.loads(str(inputs["cases"]))):
    step = make_wavelet_train_step(cfg, mesh, opt_cfg, WaveletSyncConfig(**c["sync"]))
    with mesh:
        pw, ow = podded(params, 2), podded_opt(optim.adamw_init(params), 2)
        err = init_podded_error_feedback(params, 2)
        for s in range(c["steps"]):
            b = {{k: jnp.asarray(inputs[f"b{{s}}_{{k}}"]) for k in ("tokens", "labels")}}
            pw, ow, err, m = step(pw, ow, err, b)
            for k, v in m.items():
                out[f"c{{i}}_s{{s}}_{{k}}"] = np.asarray(v)
            for j, leaf in enumerate(jax.tree_util.tree_leaves(pw)):
                out[f"c{{i}}_s{{s}}_p{{j}}"] = np.asarray(leaf[0])
np.savez(os.path.join(work, "reference.npz"), **out)
print("OK")
"""


def _host_params(seed):
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return (np.zeros if d.init == "zeros" else np.ones)(d.shape, np.float32)
        std = 1.0 if d.init == "embed" else d.scale / np.sqrt(max(d.shape[0], 1))
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    defs = RT.model_defs(r_reduced(r_get_config("stablelm-1.6b")))
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        draw, defs, is_leaf=lambda x: isinstance(x, RL.ParamDef)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_pod")
    cfg = reduced(get_config("stablelm-1.6b"))
    leaves = _host_params(4)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH))
    batches = [data.batch(s) for s in range(STEPS)]
    inputs = {f"p{j}": a for j, a in enumerate(leaves)}
    inputs.update({f"b{s}_{k}": v for s, b in enumerate(batches) for k, v in b.items()})
    inputs["cases"] = np.asarray(json.dumps([{"sync": c, "steps": STEPS} for c in CASES]))
    inputs["opt_cfg"] = np.asarray(json.dumps(OPT))
    np.savez(work / "inputs.npz", **inputs)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(src=str(ROOT / "src"),
                                                                work=str(work)))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        outs = run_world("train_pod", 2, work)
        # the port's plain step on the global batch, from the same parameters
        params = L.params_from_numpy(TT.unflatten(TF.model_defs(cfg), leaves), "cpu")
        step = S.make_train_step(cfg, O.AdamWConfig(**OPT))
        opt, plain = O.adamw_init(params), []
        for b in batches:
            params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
            plain.append(float(m["loss"]))
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-4000:]
    return outs, dict(np.load(work / "reference.npz")), plain, leaves


@pytest.mark.sharded
@pytest.mark.parametrize("case", range(len(CASES)), ids=["1d", "spatial"])
def test_pod_replicas_stay_bit_identical(runs, case):
    outs, _ref, _plain, leaves = runs
    a, b = outs
    for s in range(STEPS):
        for j in range(len(leaves)):
            np.testing.assert_array_equal(a[f"c{case}_s{s}_p{j}"], b[f"c{case}_s{s}_p{j}"],
                                          err_msg=f"step {s} leaf {j}")
    for j in range(len(leaves)):
        np.testing.assert_array_equal(a[f"c{case}_m{j}"], b[f"c{case}_m{j}"])
        np.testing.assert_array_equal(a[f"c{case}_v{j}"], b[f"c{case}_v{j}"])
    assert int(a[f"c{case}_step"]) == int(b[f"c{case}_step"]) == STEPS


@pytest.mark.sharded
@pytest.mark.parametrize("case", range(len(CASES)), ids=["1d", "spatial"])
def test_wavelet_step_loss_matches_the_reference_and_the_plain_step(runs, case):
    outs, ref, plain, _leaves = runs
    for s in range(STEPS):
        loss = float(outs[0][f"c{case}_s{s}_loss"])
        assert float(outs[1][f"c{case}_s{s}_loss"]) == loss  # the pod mean, on every rank
        np.testing.assert_allclose(loss, float(ref[f"c{case}_s{s}_loss"]), rtol=1e-4)
        assert abs(loss - plain[s]) <= 0.05 * abs(plain[s]), (s, loss, plain[s])
        # the gradient norm only at step 0: from step 1 the parameters
        # differ by up to 2 lr where a sign-like first step flipped, and
        # the synced gradients' norms by up to ~0.3%
        for k in ("ce", "lr") + (("grad_norm",) if s == 0 else ()):
            np.testing.assert_allclose(float(outs[0][f"c{case}_s{s}_{k}"]),
                                       float(ref[f"c{case}_s{s}_{k}"]), rtol=1e-4, err_msg=k)
    assert sorted(k.split("_", 2)[2] for k in outs[0] if k.startswith(f"c{case}_s0_")
                  and not k[len(f"c{case}_s0_"):].startswith("p")) == [
        "ce", "grad_norm", "loss", "lr", "moe_aux", "ring_bytes"]


@pytest.mark.sharded
@pytest.mark.parametrize("case", range(len(CASES)), ids=["1d", "spatial"])
def test_wavelet_step_params_near_the_reference(runs, case):
    """Parameters within ``3 lr`` of the reference's pod replica after
    every step (the AdamW steps are sign-like; see tests/test_torch_train.py)."""
    outs, ref, _plain, leaves = runs
    for s in range(STEPS):
        for j in range(len(leaves)):
            diff = np.abs(outs[0][f"c{case}_s{s}_p{j}"] - ref[f"c{case}_s{s}_p{j}"])
            assert diff.max() <= 3 * OPT["lr"], (s, j, float(diff.max()))


@pytest.mark.sharded
@pytest.mark.parametrize("case", range(len(CASES)), ids=["1d", "spatial"])
def test_ring_ships_the_band_payload_each_step(runs, case):
    """Each step's ring bytes a hop equal ``pod_collective_bytes``' payload
    of the banded leaves, less the 8 bytes a slice that the scale and
    shifts take by ``all_reduce``."""
    outs, _ref, _plain, leaves = runs
    cfg = TG.WaveletSyncConfig(**CASES[case])
    want = 0
    for leaf in leaves:
        route = TG.leaf_route(leaf, cfg)
        if route in ("raw", "lowband"):
            continue
        slices = 1 if route == "1d" else leaf.size // math.prod(
            leaf.shape[-3:] if route == "3d" else leaf.shape[-2:])
        want += TG.pod_collective_bytes({"x": leaf}, cfg)[1] - 8 * slices
    routes = {TG.leaf_route(leaf, cfg) for leaf in leaves}
    assert routes == ({"1d", "raw"} if case == 0 else {"3d", "2d", "raw"}), routes
    for out in outs:
        for s in range(STEPS):
            assert int(out[f"c{case}_s{s}_ring_bytes"]) == want


def test_wavelet_step_refuses_replicated_trees():
    """The step's trees are the rank's pod block (leading axis 1)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat

    cfg = reduced(get_config("stablelm-1.6b"))
    params = {"w": torch.zeros(4, 4)}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", world_size=1, rank=0)
        try:
            mesh = make_mesh_compat((1,), ("pod",), "cpu")
            step = S.make_wavelet_train_step(cfg, mesh, sync_cfg=TG.WaveletSyncConfig(n_pods=1))
            with pytest.raises(ValueError, match="leading pod axis"):
                step(S.podded(params, 2), S.podded_opt(O.adamw_init(params), 2),
                     S.init_podded_error_feedback(params, 2), {})
        finally:
            dist.destroy_process_group()


def test_podded_helpers_mirror_the_reference():
    import jax.numpy as jnp

    from repro.train import optim as RO
    from repro.train import train_step as RS

    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(4, np.float32)}
    rt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    for got, want in ((S.podded(tt, 3), RS.podded(rt, 3)),
                      (S.unpodded(S.podded(tt, 3)), RS.unpodded(RS.podded(rt, 3))),
                      (S.init_podded_error_feedback(tt, 2), RS.init_podded_error_feedback(rt, 2))):
        for k in tree:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    po, ro = S.podded_opt(O.adamw_init(tt), 2), RS.podded_opt(RO.adamw_init(rt), 2)
    assert po.step.shape == () and int(po.step) == int(ro.step) == 0
    for k in tree:
        assert tuple(po.m[k].shape) == ro.m[k].shape and tuple(po.v[k].shape) == ro.v[k].shape
