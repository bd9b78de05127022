"""The port's checkpoints (``repro_torch.ckpt``) against the reference
``repro.ckpt``.

The same seeded host arrays go through both packages on the CPU: every
codec's leaf files must be equal byte for byte and every manifest entry
equal (name, file, sha256, shape, dtype, codec, meta with ``scale`` a
float), for float32 and bfloat16 leaves of 1-D to 4-D shapes and every
scheme; a checkpoint written by either package must restore in the
other to the same values.  Then the manager's own contract on the port's
side: keep-k, atomic commits and the ``ckpt.save.*`` crash sites, the
async save's snapshot, self-healing and integrity errors, the
``enc_version`` refusal, and the resumable train loop.
"""
import collections
import json
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RCK
from repro.ckpt.ft import TrainLoopRunner as RRunner
from repro_torch import ckpt as TCKPT
from repro_torch import tree as TTREE
from repro_torch.ckpt import checkpoint as TCK
from repro_torch.ckpt.ft import StragglerWatchdog, TrainLoopRunner, reshard_to_mesh
from repro_torch.resilience import inject as TINJ
from repro_torch.resilience.errors import CheckpointIntegrityError, DegradedRestoreWarning

CODECS = ("raw", "z", "wz", "wz2d", "wz3d", "wz-rice")
WAVELET = ("wz", "wz2d", "wz3d", "wz-rice")
STEP = "step_0000000001"


def _host_tree(seed=0, small=False):
    """float32 and bfloat16 leaves of every route, a scalar, nested lists;
    ``small``: one leaf a route (1-D, 2-D bf16, 4-D)."""
    rng = np.random.default_rng(seed)

    def f32(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    if small:
        return {"vec": f32(40), "bf_mat": f32(16, 12, s=0.02).astype(ml_dtypes.bfloat16),
                "stack": f32(2, 4, 8, 8)}
    return {
        "vec": f32(40),
        "mat": f32(24, 40),
        "vol": f32(6, 8, 8),
        "stack": f32(2, 4, 8, 8),
        "bf_mat": f32(16, 12, s=0.02).astype(ml_dtypes.bfloat16),
        "bf_stack": f32(4, 8, 4, 4, s=0.02).astype(ml_dtypes.bfloat16),
        "layers": [f32(5), {"b": f32(7, 9)}],
        "s": np.float32(2.5),
    }


def _mgr(cls, path, **kw):
    if cls is TCK.CheckpointManager:
        kw.setdefault("device", "cpu")
    return cls(path, **kw)


def _leaf_files(path):
    step = pathlib.Path(path) / STEP
    man = json.loads((step / "manifest.json").read_text())
    return man, {n: (step / m["file"]).read_bytes() for n, m in man["leaves"].items()}


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.to(torch.float32).numpy()
    return np.asarray(a).astype(np.float32)


def _cases():
    out = [(c, "cdf53") for c in CODECS]
    out += [(c, s) for c in WAVELET for s in ("haar", "cdf22", "97m")]
    return out


@pytest.mark.parametrize("codec,scheme", _cases())
def test_leaf_bytes_manifest_and_cross_restore_equal_the_reference(tmp_path, codec, scheme):
    tree = _host_tree(small=scheme != "cdf53")
    kw = dict(codec=codec, wavelet_scheme=scheme, keep=1)
    _mgr(RCK.CheckpointManager, tmp_path / "r", **kw).save(1, tree)
    _mgr(TCK.CheckpointManager, tmp_path / "t", **kw).save(1, TCKPT.tree_from_numpy(tree, "cpu"))
    rman, rfiles = _leaf_files(tmp_path / "r")
    tman, tfiles = _leaf_files(tmp_path / "t")
    assert tman == rman
    assert list(tman["leaves"]) == list(rman["leaves"])
    assert tfiles == rfiles
    assert (tmp_path / "t" / STEP / "manifest.json").read_bytes() == (
        tmp_path / "r" / STEP / "manifest.json").read_bytes()
    for m in tman["leaves"].values():
        assert isinstance(m["meta"].get("scale", 0.0), float)
    # the reference's checkpoint restores in the port and vice versa
    _, in_port = _mgr(TCK.CheckpointManager, tmp_path / "r", **kw).restore(template=tree)
    _, in_ref = _mgr(RCK.CheckpointManager, tmp_path / "t", **kw).restore(template=tree)
    got, want = TTREE.leaf_paths(in_port), RCK._leaf_paths(in_ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert str(a.dtype).replace("torch.", "") == str(np.asarray(b).dtype), name
        np.testing.assert_array_equal(_as_f32(a), _as_f32(b), err_msg=name)
    if codec in ("raw", "z"):
        for (name, a), (_, b) in zip(got, RCK._leaf_paths(tree)):
            np.testing.assert_array_equal(_as_f32(a), _as_f32(b), err_msg=name)


def test_leaf_names_follow_the_reference_walk():
    NT = collections.namedtuple("NT", "zeta alpha")
    tree = {"z": [1.0, (2.0, NT(3.0, 4.0))], "a": {"y": 5.0, "b": None, "B": {10: 6.0, 2: 7.0}},
            "o": collections.OrderedDict([("q", 8.0), ("p", 9.0)])}
    assert [n for n, _ in TTREE.leaf_paths(tree)] == [n for n, _ in RCK._leaf_paths(tree)]
    rebuilt = TTREE.unflatten(tree, list(range(9)))
    assert rebuilt["z"][1][1] == NT(7, 8) and rebuilt["a"]["b"] is None
    assert list(rebuilt["o"]) == ["q", "p"] and rebuilt["a"]["B"] == {10: 1, 2: 0}
    with pytest.raises(ValueError):
        TTREE.unflatten(tree, list(range(10)))


def test_tree_from_and_to_numpy_carry_bfloat16_bits():
    tree = _host_tree(seed=3)
    t = TCKPT.tree_from_numpy(tree, "cpu")
    assert t["bf_mat"].dtype == torch.bfloat16 and t["s"].dtype == torch.float32
    back = TCKPT.tree_to_numpy(t)
    for (n, a), (_, b) in zip(TTREE.leaf_paths(back), TTREE.leaf_paths(tree)):
        want = np.asarray(b).dtype
        assert a.dtype == (np.uint16 if want.name == "bfloat16" else want), n
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(np.asarray(b)).view(np.uint8))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            TCKPT.tree_from_numpy(tree)


def test_wavelet_codecs_restore_within_the_quantization_bound(tmp_path):
    """Every value within 0.51 x its leaf's scale (the reference's bound),
    plus one bfloat16 rounding for bfloat16 leaves."""
    tree = TCKPT.tree_from_numpy(_host_tree(seed=4), "cpu")
    for codec in WAVELET:
        mgr = TCK.CheckpointManager(tmp_path / codec, codec=codec, device="cpu")
        mgr.save(1, tree)
        _, out = mgr.restore(template=tree)
        man, _ = _leaf_files(tmp_path / codec)
        for name, a in TTREE.leaf_paths(tree):
            b = dict(TTREE.leaf_paths(out))[name]
            err = (b.to(torch.float64) - a.to(torch.float64)).abs().max().item()
            bound = 0.51 * man["leaves"][name]["meta"]["scale"]
            if a.dtype == torch.bfloat16:
                bound += a.abs().max().item() * 2.0**-8
            assert err <= bound, (codec, name, err, bound)


def test_keep_k_atomicity_and_latest(tmp_path):
    mgr = TCK.CheckpointManager(tmp_path, keep=2, codec="z", device="cpu")
    t = {"a": torch.arange(12, dtype=torch.int32)}
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_0000000003", "step_0000000004"]
    assert mgr.latest_step() == 4
    (tmp_path / ".tmp_step_0000000005_0").mkdir()  # a crashed later save
    assert mgr.latest_step() == 4
    assert mgr.compression_report()["raw_bytes"] == 48
    with pytest.raises(FileNotFoundError):
        TCK.CheckpointManager(tmp_path / "empty", device="cpu").restore()


@pytest.mark.parametrize("site", ["ckpt.save.before_write", "ckpt.save.mid_write",
                                  "ckpt.save.before_commit"])
def test_save_crash_leaves_previous_intact(tmp_path, site):
    mgr = TCK.CheckpointManager(tmp_path, codec="wz", device="cpu")
    tree = TCKPT.tree_from_numpy(_host_tree(seed=5), "cpu")
    mgr.save(1, tree)
    _, before = mgr.restore(template=tree)
    with TINJ.armed(site):
        with pytest.raises(TINJ.InjectedFault):
            mgr.save(2, TCKPT.tree_from_numpy(_host_tree(seed=6), "cpu"))
    assert mgr.latest_step() == 1
    step, after = mgr.restore(template=tree)
    assert step == 1
    for a, b in zip(TTREE.leaves(after), TTREE.leaves(before)):
        assert torch.equal(a, b)
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_save_crash_before_latest_falls_back_to_scan(tmp_path):
    mgr = TCK.CheckpointManager(tmp_path, codec="z", device="cpu")
    tree = {"w": torch.ones(3)}
    mgr.save(1, tree)
    with TINJ.armed("ckpt.save.before_latest"):
        with pytest.raises(TINJ.InjectedFault):
            mgr.save(2, {"w": torch.zeros(3)})
    assert (tmp_path / "LATEST").read_text().strip() == "step_0000000001"
    assert mgr.latest_step() == 2
    assert torch.equal(mgr.restore(template=tree)[1]["w"], torch.zeros(3))


def test_async_save_snapshots_the_tree_before_it_returns(tmp_path):
    """An in-place change right after an async save() (an optimizer step)
    must not reach the checkpoint: the save thread is held back at its
    first fault site until the change has happened."""
    mgr = TCK.CheckpointManager(tmp_path, codec="raw", device="cpu")
    tree = {"w": torch.arange(6, dtype=torch.float32), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    want = [t.clone() for t in TTREE.leaves(tree)]
    with TINJ.armed("ckpt.save.before_write", action="delay", delay_s=0.3):
        mgr.save(1, tree, blocking=False)
        tree["w"].add_(100.0)
        tree["b"][0].mul_(3.0)
        mgr.wait()
    _, out = mgr.restore(template=tree)
    for a, b in zip(TTREE.leaves(out), want):
        assert torch.equal(a, b)


def test_async_save_failure_surfaces_in_wait(tmp_path):
    mgr = TCK.CheckpointManager(tmp_path, codec="z", device="cpu")
    with TINJ.armed("ckpt.save.before_commit"):
        mgr.save(1, {"w": torch.ones(4)}, blocking=False)
        with pytest.raises(TINJ.InjectedFault):
            mgr.wait()
    mgr.save(2, {"w": torch.ones(4)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 2


def test_wzrice_leaf_self_heals_and_z_leaf_raises(tmp_path):
    tree = TCKPT.tree_from_numpy(_host_tree(seed=7, small=True), "cpu")
    mgr = TCK.CheckpointManager(tmp_path / "rice", codec="wz-rice", device="cpu")
    mgr.save(1, tree)
    _, clean = mgr.restore(template=tree)
    leaf = tmp_path / "rice" / STEP / "stack.bin"
    data = leaf.read_bytes()
    leaf.write_bytes(TINJ.flip_byte(data, len(data) // 2))
    with pytest.warns(DegradedRestoreWarning, match="per-band"):
        _, healed = mgr.restore(template=tree)
    assert torch.equal(healed["stack"], clean["stack"])
    leaf.write_bytes(TINJ.flip_byte(data, 8))  # header damage: unhealable
    with pytest.raises(CheckpointIntegrityError, match="checksum"):
        mgr.restore(template=tree)
    zmgr = TCK.CheckpointManager(tmp_path / "z", codec="z", device="cpu")
    zmgr.save(1, tree)
    zleaf = tmp_path / "z" / STEP / "vec.bin"
    zleaf.write_bytes(TINJ.flip_byte(zleaf.read_bytes(), 3))
    with pytest.raises(IOError, match="checksum"):
        zmgr.restore(template=tree)


def test_unknown_enc_version_is_refused(tmp_path):
    mgr = TCK.CheckpointManager(tmp_path, codec="wz", device="cpu")
    mgr.save(1, {"w": torch.ones(16)})
    man_path = tmp_path / STEP / "manifest.json"
    man = json.loads(man_path.read_text())
    man["leaves"]["w"]["meta"]["enc_version"] = 99
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="enc_version 99"):
        mgr.restore()


def _loop_parts():
    def step_fn(state, batch):
        return {"x": state["x"] + batch["v"]}, {"loss": float(state["x"].sum())}

    def batch_fn(step):
        return {"v": torch.full((3,), float(step))}

    return step_fn, batch_fn


@pytest.mark.parametrize("async_save", [False, True])
def test_simulated_failure_and_resume_equal_an_uninterrupted_run(tmp_path, async_save):
    step_fn, batch_fn = _loop_parts()
    state0 = {"x": torch.zeros(3)}
    runner = TrainLoopRunner(
        ckpt=TCK.CheckpointManager(tmp_path, keep=3, codec="z", device="cpu"),
        save_every=5, async_save=async_save)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        runner.run(state0, step_fn, batch_fn, n_steps=20, fail_at=13)
    runner.ckpt.wait()
    runner2 = TrainLoopRunner(
        ckpt=TCK.CheckpointManager(tmp_path, keep=3, codec="z", device="cpu"),
        save_every=5, async_save=async_save)
    state, start = runner2.resume_or_init(state0)
    assert start == 10
    final, end = runner2.run(state, step_fn, batch_fn, n_steps=20, start_step=start)
    assert end == 20
    ref = torch.zeros(3)
    for s in range(20):
        ref = ref + s
    assert torch.equal(final["x"], ref)
    # the reference's loop resumes from the port's checkpoint too
    rstate, rstart = RRunner(ckpt=RCK.CheckpointManager(tmp_path, keep=3)).resume_or_init(
        {"x": jnp.zeros(3)})
    assert rstart == 20
    np.testing.assert_array_equal(np.asarray(rstate["x"]), ref.numpy())


def test_straggler_watchdog_and_device_move():
    wd = StragglerWatchdog(threshold=2.0, window=16)
    for s in range(10):
        assert not wd.observe(s, 1.0)
    assert wd.observe(10, 5.0)
    assert wd.flagged[0]["step"] == 10
    moved = reshard_to_mesh({"a": [torch.ones(2)]}, "cpu")
    assert moved["a"][0].device.type == "cpu"


@pytest.mark.sharded
def test_reshard_to_mesh_places_a_host_tree_on_two_ranks(tmp_path):
    """The elastic-restart placement: numpy leaves onto a 2-rank mesh from
    ``sharding.tree_shardings`` pairs, each rank holding its own rows."""
    from torch_dist_ranks import run_world

    rng = np.random.default_rng(3)
    w = rng.normal(size=(8, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", w=w, b=b)
    outs = run_world("reshard", 2, tmp_path)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["w_local"], w[4 * r:4 * r + 4])  # batch over data
        np.testing.assert_array_equal(out["b_local"], b)  # embed replicated (no fsdp)
        np.testing.assert_array_equal(out["w_full"], w)
        assert str(out["w_placements"]) == "(Shard(dim=0),)"
        assert str(out["b_placements"]) == "(Replicate(),)"


def test_jax_state_restores_into_the_port(tmp_path):
    """A jax-array tree saved by the reference restores in the port with
    the template's structure, bfloat16 kept."""
    k = jax.random.PRNGKey(0)
    tree = {"a": jax.random.normal(k, (17, 9)),
            "p": {"e": jax.random.normal(k, (8, 16)).astype(jnp.bfloat16),
                  "i": jnp.arange(12, dtype=jnp.int32)}}
    RCK.CheckpointManager(tmp_path, codec="z").save(7, tree)
    step, out = TCK.CheckpointManager(tmp_path, device="cpu").restore(template=tree)
    assert step == 7 and out["p"]["e"].dtype == torch.bfloat16
    for a, b in zip(TTREE.leaves(TCKPT.tree_to_numpy(out)), jax.tree_util.tree_leaves(tree)):
        b = np.asarray(b)
        np.testing.assert_array_equal(a, b.view(np.uint16) if b.dtype.name == "bfloat16" else b)
