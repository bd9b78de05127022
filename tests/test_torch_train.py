"""The port's training (``repro_torch.train.optim``, ``train.train_step``,
the models' remat and ``launch.train``) against the reference's on the CPU.

The same seeded numpy trees and batches go through both packages; the
reference runs under ``jax.jit``.  Tolerances, each where it is used:

* AdamW pieces: ``lr_schedule`` within 2 float32 ulps plus one ulp of
  the cosine carried through (the reference's ``cos`` is glibc's
  ``cosf``; see the test); ``global_norm`` and the clip
  within rtol 1e-6 (the two sum the squares in other orders); one
  ``adamw_update`` within rtol 2e-6, atol 1e-8 on float32 leaves, and no
  bfloat16 element more than one bfloat16 ulp away.
* Gradients of ``loss_fn`` in float32: 2e-4 relative plus 2e-4 of the
  leaf's largest magnitude (the models' forward tolerance,
  ``tests/test_torch_models.py``), 3e-2 for the hybrid family.
* Whole train steps: the first AdamW steps are sign-like (``m_hat /
  sqrt(v_hat)`` is about ``g / |g|``), so a gradient near zero that
  rounds differently moves its element by up to ``2 lr``: parameters are
  held within ``3 lr`` everywhere and within 1e-4 of the leaf's scale at
  99.9% of the elements; the loss within 1e-4 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RCK
from repro.configs import get_config as r_get_config
from repro.configs import reduced as r_reduced
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.launch import train as RLT
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.train import optim as RO
from repro.train import train_step as RS
from repro_torch import tree as TT
from repro_torch.configs import get_config
from repro_torch.configs import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as LT
from repro_torch.models import layers as L
from repro_torch.train import optim as O
from repro_torch.train import train_step as S

FAMILIES = ("stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b", "recurrentgemma-2b",
            "musicgen-medium")
GRAD_TOL = 2e-4
HYBRID_GRAD_TOL = 3e-2
B, SEQ = 2, 32


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _host_params(cfg_r, seed, dtype=np.float32):
    """Host parameters by the reference's init rule, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            a = (np.zeros if d.init == "zeros" else np.ones)(d.shape, np.float32)
        else:
            std = 1.0 if d.init == "embed" else d.scale / np.sqrt(max(d.shape[0], 1))
            a = (rng.standard_normal(d.shape) * std).astype(np.float32)
        return a.astype(dtype)

    return jax.tree_util.tree_map(draw, RT.model_defs(cfg_r),
                                  is_leaf=lambda x: isinstance(x, RL.ParamDef))


def _host_state(cfg_r, seed):
    """A fresh train state as host arrays: the reference's, and the port's
    through ``state_from_numpy``."""
    host = _host_params(cfg_r, seed)
    opt = jax.tree_util.tree_map(np.asarray, RO.adamw_init(host))
    ref = {"params": jax.tree_util.tree_map(jnp.asarray, host),
           "opt": jax.tree_util.tree_map(jnp.asarray, opt)}
    return ref, LT.state_from_numpy({"params": host, "opt": opt}, "cpu")


def _pairs(ref_tree, port_tree):
    """(name, reference leaf, port leaf) in the reference's leaf order."""
    names = [n for n, _ in RCK._leaf_paths(ref_tree)]
    got = TT.leaf_paths(port_tree)
    assert [n for n, _ in got] == names
    return [(n, r, t) for n, (_, r), (_, t) in zip(names, RCK._leaf_paths(ref_tree), got)]


def _within_leaf_scale(got, want, tol, name=""):
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)


# ---------------------------------------------------------------------------
# AdamW, piece by piece
# ---------------------------------------------------------------------------

SHAPES = {"a": (64, 48), "b": (300,), "c": (7, 5, 3)}
SCHEDULES = [RO.AdamWConfig(), RO.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=12),
             RO.AdamWConfig(lr=6e-4, warmup_steps=0, total_steps=1, min_lr_ratio=0.0)]


def _port_cfg(cfg: RO.AdamWConfig) -> O.AdamWConfig:
    return O.AdamWConfig(**cfg._asdict())


def _tree(rng, dtype=np.float32, scale=1.0, positive=False):
    out = {}
    for k, shape in SHAPES.items():
        a = rng.standard_normal(shape).astype(np.float32) * scale
        out[k] = (np.abs(a) if positive else a).astype(dtype)
    return out


def _as_ref(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _as_port(tree):
    return {k: TT.to_tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_lr_schedule_within_two_ulps(i):
    """Within 2 float32 ulps, plus one ulp of the cosine carried through
    ``lr * warm * (1 - min_lr_ratio) * 0.5``: the reference's float32
    ``cos`` is glibc's ``cosf`` (not correctly rounded: one ulp off the
    port's rounded float64 cosine at ~1% of arguments), and ``1 + cos``
    cancels as the schedule ends, where that ulp is several of the
    result's (3 at step 7934 of the default schedule)."""
    cfg = SCHEDULES[i]
    steps = np.arange(cfg.total_steps + 6, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: RO.lr_schedule(cfg, s))(jnp.asarray(steps)))
    got = O.lr_schedule(_port_cfg(cfg), torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    s = steps.astype(np.float32)
    warm = np.minimum(s / max(cfg.warmup_steps, 1), 1.0)
    prog = np.clip((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos_ulp = np.spacing(np.abs(np.cos(np.pi * prog)).astype(np.float32))
    carried = cfg.lr * warm * (1.0 - cfg.min_lr_ratio) * 0.5 * cos_ulp
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)) + carried)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert np.mean(ulps == 0) > 0.99, np.bincount(ulps)
    for s in (0, cfg.total_steps):  # 0-dim steps, as the update passes them
        one = O.lr_schedule(_port_cfg(cfg), torch.tensor(s, dtype=torch.int32))
        assert one.shape == () and float(one) == got[s]


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_global_norm_and_clip(dtype, scale):
    g = _tree(np.random.default_rng(3), dtype, scale)
    want_g, want_n = jax.jit(lambda t: RO.clip_by_global_norm(t, 1.0))(_as_ref(g))
    got_g, got_n = O.clip_by_global_norm(_as_port(g), 1.0)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    np.testing.assert_allclose(float(O.global_norm(_as_port(g))),
                               float(jax.jit(RO.global_norm)(_as_ref(g))), rtol=1e-6)
    for k in SHAPES:
        assert got_g[k].dtype == TT.to_tensor(g[k]).dtype
        np.testing.assert_allclose(_np(got_g[k]), _np(want_g[k]), rtol=1e-6, atol=0)


def test_bfloat16_grads_are_scaled_by_a_bfloat16_scale():
    """``g * scale.astype(g.dtype)``: a scale that bfloat16 rounds (here
    1/3) gives other bfloat16 grads than scaling in float32 would, and the
    port's equal the reference's."""
    g = _tree(np.random.default_rng(4), ml_dtypes.bfloat16, 1.0)
    norm = float(O.global_norm(_as_port(g)))
    max_norm = norm / 3.0
    want, _ = jax.jit(lambda t: RO.clip_by_global_norm(t, max_norm))(_as_ref(g))
    got, _ = O.clip_by_global_norm(_as_port(g), max_norm)
    differs = 0
    for k in SHAPES:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
        in_f32 = (TT.to_tensor(g[k]).float() * (max_norm / norm)).to(torch.bfloat16)
        differs += int((in_f32 != got[k]).sum())
    assert differs > 0  # the case shows the cast


@pytest.fixture(scope="module")
def one_update():
    """One ``adamw_update`` at step 5 on float32 and bfloat16 trees with
    moments as a few steps would leave them."""
    rng = np.random.default_rng(6)
    cfg = RO.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=12)
    out = {}
    for name, dtype in (("f32", np.float32), ("bf16", ml_dtypes.bfloat16)):
        p = _tree(rng, dtype)
        g = _tree(rng, dtype, 0.2)
        m = _tree(rng, np.float32, 0.05)
        v = _tree(rng, np.float32, 0.01, positive=True)
        step = np.int32(5)
        want = jax.jit(lambda p, g, m, v, s: RO.adamw_update(
            g, RO.AdamWState(s, m, v), p, cfg))(_as_ref(p), _as_ref(g), _as_ref(m), _as_ref(v),
                                                jnp.asarray(step))
        got = O.adamw_update(_as_port(g), O.AdamWState(torch.tensor(5, dtype=torch.int32),
                                                       _as_port(m), _as_port(v)),
                             _as_port(p), _port_cfg(cfg))
        out[name] = (want, got)
    return out


def test_adamw_update_float32_leaves(one_update):
    (wp, wo, wm), (gp, go, gm) = one_update["f32"]
    for want, got in ((wp, gp), (wo.m, go.m), (wo.v, go.v)):
        for k in SHAPES:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=2e-6, atol=1e-8)


def test_adamw_update_bfloat16_leaves_within_one_ulp(one_update):
    (wp, wo, _), (gp, go, _) = one_update["bf16"]
    off = 0
    for k in SHAPES:
        assert gp[k].dtype == torch.bfloat16 and go.m[k].dtype == torch.float32
        want, got = _np(wp[k]), _np(gp[k])
        ulp = np.spacing(np.abs(want).astype(ml_dtypes.bfloat16)).astype(np.float32)
        assert np.all(np.abs(got - want) <= ulp), k
        off += int((got != want).sum())
        np.testing.assert_allclose(_np(go.m[k]), _np(wo.m[k]), rtol=2e-6, atol=1e-8)
        np.testing.assert_allclose(_np(go.v[k]), _np(wo.v[k]), rtol=2e-6, atol=1e-8)
    print(f"bfloat16 params one ulp from the reference's: {off} of "
          f"{sum(int(np.prod(s)) for s in SHAPES.values())}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_update_step_and_metrics(one_update, dtype):
    (_, wo, wm), (_, go, gm) = one_update[dtype]
    assert go.step.dtype == torch.int32 and go.step.shape == () and int(go.step) == int(wo.step)
    np.testing.assert_allclose(float(gm["lr"]), float(wm["lr"]), rtol=2e-6)
    np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]), rtol=1e-6)


def test_adamw_init_and_state_from_numpy_keep_bits():
    host = _tree(np.random.default_rng(8), ml_dtypes.bfloat16)
    opt = jax.tree_util.tree_map(np.asarray, RO.adamw_init(_as_ref(host)))
    state = LT.state_from_numpy({"params": host, "opt": opt._replace(step=np.int32(7))}, "cpu")
    for k in SHAPES:
        got = state["params"][k]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), host[k].view(np.int16))
        assert state["opt"].m[k].dtype == torch.float32 and not state["opt"].v[k].any()
    assert state["opt"].step.dtype == torch.int32 and int(state["opt"].step) == 7
    fresh = O.adamw_init(state["params"])
    assert isinstance(fresh, O.AdamWState) and int(fresh.step) == 0
    assert [n for n, _ in TT.leaf_paths({"opt": fresh})] == [
        n for n, _ in RCK._leaf_paths({"opt": RO.adamw_init(_as_ref(host))})]


# ---------------------------------------------------------------------------
# Gradients through the models, remat
# ---------------------------------------------------------------------------


def _batch(cfg, rng):
    labels = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    if cfg.input_mode == "tokens":
        x = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)}
    else:
        x = {"embeds": rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)}
    host = {**x, "labels": labels}
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


@pytest.fixture(scope="module")
def grads():
    cache = {}

    def get(arch, ce_chunk=0):
        if (arch, ce_chunk) not in cache:
            rcfg = r_reduced(r_get_config(arch))
            host = _host_params(rcfg, 1)
            rb, tb = _batch(rcfg, np.random.default_rng(FAMILIES.index(arch)))
            want = jax.jit(jax.value_and_grad(
                lambda p, b: RT.loss_fn(p, rcfg, b, ce_chunk=ce_chunk)[0]))(
                jax.tree_util.tree_map(jnp.asarray, host), rb)
            loss, _, got = S._grads_of(reduced(get_config(arch)), ce_chunk)(
                L.params_from_numpy(host, "cpu"), tb)
            cache[arch, ce_chunk] = (want, (loss, got), host, tb)
        return cache[arch, ce_chunk]

    return get


@pytest.mark.parametrize("arch,ce_chunk", [(a, 0) for a in FAMILIES] + [("stablelm-1.6b", 8)])
def test_loss_fn_grads_match_jax_grad(arch, ce_chunk, grads):
    (want_loss, want), (loss, got), _, _ = grads(arch, ce_chunk)
    tol = HYBRID_GRAD_TOL if reduced(get_config(arch)).family == "hybrid" else GRAD_TOL
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=tol)
    for name, w, g in _pairs(want, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        _within_leaf_scale(g, w, tol, name)


def test_ce_chunk_changes_nothing_but_rounding(grads):
    (_, (l0, g0), _, _), (_, (l8, g8), _, _) = grads("stablelm-1.6b"), grads("stablelm-1.6b", 8)
    np.testing.assert_allclose(float(l8), float(l0), rtol=1e-6)
    for (_, a), (_, b) in zip(TT.leaf_paths(g0), TT.leaf_paths(g8)):
        _within_leaf_scale(a, b, 1e-5)


def test_bfloat16_params_get_bfloat16_grads():
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b")), param_dtype="bfloat16",
                              compute_dtype="bfloat16", n_layers=1)
    params = LT.init_train_state(cfg, 0, "cpu")["params"]
    before = [t.clone() for t in TT.leaves(params)]
    _, tb = _batch(cfg, np.random.default_rng(0))
    _, _, g = S._grads_of(cfg, 0)(params, tb)
    for p, q, gg in zip(TT.leaves(params), before, TT.leaves(g)):
        assert gg.dtype == torch.bfloat16 and not gg.requires_grad
        assert not p.requires_grad and torch.equal(p, q)  # the caller's tensors untouched


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_grads_equal_no_remat(arch, policy, grads):
    _, (loss, want), host, tb = grads(arch)
    base = reduced(get_config(arch))
    assert base.remat  # the reference's configs remat by default
    params = L.params_from_numpy(host, "cpu")
    runs = {}
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        runs[remat] = S._grads_of(cfg, 0)(params, tb)
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b, c in zip(TT.leaves(runs[True][2]), TT.leaves(runs[False][2]), TT.leaves(want)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_remat_policies_save_and_recompute_what_they_say():
    """Counted on a 2-layer model: the tensors the autograd graph keeps
    outside the layer bodies (saved-tensor hooks) and the matmuls the
    backward pass runs (a dispatch mode).  Remat keeps only a layer's
    inputs; ``full`` then runs every projection again in the backward
    pass, ``dots`` keeps their outputs inside the checkpoint and runs
    none again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import transformer as TF

    class CountMatmuls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    base = dataclasses.replace(reduced(get_config("stablelm-1.6b")), n_layers=2)
    params = LT.init_train_state(base, 0, "cpu")["params"]
    _, tb = _batch(base, np.random.default_rng(1))
    saved, backward_mm = {}, {}
    for key, remat, policy in (("none", False, "full"), ("full", True, "full"),
                               ("dots", True, "dots")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        live = [p.detach().requires_grad_(True) for p in TT.leaves(params)]
        count = [0]

        def pack(t):
            count[0] += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = TF.loss_fn(TT.unflatten(params, live), cfg, tb)
        saved[key] = count[0]
        with CountMatmuls() as mode:
            loss.backward()
        backward_mm[key] = mode.n
    assert saved["full"] == saved["dots"] < saved["none"], saved
    assert backward_mm["none"] == backward_mm["dots"] < backward_mm["full"], backward_mm


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------

STEP_CFG = RO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)


def _step_batches(cfg, n, global_batch=4, seq=32):
    ref = RSyntheticLM(RDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=global_batch))
    port = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=global_batch))
    out = []
    for s in range(n):
        a, b = ref.batch(s), port.batch(s)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        out.append(({k: jnp.asarray(v) for k, v in a.items()},
                    {k: torch.from_numpy(v) for k, v in b.items()}))
    return out


def _params_close(got, want, lr, name):
    got, want = _np(got), _np(want)
    diff = np.abs(got - want)
    assert diff.max() <= 3 * lr, (name, float(diff.max()))
    scale = max(1.0, float(np.abs(want).max()))
    frac = float(np.mean(diff <= 1e-4 * scale))
    assert frac >= 0.999, (name, frac)


@pytest.fixture(scope="module")
def three_steps():
    rcfg = r_reduced(r_get_config("stablelm-1.6b"))
    cfg = reduced(get_config("stablelm-1.6b"))
    ref_state, state = _host_state(rcfg, 2)
    ref_step = jax.jit(RS.make_train_step(rcfg, STEP_CFG))
    step = S.make_train_step(cfg, _port_cfg(STEP_CFG))
    rp, ro, p, o = ref_state["params"], ref_state["opt"], state["params"], state["opt"]
    out = []
    for rb, tb in _step_batches(rcfg, 3):
        rp, ro, rm = ref_step(rp, ro, rb)
        p, o, m = step(p, o, tb)
        out.append(((rp, ro, rm), (p, o, m)))
    return out


@pytest.mark.parametrize("i", range(3))
def test_make_train_step_three_steps(three_steps, i):
    (rp, ro, rm), (p, o, m) = three_steps[i]
    assert sorted(m) == sorted(rm) == ["ce", "grad_norm", "loss", "lr", "moe_aux"]
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=2e-6)
    assert int(o.step) == int(ro.step) == i + 1
    for name, w, g in _pairs(rp, p):
        assert g.dtype == torch.float32 and not g.requires_grad
        _params_close(g, w, STEP_CFG.lr, name)


def test_make_train_step_microbatches():
    """``n_microbatches=2`` against the reference's, and against the
    port's one-batch step, within the reference's own bound for the two
    (``tests/test_distributed.py``: rtol 2e-3, atol 2e-5)."""
    rcfg = r_reduced(r_get_config("stablelm-1.6b"))
    cfg = reduced(get_config("stablelm-1.6b"))
    ref_state, state = _host_state(rcfg, 3)
    oc = RO.AdamWConfig(lr=1e-3)
    rng = np.random.default_rng(9)
    host = {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
            for k in ("tokens", "labels")}
    rp, _, rm = jax.jit(RS.make_train_step(rcfg, oc, n_microbatches=2))(
        ref_state["params"], ref_state["opt"], {k: jnp.asarray(v) for k, v in host.items()})
    tb = {k: torch.from_numpy(v) for k, v in host.items()}
    p2, _, m2 = S.make_train_step(cfg, _port_cfg(oc), n_microbatches=2)(
        state["params"], state["opt"], tb)
    p1, _, _ = S.make_train_step(cfg, _port_cfg(oc))(state["params"], state["opt"], tb)
    assert sorted(m2) == sorted(rm) == ["grad_norm", "loss", "lr"]
    np.testing.assert_allclose(float(m2["loss"]), float(rm["loss"]), rtol=1e-4)
    for name, w, g in _pairs(rp, p2):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-3, atol=2e-5, err_msg=name)
    for (name, a), (_, b) in zip(TT.leaf_paths(p2), TT.leaf_paths(p1)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-3, atol=2e-5, err_msg=name)


def test_microbatches_must_divide_the_batch():
    with pytest.raises(ValueError, match="microbatches"):
        S._split_microbatches({"x": torch.zeros(5, 2)}, 2)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256,
            vocab_size=512)  # examples/torch_train_lm.py's "tiny" preset


def test_train_driver_reduces_loss_on_the_tiny_preset():
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), param_dtype="float32",
                              compute_dtype="float32", attn_chunk=64, **TINY)
    out = LT.train(cfg, steps=30, global_batch=4, seq_len=64, device="cpu", log_every=1000,
                   opt_cfg=O.AdamWConfig(lr=2e-3, warmup_steps=3, total_steps=30))
    assert len(out["losses"]) == 30 and out["steps"] == 30
    assert out["final_loss"] < out["first_loss"], (out["first_loss"], out["final_loss"])


def test_train_resume_is_exact(tmp_path):
    """Crash at step 6, resume from the checkpoint, and the final state is
    ``torch.equal`` to an uninterrupted run's (the port's copy of
    ``tests/test_system.py::test_training_resume_is_exact``)."""
    cfg = reduced(get_config("granite-3-8b"))
    kw = dict(steps=12, global_batch=2, seq_len=32, log_every=1000, seed=7, device="cpu",
              opt_cfg=O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12))
    ref = LT.train(cfg, **kw)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        LT.train(cfg, ckpt_dir=tmp_path / "ck", fail_at=6, **kw)
    resumed = LT.train(cfg, ckpt_dir=tmp_path / "ck", **kw)
    # resumed from step 6, or from step 3 where the crash came before the
    # asynchronous save of step 6 was on disk; the replay is exact either way
    n = len(resumed["losses"])
    assert resumed["steps"] == 12 and n in (6, 9)
    assert resumed["losses"] == ref["losses"][12 - n:]
    want, got = TT.leaf_paths(ref["state"]), TT.leaf_paths(resumed["state"])
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(want, got):
        assert torch.equal(a, b), name


def test_train_driver_embeds_archs():
    """The ``embeds`` front-end stub: the reference's projection rows."""
    cfg = reduced(get_config("musicgen-medium"))
    assert cfg.input_mode == "embeds"
    proj = LT.embeds_stub(cfg)
    want = np.random.default_rng(7).standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32) * 0.02
    np.testing.assert_array_equal(proj, want)
    batch = {"tokens": np.array([[1, 5]], np.int32), "labels": np.array([[5, 2]], np.int32)}
    dev = LT.batch_to_device(cfg, batch, "cpu")
    assert sorted(dev) == ["embeds", "labels"]
    np.testing.assert_array_equal(dev["embeds"].numpy(), want[[[1, 5]]])
    out = LT.train(cfg, steps=2, global_batch=2, seq_len=16, device="cpu", log_every=1000)
    assert np.isfinite(out["losses"]).all()


def test_main_trains_on_the_cpu(capsys):
    assert LT.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "3", "--batch", "2",
                    "--seq", "16", "--device", "cpu"]) == 0
    assert "done: 3 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_state_leaf_names_equal_the_reference(arch):
    rcfg = r_reduced(r_get_config(arch))
    want = RCK._leaf_paths(jax.eval_shape(lambda: RLT.init_train_state(rcfg, 0)))
    got = TT.leaf_paths(LT.init_train_state(reduced(get_config(arch)), 0, "cpu"))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, s) in zip(got, want):
        assert tuple(t.shape) == tuple(s.shape), name
        assert str(t.dtype).split(".")[-1] == str(s.dtype), name


def test_gradsync_experiment_rows_equal_the_reference():
    """``benchmarks/torch_grad_compression.py`` on the CPU gives the
    reference experiment's rows, name, value and note."""
    from benchmarks import grad_compression as RB
    from benchmarks import torch_grad_compression as TB

    assert TB.run(device="cpu") == RB.run()


@pytest.mark.parametrize("name", ["gradsync", "ckpt"])
def test_experiments_refuse_the_card_without_one(name):
    from benchmarks import torch_run as TRUN

    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TRUN._load(name).run()
    assert name in TRUN.ALL


# ---------------------------------------------------------------------------
# The rounding rules of the reference's compiled AdamW (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32 (float64: exact product)."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


@pytest.fixture(scope="module")
def xla_pieces():
    """The pieces of one reference update (step 5) and of the default
    schedule, each the output of the reference's jitted program."""
    cfg = RO.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=12)
    rng = np.random.default_rng(0)
    n = 200_000
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 0.2).astype(np.float32)
    m = (rng.standard_normal(n) * 0.05).astype(np.float32)
    v = np.abs(rng.standard_normal(n) * 0.01).astype(np.float32)

    def update(p, g, m, v, step):
        b1c = 1.0 - cfg.b1 ** step.astype(jnp.float32)
        b2c = 1.0 - cfg.b2 ** step.astype(jnp.float32)
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * jnp.square(g)
        q = (m_new / b1c) / (jnp.sqrt(v_new / b2c) + cfg.eps)
        return m_new, v_new, q, q + cfg.weight_decay * p

    sched = RO.AdamWConfig()

    def schedule(step):
        s = step.astype(jnp.float32)
        warm = jnp.minimum(s / jnp.maximum(sched.warmup_steps, 1), 1.0)
        prog = jnp.clip((s - sched.warmup_steps) / jnp.maximum(
            sched.total_steps - sched.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + jnp.cos(jnp.pi * prog))
        return warm, prog, cos, sched.min_lr_ratio + (1.0 - sched.min_lr_ratio) * cos

    out = [np.asarray(x) for x in jax.jit(update)(p, g, m, v, jnp.int32(5))]
    steps = np.arange(sched.total_steps + 6, dtype=np.int32)
    return (p, g, m, v), out, steps, [np.asarray(x) for x in jax.jit(schedule)(steps)]


def test_xla_divides_by_a_constant_through_its_reciprocal(xla_pieces):
    _, _, steps, (warm, prog, _, _) = xla_pieces
    cfg = RO.AdamWConfig()
    s = steps.astype(np.float32)
    recip = [np.float32(1) / np.float32(d) for d in (cfg.warmup_steps,
                                                     cfg.total_steps - cfg.warmup_steps)]
    assert np.array_equal(np.minimum(s * recip[0], np.float32(1)), warm)
    assert np.array_equal(np.clip((s - np.float32(cfg.warmup_steps)) * recip[1], 0, 1), prog)
    divided = np.clip((s - np.float32(cfg.warmup_steps)) / np.float32(
        cfg.total_steps - cfg.warmup_steps), 0, 1)
    print(f"true division differs at {int((divided != prog).sum())} of {len(s)} steps")
    assert (divided != prog).any()


def test_xla_fuses_the_schedule_and_the_moments_into_multiply_adds(xla_pieces):
    (p, g, m, v), (m_new, v_new, q, delta), _, (_, _, cos, scale) = xla_pieces
    f32 = np.float32
    rules = {
        "scale": (_fma(f32(0.9), cos, f32(0.1)), f32(0.1) + f32(0.9) * cos, scale),
        "m": (_fma(f32(0.9), m, f32(0.1) * g), f32(0.9) * m + f32(0.1) * g, m_new),
        "v": (_fma(f32(0.95), v, f32(0.05) * (g * g)), f32(0.95) * v + f32(0.05) * (g * g),
              v_new),
        "delta": (_fma(f32(0.1), p, q), q + f32(0.1) * p, delta),
    }
    for name, (fused, unfused, want) in rules.items():
        assert np.array_equal(fused, want), name
        print(f"{name}: unfused differs at {int((unfused != want).sum())} of {want.size}")
        assert (unfused != want).any(), name


def test_xla_float32_cos_is_within_an_ulp_not_correctly_rounded():
    """The reference's float32 ``cos`` (glibc's ``cosf``) is within an ulp
    of the cosine but not correctly rounded: why the schedule's test
    carries a cosine ulp.  Its ``sqrt`` is correctly rounded; torch's
    float32 ``cos`` and ``sqrt`` on the CPU need not be (printed: the
    counts depend on the CPU's vector unit)."""
    x = (np.float32(np.pi) * np.linspace(0, 1, 200_001).astype(np.float32)).astype(np.float32)
    cos = np.asarray(jax.jit(jnp.cos)(x))
    exact = np.cos(x.astype(np.float64)).astype(np.float32)
    assert np.all(np.abs(cos - exact) <= np.spacing(np.abs(exact)))
    off_cos = int((cos != exact).sum())
    assert 0 < off_cos < 0.02 * x.size
    v = np.abs(np.random.default_rng(1).standard_normal(200_000) * 0.01).astype(np.float32)
    assert np.array_equal(np.asarray(jax.jit(jnp.sqrt)(v)), np.sqrt(v))
    off_torch_cos = int((torch.cos(torch.from_numpy(x)).numpy() != exact).sum())
    off_torch_sqrt = int((torch.sqrt(torch.from_numpy(v)).numpy() != np.sqrt(v)).sum())
    print(f"of 200,000: XLA cos off the rounded cosine at {off_cos}; torch's float32 cos at "
          f"{off_torch_cos}, its float32 sqrt off the rounded root at {off_torch_sqrt}")


def test_xla_keeps_the_clipped_bfloat16_grad_in_float32():
    """Inside the reference's update the clipped bfloat16 grad (times a
    bfloat16 scale) is not rounded to bfloat16 before the moments take
    it: ``m`` equals the float32 product's, not the rounded one's."""
    rng = np.random.default_rng(6)
    p = rng.standard_normal((64, 48)).astype(ml_dtypes.bfloat16)
    g = (rng.standard_normal((64, 48)) * 0.2).astype(ml_dtypes.bfloat16)
    m = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    v = np.abs(rng.standard_normal((64, 48)) * 0.01).astype(np.float32)
    cfg = RO.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=12)
    _, st, _ = jax.jit(lambda p, g, m, v: RO.adamw_update(
        {"a": g}, RO.AdamWState(jnp.int32(5), {"a": m}, {"a": v}), {"a": p}, cfg))(p, g, m, v)
    g32 = g.astype(np.float32)
    gn = np.sqrt(np.sum(g32 * g32, dtype=np.float32))
    scale = np.float32(min(1.0, 1.0 / gn)).astype(ml_dtypes.bfloat16).astype(np.float32)
    kept = _fma(np.float32(0.9), m, np.float32(0.1) * (g32 * scale))
    rounded = _fma(np.float32(0.9), m, np.float32(0.1) * (g32 * scale).astype(
        ml_dtypes.bfloat16).astype(np.float32))
    want = np.asarray(st.m["a"])
    assert np.array_equal(kept, want)
    print(f"rounded to bfloat16 first: m differs at {int((rounded != want).sum())} of {m.size}")
    assert (rounded != want).any()
    got = O.adamw_update({"a": TT.to_tensor(g)}, O.AdamWState(
        torch.tensor(5, dtype=torch.int32), {"a": torch.from_numpy(m)}, {"a": torch.from_numpy(v)}),
        {"a": TT.to_tensor(p)}, _port_cfg(cfg))[1].m["a"].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-8)
