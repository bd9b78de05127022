"""The port's LM model code (``repro_torch.models``) against the reference
``repro.models`` on the CPU.

The same seeded inputs go through both packages; both get the same
parameters (the reference's, through ``layers.params_from_numpy``).  Each
module's functions first, then every reduced architecture end to end:
the parameter tree (leaf names, shapes, dtypes, logical axes), the
counts, ``forward`` logits and aux loss, ``prefill`` logits and caches
and three ``decode_step``s.

Tolerance (``_close``): a float32 value within ``2e-4 * |want| + 2e-4 *
max(1, max |want|)`` of the reference's, the second term scaled by the
largest magnitude in the tensor compared (the two packages round matmul
sums and transcendental functions differently at the last bit, and an
entry near zero carries the rounding of the large entries it was summed
from).  Looser bounds are stated where they are used, with the reason.
The reference's functions run under ``jax.jit`` (one compile a call
instead of one an operation).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced
from repro.configs.base import MoEConfig as RMoE
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import rglru as RG
from repro.models import rwkv6 as RW
from repro.models import transformer as RT
from repro_torch import tree as TT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as W
from repro_torch.models import transformer as T

TOL = dict(rtol=2e-4, atol=2e-4)
# The hybrid family (recurrentgemma): the RG-LRU's sqrt(1 - a^2) cancels
# where a is near 1, so a one-ulp difference in exp(log a) moves the
# recurrence by up to ~1e-4 relative, and the reduced model's hidden
# states reach ~2e3 at random init: its logits agree within 3e-2.
HYBRID_TOL = dict(rtol=3e-2, atol=3e-2)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, **tol):
    tol = tol or TOL
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"], atol=tol["atol"] * scale)


def _ref(fn, *args, **static):
    """``fn(*args, **static)`` of the reference, jitted (``static`` bound)."""
    return jax.jit(partial(fn, **static))(*args)


def _pair(rng, *shape, scale=1.0):
    """The same float32 values as a jax array and a torch tensor."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _params(defs_r, seed=0, dtype=np.float32):
    """Host parameters for the reference's ``defs_r``, drawn with numpy by
    the reference's init rule (ones, zeros, normal with std 1 for
    embeddings and ``scale / sqrt(dim 0)`` otherwise), as the reference's
    arrays and the port's tensors (through ``params_from_numpy``)."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return (np.zeros if d.init == "zeros" else np.ones)(d.shape, np.float32).astype(dtype)
        std = 1.0 if d.init == "embed" else d.scale / np.sqrt(max(d.shape[0], 1))
        return (rng.standard_normal(d.shape) * std).astype(np.float32).astype(dtype)

    host = jax.tree_util.tree_map(draw, defs_r, is_leaf=lambda x: isinstance(x, RL.ParamDef))
    return jax.tree_util.tree_map(jnp.asarray, host), L.params_from_numpy(host, "cpu")


def _axes_leaf(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    rng = np.random.default_rng(1)
    xr, xt = _pair(rng, 2, 5, 48, scale=3.0)
    sr, st = _pair(rng, 48)
    br, bt = _pair(rng, 48)
    pr, pt = {"scale": sr, "bias": br}, {"scale": st, "bias": bt}
    _close(L.apply_norm(pt, xt + 2.0, kind), RL.apply_norm(pr, xr + 2.0, kind))


@pytest.mark.parametrize("pct", [1.0, 0.25, 0.0])
def test_rope(pct):
    rng = np.random.default_rng(2)
    xr, xt = _pair(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    got = L.apply_rope(xt, torch.from_numpy(pos), pct, 10000.0)
    want = RL.apply_rope(xr, jnp.asarray(pos), pct, 10000.0)
    _close(got, want)
    _close(L.rope_frequencies(16, pct, 500000.0), RL.rope_frequencies(16, pct, 500000.0))


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_mlp(act):
    rp, pt = _params(RL.mlp_defs(32, 64, act), seed=3)
    xr, xt = _pair(np.random.default_rng(3), 2, 5, 32)
    _close(L.apply_mlp(pt, xt, act), _ref(RL.apply_mlp, rp, xr, act=act))


def test_embed_head_and_tree_helpers():
    defs_r = {"embed": RL.embed_defs(40, 8), "head": RL.head_defs(8, 40),
              "layers": RL.stack_layer_defs({"n": RL.norm_defs(8, "layernorm")}, 3)}
    defs_t = {"embed": L.embed_defs(40, 8), "head": L.head_defs(8, 40),
              "layers": L.stack_layer_defs({"n": L.norm_defs(8, "layernorm")}, 3)}
    assert TT.leaves(L.logical_axes(defs_t), is_leaf=_axes_leaf) == jax.tree_util.tree_leaves(
        RL.logical_axes(defs_r), is_leaf=_axes_leaf)
    meta = L.abstract_params(defs_t, torch.bfloat16)
    ab = RL.abstract_params(defs_r, jnp.bfloat16)
    assert [(n, tuple(t.shape), t.device.type, t.dtype) for n, t in TT.leaf_paths(meta)] == [
        (n, a.shape, "meta", torch.bfloat16) for n, a in TT.leaf_paths(ab)]
    rp, pt = _params(defs_r, seed=4)
    toks = np.random.default_rng(4).integers(0, 40, (2, 6)).astype(np.int32)
    er = RL.apply_embed(rp["embed"], jnp.asarray(toks), jnp.float32)
    et = L.apply_embed(pt["embed"], torch.from_numpy(toks), torch.float32)
    np.testing.assert_array_equal(_np(et), _np(er))
    _close(L.apply_head(pt["head"], et), RL.apply_head(rp["head"], er))


def test_init_params_draws_from_the_generator():
    defs = T.model_defs(t_reduced(t_get_config("stablelm-1.6b")))
    a = L.init_params(defs, 7, device="cpu")
    b = L.init_params(defs, torch.Generator().manual_seed(7), device="cpu")
    c = L.init_params(defs, 8, device="cpu")
    for (na, ta), (_, tb), (_, tc) in zip(TT.leaf_paths(a), TT.leaf_paths(b), TT.leaf_paths(c)):
        assert torch.equal(ta, tb), na
        if na.endswith(("scale", "bias")):
            assert torch.equal(ta, tc), na
        else:
            assert not torch.equal(ta, tc), na
    emb = a["embed"]["embedding"]
    assert abs(emb.std().item() - 1.0) < 0.05  # "embed": std 1
    # the reference's fan-in is a leaf's dim 0: the layer count for a
    # stacked (4, 64, 4, 16) leaf
    wq = a["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - 4 ** -0.5) < 0.01
    bf = L.init_params(defs, 7, torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in TT.leaves(bf))


def test_params_from_numpy_keeps_bfloat16_bits():
    rng = np.random.default_rng(5)
    host = {"a": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    got = L.params_from_numpy(host, "cpu")
    assert got["a"].dtype == torch.bfloat16 and got["b"]["c"].dtype == torch.float32
    np.testing.assert_array_equal(got["a"].view(torch.int16).numpy(), host["a"].view(np.int16))
    np.testing.assert_array_equal(got["b"]["c"].numpy(), host["b"]["c"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,kv,window,chunk", [
    (4, 4, None, 8), (4, 4, 5, 8), (8, 2, None, 16), (8, 2, 12, 8), (4, 1, 3, 32)])
def test_chunked_causal_attention(heads, kv, window, chunk):
    rng = np.random.default_rng(6)
    qr, qt = _pair(rng, 2, 32, heads, 16)
    kr, kt = _pair(rng, 2, 32, kv, 16)
    vr, vt = _pair(rng, 2, 32, kv, 16)
    got = A.chunked_causal_attention(qt, kt, vt, chunk, window=window)
    want = _ref(RA.chunked_causal_attention, qr, kr, vr, chunk=chunk, window=window)
    _close(got, want)


def test_chunked_attention_bf16_probs(monkeypatch):
    """``REPRO_OPT_ATTN_BF16_PROBS`` keeps its reference meaning: the PV
    product takes bfloat16 probabilities (both packages read it at call
    time; bound: bfloat16's 2^-8 on probabilities in [0, 1])."""
    monkeypatch.setenv("REPRO_OPT_ATTN_BF16_PROBS", "1")
    rng = np.random.default_rng(7)
    qr, qt = _pair(rng, 1, 16, 4, 16)
    kr, kt = _pair(rng, 1, 16, 2, 16)
    vr, vt = _pair(rng, 1, 16, 2, 16)
    want = _ref(RA.chunked_causal_attention, qr, kr, vr, chunk=8)
    got = A.chunked_causal_attention(qt, kt, vt, 8)
    _close(got, want, rtol=1e-2, atol=1e-2)
    monkeypatch.delenv("REPRO_OPT_ATTN_BF16_PROBS")
    plain = A.chunked_causal_attention(qt, kt, vt, 8)
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("cache_len", [0, 5, 11, 15, 19])
def test_attention_decode(ring, cache_len):
    """Plain and ring caches of capacity 12; lengths past it write the last
    entry (plain: the reference's clamped dynamic_update_slice) or wrap."""
    rng = np.random.default_rng(8 + cache_len)
    rp, pt = _params(RA.attention_defs(32, 4, 2, 8), seed=cache_len)
    xr, xt = _pair(rng, 3, 1, 32)
    kr, kt = _pair(rng, 3, 12, 2, 8)
    vr, vt = _pair(rng, 3, 12, 2, 8)
    kw = dict(rotary_pct=0.5, rope_theta=10000.0, window=None if ring else 6, ring=ring)
    want = _ref(RA.apply_attention_decode, rp, xr, kr, vr, jnp.int32(cache_len), **kw)
    got = A.apply_attention_decode(pt, xt, kt, vt, torch.tensor(cache_len, dtype=torch.int32), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.equal(kt, torch.from_numpy(np.array(kr)))  # the caches given stay


def test_decode_attention_per_row_lengths():
    rng = np.random.default_rng(9)
    qr, qt = _pair(rng, 3, 1, 4, 8)
    kr, kt = _pair(rng, 3, 10, 2, 8)
    vr, vt = _pair(rng, 3, 10, 2, 8)
    lens = np.array([1, 6, 10], np.int32)
    for window in (None, 3):
        _close(A.decode_attention(qt, kt, vt, torch.from_numpy(lens), window=window),
               _ref(RA.decode_attention, qr, kr, vr, jnp.asarray(lens), window=window))


def test_apply_attention():
    rng = np.random.default_rng(10)
    rp, pt = _params(RA.attention_defs(32, 4, 2, 8), seed=10)
    xr, xt = _pair(rng, 2, 16, 32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    kw = dict(rotary_pct=0.25, rope_theta=10000.0, chunk=8, window=5)
    _close(A.apply_attention(pt, xt, torch.from_numpy(pos.copy()), **kw),
           _ref(RA.apply_attention, rp, xr, jnp.asarray(pos), **kw))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_pair(**kw):
    return RMoE(**kw), MoEConfig(**kw)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dispatch", ["int32", "int16"])
def test_moe(shared, dispatch):
    rm, tm = _moe_pair(n_experts=4, experts_per_token=2, d_ff_expert=24, capacity_factor=2.0,
                       shared_expert=shared, dispatch_dtype=dispatch)
    rp, pt = _params(RM.moe_defs(32, rm), seed=11)
    xr, xt = _pair(np.random.default_rng(11), 2, 16, 32)
    (out_r, aux_r), (out_t, aux_t) = _ref(RM.apply_moe, rp, xr, moe=rm), M.apply_moe(pt, xt, tm)
    _close(out_t, out_r)
    _close(aux_t, aux_r)


def test_moe_drops_tokens_past_capacity():
    """Capacity 8 for 64 tokens x top-2 over 4 experts: most assignments
    go to the drop bin; the kept ones and the combine still agree."""
    rm, tm = _moe_pair(n_experts=4, experts_per_token=2, d_ff_expert=16, capacity_factor=0.25)
    assert M.capacity(64, tm) == RM.capacity(64, rm) == 8
    rp, pt = _params(RM.moe_defs(16, rm), seed=12)
    xr, xt = _pair(np.random.default_rng(12), 1, 64, 16)
    out_r, _ = _ref(RM.apply_moe, rp, xr, moe=rm)
    out_t, _ = M.apply_moe(pt, xt, tm)
    _close(out_t, out_r)
    dropped = (out_t.abs().sum(-1) == 0).sum().item()
    assert dropped > 0  # tokens whose both experts were full


def test_top_k_keeps_the_lower_index_on_ties():
    probs = np.array([[0.2, 0.3, 0.3, 0.1, 0.1], [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    for k in (1, 2, 3, 4):
        vr, ir = jax.lax.top_k(jnp.asarray(probs), k)
        vt, it = M.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 3, 7, 32, 33])
def test_lru_scan(s):
    """The port's scan follows ``jax.lax.associative_scan``'s recursion;
    both are held to a float64 sequential recurrence too."""
    rng = np.random.default_rng(13)
    la = -np.abs(rng.standard_normal((2, s, 8))).astype(np.float32)
    u = rng.standard_normal((2, s, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    hr, lr = _ref(RG.lru_scan, jnp.asarray(la), jnp.asarray(u), jnp.asarray(h0))
    ht, lt = G.lru_scan(torch.from_numpy(la), torch.from_numpy(u), torch.from_numpy(h0))
    _close(ht, hr)
    _close(lt, lr)
    h, seq = h0.astype(np.float64), []
    for t in range(s):
        h = np.exp(la[:, t].astype(np.float64)) * h + u[:, t]
        seq.append(h)
    np.testing.assert_allclose(ht.numpy(), np.stack(seq, 1), **TOL)


def test_lru_scan_long_decay_stays_finite():
    """Strong decay over a long sequence: no overflow (a cumulative
    product exp(-cumsum(log a)) would reach exp(4000))."""
    la = torch.full((1, 1000, 4), -4.0)
    u = torch.ones((1, 1000, 4))
    h, last = G.lru_scan(la, u, torch.zeros(1, 4))
    assert torch.isfinite(h).all()
    want = 1.0 / (1.0 - np.exp(-4.0))
    np.testing.assert_allclose(last.numpy(), want, rtol=1e-6)


def test_rglru_block_and_decode():
    rp, pt = _params(RG.rglru_defs(32, 24, 4), seed=14)
    rng = np.random.default_rng(14)
    xr, xt = _pair(rng, 2, 9, 32, scale=0.5)
    _close(G.apply_rglru_block(pt, xt), _ref(RG.apply_rglru_block, rp, xr))
    x1r, x1t = _pair(rng, 2, 1, 32, scale=0.5)
    hr, ht = _pair(rng, 2, 24)
    cr, ct = _pair(rng, 2, 3, 24)
    want = _ref(RG.apply_rglru_block_decode, rp, x1r, hr, cr)
    got = G.apply_rglru_block_decode(pt, x1t, ht, ct)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def _rwkv_inputs(seed, s):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((2, s, 4, 8)).astype(np.float32) * 0.5 for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal((2, s, 4, 8))), W.LOG_W_MIN, -1e-4).astype(np.float32)
    u = rng.standard_normal((4, 8)).astype(np.float32)
    s0 = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    return (r, k, v, lw, u, s0)


def test_rwkv_chunked_matches_scan_and_reference():
    args = _rwkv_inputs(15, 32)
    ta = [torch.from_numpy(a) for a in args]
    ja = [jnp.asarray(a) for a in args]
    o_scan, s_scan = W.timemix_scan(*ta)
    o_ch, s_ch = W.timemix_chunked(*ta, chunk=W.CHUNK)
    _close(o_ch, o_scan)
    _close(s_ch, s_scan)
    o_r, s_r = _ref(RW.timemix_chunked, *ja, chunk=RW.CHUNK)
    _close(o_ch, o_r)
    _close(s_ch, s_r)
    o_rs, s_rs = _ref(RW.timemix_scan, *ja)
    _close(o_scan, o_rs)
    _close(s_scan, s_rs)
    assert (W.LOG_W_MIN, W.CHUNK) == (RW.LOG_W_MIN, RW.CHUNK)


def test_rwkv_timemix_decode_and_channelmix():
    rp, pt = _params(RW.timemix_defs(32, 4), seed=16)
    rng = np.random.default_rng(16)
    xr, xt = _pair(rng, 2, 16, 32)
    for chunked in (True, False):
        _close(W.apply_timemix(pt, xt, 4, chunked=chunked, chunk=8),
               _ref(RW.apply_timemix, rp, xr, n_heads=4, chunked=chunked, chunk=8))
    x1r, x1t = _pair(rng, 2, 1, 32)
    pr_, pt_ = _pair(rng, 2, 1, 32)
    sr, st = _pair(rng, 2, 4, 8, 8)
    want = _ref(RW.apply_timemix_decode, rp, x1r, sr, pr_, n_heads=4)
    got = W.apply_timemix_decode(pt, x1t, st, pt_, 4)
    for g, w in zip(got, want):
        _close(g, w)
    cr, ct = _params(RW.channelmix_defs(32, 48), seed=17)
    _close(W.apply_channelmix(ct, xt, W._shift(xt)), _ref(RW.apply_channelmix, cr, xr, RW._shift(xr)))


# ---------------------------------------------------------------------------
# Every reduced architecture end to end
# ---------------------------------------------------------------------------

B, S, DECODES = 2, 32, 3


def _inputs(cfg, rng, s):
    if cfg.input_mode == "tokens":
        a = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
        return {"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a)}
    a = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    return {"embeds": jnp.asarray(a)}, {"embeds": torch.from_numpy(a)}


def _run_arch(arch):
    rcfg = reduced(get_config(arch))
    cfg = t_reduced(t_get_config(arch))
    rp, pt = _params(RT.model_defs(rcfg), seed=0)
    rng = np.random.default_rng(ARCH_IDS.index(arch))
    (name,) = _inputs(cfg, rng, 1)[0]
    # one compile for forward and prefill (for ssm / hybrid the prefill
    # is the forward)
    fwd_pre = jax.jit(lambda p, x: (RT.forward(p, rcfg, **{name: x}),
                                    RT.prefill(p, rcfg, **{name: x})))
    dec = jax.jit(lambda p, c, x: RT.decode_step(p, rcfg, c, **{name: x}))
    xr, xt = _inputs(cfg, rng, S)
    ref_fwd, (lr, cr) = fwd_pre(rp, xr[name])
    out = {"rcfg": rcfg, "cfg": cfg, "rp": rp, "pt": pt,
           "forward": (ref_fwd, T.forward(pt, cfg, **xt))}
    lt, ct = T.prefill(pt, cfg, **xt)
    out["prefill"] = ((lr, cr), (lt, ct))
    steps = []
    for _ in range(DECODES):
        dr, dt = _inputs(cfg, rng, 1)
        (lr, cr), (lt, ct) = dec(rp, cr, dr[name]), T.decode_step(pt, cfg, ct, **dt)
        steps.append(((lr, cr), (lt, ct)))
    out["decode"] = steps
    return out


@pytest.fixture(scope="module")
def arch_runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _run_arch(arch)
        return cache[arch]

    return get


def _tol(cfg):
    return HYBRID_TOL if cfg.family == "hybrid" else TOL


def _close_caches(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if k == "len":
            assert int(got[k]) == int(want[k])
        else:
            _close(got[k], want[k], **tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_param_tree_and_counts(arch, arch_runs):
    run = arch_runs(arch)
    rcfg, cfg = run["rcfg"], run["cfg"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    want = [(n, a.shape, str(a.dtype)) for n, a in TT.leaf_paths(
        jax.tree_util.tree_map(np.asarray, run["rp"]))]
    got = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in TT.leaf_paths(L.init_params(T.model_defs(cfg), 0, device="cpu"))]
    assert got == want
    axes_t = TT.leaves(L.logical_axes(T.model_defs(cfg)), is_leaf=_axes_leaf)
    axes_r = jax.tree_util.tree_leaves(RL.logical_axes(RT.model_defs(rcfg)), is_leaf=_axes_leaf)
    assert axes_t == axes_r
    assert T.cache_axes(cfg) == RT.cache_axes(rcfg)
    for c, r in ((cfg, rcfg), (t_get_config(arch), get_config(arch))):
        assert c.param_count() == r.param_count()
        assert c.active_param_count() == r.active_param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_forward(arch, arch_runs):
    run = arch_runs(arch)
    (lr, ar), (lt, at) = run["forward"]
    assert tuple(lt.shape) == (B, S, run["cfg"].vocab_size)
    _close(lt, lr, **_tol(run["cfg"]))
    _close(at, ar)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_prefill(arch, arch_runs):
    run = arch_runs(arch)
    (lr, cr), (lt, ct) = run["prefill"]
    _close(lt, lr, **_tol(run["cfg"]))
    _close_caches(ct, cr, TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_decode_steps(arch, arch_runs):
    run = arch_runs(arch)
    for (lr, cr), (lt, ct) in run["decode"]:
        _close(lt, lr)
        _close_caches(ct, cr, TOL)


def test_arch_loss_fn():
    rcfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    cfg = t_reduced(t_get_config("phi3.5-moe-42b-a6.6b"))
    rp, pt = _params(RT.model_defs(rcfg), seed=18)
    rng = np.random.default_rng(18)
    toks, labels = (rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32) for _ in range(2))
    for ce_chunk in (0, 8):
        lr, mr = jax.jit(partial(RT.loss_fn, cfg=rcfg, ce_chunk=ce_chunk))(
            rp, batch={"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        lt, mt = T.loss_fn(pt, cfg, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)}, ce_chunk=ce_chunk)
        _close(lt, lr)
        _close(mt["ce"], mr["ce"])
        _close(mt["moe_aux"], mr["moe_aux"])


def test_bfloat16_reduced_model():
    """stablelm reduced in bfloat16 (parameters and compute), the
    reference's bf16 parameters moved bit for bit.  Bound: the logits'
    relative Frobenius distance at most 5e-2.  The packages round bf16
    results at different points (XLA keeps excess precision inside its
    fusions), so single logits differ by up to ~0.45 at a scale of ~4
    (measured over seeds 19-21: relative distance 2.1-2.4e-2).  Both sit
    about as far from the same model run in float32: the port at most
    1.5x the reference's distance."""
    arch = "stablelm-1.6b"
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    rcfg = dataclasses.replace(reduced(get_config(arch)), **bf)
    cfg = dataclasses.replace(t_reduced(t_get_config(arch)), **bf)
    rp, pt = _params(RT.model_defs(rcfg), seed=19, dtype=ml_dtypes.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in TT.leaves(pt))
    toks = np.random.default_rng(19).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tt = torch.from_numpy(toks)
    lr = _np(_ref(RT.forward, rp, cfg=rcfg, tokens=jnp.asarray(toks))[0])
    lt = T.forward(pt, cfg, tokens=tt)[0]
    assert lt.dtype == torch.bfloat16
    lt = _np(lt)

    def dist(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert dist(lt, lr) <= 5e-2
    f32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    l32 = _np(T.forward(TT.map_leaves(lambda t: t.float(), pt), f32, tokens=tt)[0])
    assert dist(lt, l32) <= 1.5 * dist(lr, l32)
    (plr, _), (plt, pct) = _ref(RT.prefill, rp, cfg=rcfg, tokens=jnp.asarray(toks)), T.prefill(
        pt, cfg, tokens=tt)
    assert dist(_np(plt), _np(plr)) <= 5e-2
    assert pct["k"].dtype == torch.bfloat16
