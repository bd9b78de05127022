"""The port's configs, LM serve engine and data pipeline
(``repro_torch.configs``, ``serve.serve_step``, ``data.pipeline``)
against the reference on the CPU.

Configs: every field of every architecture, its ``reduced()`` and the
shape suite equal.  ``ServeEngine``: greedy tokens equal to the
reference's for a dense, MoE, ssm and hybrid reduced config, from the
same host parameters (made with numpy, moved with
``layers.params_from_numpy``), and two reference behaviours pinned: the
shared ``len`` running past the dense caches' capacity (the write lands
in the last entry) and ``merge`` picking the hybrid caches' batch axis
by size.  Temperature decoding draws from a ``torch.Generator``, so it is
held deterministic per seed, not equal to ``jax.random``'s stream.  Data:
batches byte-equal, band splits equal, the prefetcher's order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data import pipeline as RD
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve import serve_step as RS
from repro_torch import configs as TC
from repro_torch import serve as TSERVE
from repro_torch.data import pipeline as TD
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import serve_step as TS

# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_config_fields_equal(arch):
    assert TC.ARCH_IDS == RC.ARCH_IDS
    full, rfull = TC.get_config(arch), RC.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(rfull)
    assert dataclasses.asdict(TC.reduced(full)) == dataclasses.asdict(RC.reduced(rfull))
    for c, r in ((full, rfull), (TC.reduced(full), RC.reduced(rfull))):
        assert (c.resolved_head_dim, c.attention_free, c.sub_quadratic) == (
            r.resolved_head_dim, r.attention_free, r.sub_quadratic)
        assert (c.param_count(), c.active_param_count()) == (
            r.param_count(), r.active_param_count())
        for cell, rcell in zip(TC.SHAPE_SUITE, RC.SHAPE_SUITE):
            assert TC.cell_applicable(c, cell) == RC.cell_applicable(r, rcell)


def test_shape_suite_and_registry_errors():
    assert [dataclasses.asdict(c) for c in TC.SHAPE_SUITE] == [
        dataclasses.asdict(c) for c in RC.SHAPE_SUITE]
    for c in RC.SHAPE_SUITE:
        assert dataclasses.asdict(TC.shape_cell(c.name)) == dataclasses.asdict(c)
    with pytest.raises(KeyError):
        TC.shape_cell("nope")
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("nope")


# ---------------------------------------------------------------------------
# the LM serve engine
# ---------------------------------------------------------------------------


def _host_params(cfg_r, seed):
    """Host parameters by the reference's init rule, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return (np.zeros if d.init == "zeros" else np.ones)(d.shape, np.float32)
        std = 1.0 if d.init == "embed" else d.scale / np.sqrt(max(d.shape[0], 1))
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(draw, RT.model_defs(cfg_r),
                                  is_leaf=lambda x: isinstance(x, RL.ParamDef))


def _engines(arch, slots, prefill_len, seed=0, **kw):
    """The reference's engine and the port's, on the same parameters."""
    rcfg = RC.reduced(RC.get_config(arch))
    host = _host_params(rcfg, seed)
    ref = RS.ServeEngine(rcfg, jax.tree_util.tree_map(jnp.asarray, host), slots, prefill_len,
                         **kw)
    port = TS.ServeEngine(TC.reduced(TC.get_config(arch)), L.params_from_numpy(host, "cpu"),
                          slots, prefill_len, device="cpu", **kw)
    return ref, port


def _requests(cls, vocab, seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, rng.integers(1, 8)).astype(np.int32),
                max_new=int(rng.integers(2, 7))) for i in range(n)]


@pytest.mark.parametrize("arch,slots", [("granite-3-8b", 3), ("phi3.5-moe-42b-a6.6b", 3),
                                        ("rwkv6-7b", 3), ("recurrentgemma-2b", 2)])
def test_greedy_tokens_equal_reference(arch, slots):
    """The hybrid family serves with 2 slots only: see the merge test."""
    ref, port = _engines(arch, slots=slots, prefill_len=8)
    vocab = port.cfg.vocab_size
    done_r = ref.run(_requests(RS.Request, vocab))
    done_t = port.run(_requests(TS.Request, vocab))
    assert [(r.uid, r.out_tokens, r.done) for r in done_t] == [
        (r.uid, r.out_tokens, r.done) for r in done_r]
    assert all(0 <= t < vocab for r in done_t for t in r.out_tokens)


def test_len_runs_past_the_dense_capacity_into_the_last_entry():
    """2 slots, ``prefill_len`` 8 (capacity 16), a request of 14 new tokens
    after two short ones: its admission resets the shared ``len`` to 8 and
    its 13 decode steps take it to 21; the writes past 16
    land in entry 15, as in the reference (its dynamic_update_slice
    clamps the start)."""
    ref, port = _engines("granite-3-8b", slots=2, prefill_len=8)

    def reqs(cls):
        return [cls(uid=0, prompt=np.array([5, 6, 7], np.int32), max_new=2),
                cls(uid=1, prompt=np.array([4], np.int32), max_new=2),
                cls(uid=2, prompt=np.array([9, 3], np.int32), max_new=14)]

    done_r, done_t = ref.run(reqs(RS.Request)), port.run(reqs(TS.Request))
    assert [r.out_tokens for r in done_t] == [r.out_tokens for r in done_r]
    assert int(port.caches["len"]) == int(ref.caches["len"]) == 21
    cap = T.init_caches(port.cfg, 2, 8, device="cpu")["k"].shape[2]
    assert cap == 16 and port.caches["k"].shape[2] == cap
    for k in ("k", "v"):
        np.testing.assert_allclose(port.caches[k].numpy(), np.asarray(ref.caches[k]),
                                   rtol=2e-4, atol=2e-4)


def test_hybrid_merge_writes_the_size_matched_axis():
    """``h`` is (n_super, 2, B, W): with ``batch_slots=2`` the merge's
    "axis 1 has the slot count" rule takes the (rec1, rec2) axis, so
    admitting slot 1 overwrites rec2's state of slot 0 too (with the
    prefill's zero state).  Both packages do it."""
    ref, port = _engines("recurrentgemma-2b", slots=2, prefill_len=8)
    a = dict(uid=0, prompt=np.array([5, 6, 7], np.int32), max_new=6)
    b = dict(uid=1, prompt=np.array([9, 3], np.int32), max_new=6)
    for eng, cls in ((ref, RS.Request), (port, TS.Request)):
        eng.admit(cls(**a))
        eng.step()
    before = port.caches["h"].clone()
    assert before[:, 1, 0].abs().sum() > 0  # slot 0's rec2 state after a step
    for eng, cls in ((ref, RS.Request), (port, TS.Request)):
        eng.admit(cls(**b))
    after = port.caches["h"]
    assert torch.equal(after[:, 1], torch.zeros_like(after[:, 1]))  # both slots' rec2
    assert torch.equal(after[:, 0], before[:, 0])
    np.testing.assert_allclose(after.numpy(), np.asarray(ref.caches["h"]), rtol=2e-4, atol=2e-4)


def test_hybrid_merge_with_three_slots_fails_in_both():
    """With 3 slots no axis of ``conv`` (n_super, 2, B, K-1, W) but the
    wrong one (K-1 = 3 for the tail's (B, K-1, W)) matches, so the merge
    keeps the prefill's batch-1 ``conv``, and the next decode step fails
    in both packages on mismatched batch sizes."""
    ref, port = _engines("recurrentgemma-2b", slots=3, prefill_len=8)
    assert ref.cfg.hybrid.conv_width - 1 == 3
    with pytest.raises(TypeError):
        ref.run([RS.Request(uid=0, prompt=np.array([5, 6], np.int32), max_new=3)])
    with pytest.raises(RuntimeError):
        port.run([TS.Request(uid=0, prompt=np.array([5, 6], np.int32), max_new=3)])
    assert tuple(port.caches["conv"].shape)[2] == 1


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_recurrent_prefill_returns_zero_states(arch):
    rcfg = RC.reduced(RC.get_config(arch))
    host = _host_params(rcfg, 1)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (1, 8)).astype(np.int32)
    _, cr = RT.prefill(jax.tree_util.tree_map(jnp.asarray, host), rcfg, tokens=jnp.asarray(toks))
    _, ct = T.prefill(L.params_from_numpy(host, "cpu"), TC.reduced(TC.get_config(arch)),
                      tokens=torch.from_numpy(toks))
    assert sorted(ct) == sorted(cr)
    for k, v in ct.items():
        if k == "len":
            assert int(v) == int(cr[k]) == 8
        else:
            assert not v.any() and not np.asarray(cr[k]).any(), k


def test_temperature_sampling_is_deterministic_per_seed():
    host = _host_params(RC.reduced(RC.get_config("stablelm-1.6b")), 2)
    cfg = TC.reduced(TC.get_config("stablelm-1.6b"))

    def run(seed):
        eng = TS.ServeEngine(cfg, L.params_from_numpy(host, "cpu"), 2, 8, temperature=0.8,
                             seed=seed, device="cpu")
        return [r.out_tokens for r in eng.run(_requests(TS.Request, cfg.vocab_size, n=4))]

    a, b, c = run(5), run(5), run(6)
    assert a == b
    assert a != c


def test_engine_exports_and_device_rules():
    assert TSERVE.ServeEngine is TS.ServeEngine and TSERVE.Request is TS.Request
    assert TS.WaveletServeEngine is TSERVE.WaveletServeEngine
    cfg = TC.reduced(TC.get_config("granite-3-8b"))
    params = L.init_params(T.model_defs(cfg), 0, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        for call in (lambda: TS.ServeEngine(cfg, params, 2, 8),
                     lambda: L.params_from_numpy({"a": np.zeros(2)}),
                     lambda: L.init_params(T.model_defs(cfg), 0),
                     lambda: TD.WaveletBandSplit()):
            with pytest.raises(RuntimeError, match="is_available"):
                call()
    meta = L.abstract_params(T.model_defs(cfg), torch.float32)
    with pytest.raises(ValueError, match="params live on"):
        TS.ServeEngine(cfg, meta, 2, 8, device="cpu")


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_batches_byte_equal(hosts):
    for host_id in range(hosts):
        kw = dict(vocab_size=100, seq_len=32, global_batch=4, n_hosts=hosts, host_id=host_id,
                  seed=9)
        assert TD.DataConfig(**kw).host_batch == RD.DataConfig(**kw).host_batch
        for step in (0, 3, 17):
            _assert_batches_equal(TD.SyntheticLM(TD.DataConfig(**kw)).batch(step),
                                  RD.SyntheticLM(RD.DataConfig(**kw)).batch(step))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_file_tokens_byte_equal(tmp_path, dtype):
    arr = (np.arange(1000) * 7919 % 50000).astype(dtype)
    path = tmp_path / "toks.npy"
    np.save(path, arr)
    for host_id in (0, 1):
        kw = dict(vocab_size=50000, seq_len=16, global_batch=4, n_hosts=2, host_id=host_id)
        t, r = TD.FileTokens(TD.DataConfig(**kw), path), RD.FileTokens(RD.DataConfig(**kw), path)
        assert t.n_windows == r.n_windows
        for step in (0, 5, 40):
            _assert_batches_equal(t.batch(step), r.batch(step))


@pytest.mark.parametrize("scheme,mode", [("cdf53", "paper"), ("cdf22", "paper"),
                                         ("cdf53", "jpeg2000")])
def test_wavelet_band_split_equal(scheme, mode):
    rng = np.random.default_rng(4)
    for shape in ((4, 64), (3, 67), (2, 5, 130)):
        x = rng.integers(-32768, 32768, size=shape)
        want = RD.WaveletBandSplit(levels=2, mode=mode, scheme=scheme)(x)
        stage = TD.WaveletBandSplit(levels=2, mode=mode, scheme=scheme, device="cpu")
        for src in (x, torch.from_numpy(x.astype(np.int32))):
            got = stage(src)
            assert sorted(got) == sorted(want)
            for k in want:
                assert isinstance(got[k], np.ndarray)
                np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_order():
    cfg = TD.DataConfig(vocab_size=50, seq_len=8, global_batch=2)
    pf = TD.Prefetcher(TD.SyntheticLM(cfg), start_step=3)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    src = RD.SyntheticLM(RD.DataConfig(vocab_size=50, seq_len=8, global_batch=2))
    for step, batch in got:
        _assert_batches_equal(batch, src.batch(step))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 10's checkpoint tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple
    fill: str  # normal | ones | zeros


def _written_out_stablelm(layers):
    """The tree phase 10 wrote out by hand before it took it from
    ``repro_torch.models``."""
    d, h, hd, f, v = 2048, 32, 64, 5632, 100352

    def norm(*lead):
        return {"scale": _Leaf(lead + (d,), "ones"), "bias": _Leaf(lead + (d,), "zeros")}

    return {
        "embed": {"embedding": _Leaf((v, d), "normal")},
        "layers": {
            "ln1": norm(layers),
            "attn": {"wq": _Leaf((layers, d, h, hd), "normal"),
                     "wk": _Leaf((layers, d, h, hd), "normal"),
                     "wv": _Leaf((layers, d, h, hd), "normal"),
                     "wo": _Leaf((layers, h, hd, d), "normal")},
            "ln2": norm(layers),
            "mlp": {"w_gate": _Leaf((layers, d, f), "normal"),
                    "w_up": _Leaf((layers, d, f), "normal"),
                    "w_down": _Leaf((layers, f, d), "normal")},
        },
        "ln_f": norm(),
        "head": {"w_out": _Leaf((d, v), "normal")},
    }


def test_phase10_tree_is_the_written_out_tree():
    """Same leaf names, order, shapes and fills, so phase 10's draws (and
    its checkpoint bytes) do not move."""
    import pathlib
    import sys

    from repro_torch import tree as TT

    root = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    old = [(n, (leaf.shape, leaf.fill))
           for n, leaf in TT.leaf_paths(_written_out_stablelm(chip_smoke.CKPT_LAYERS))]
    new = [(n, (tuple(d.shape), chip_smoke.fill_kind(d)))
           for n, d in TT.leaf_paths(chip_smoke.stablelm_defs())]
    assert new == old
    assert len(new) == 15


def test_torch_serve_decode_example_runs_on_the_cpu(capsys):
    """``examples/torch_serve_decode.py --device cpu``: both halves."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_serve_decode.py"
    spec = importlib.util.spec_from_file_location("torch_serve_decode", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.wavelet_demo(torch.device("cpu"))
    mod.lm_demo(torch.device("cpu"))
    out = capsys.readouterr().out
    assert "full tier bit-exact vs submitted image: True" in out
    assert "served 10 LM requests" in out
