"""The port's dry run and roofline (``repro_torch.roofline``,
``launch/dryrun.py``) against the reference's ``repro.roofline``, and
against the program they count.

* ``model_flops_for``, ``build_report`` (with the reference's constants
  patched in) and the ring formulas equal the reference's
  (``parse_collectives`` on a synthetic HLO line of each op); with the
  H100's constants each term is its formula.
* The ``meta`` trace is the real program: the FLOP and byte counts of a
  train step, a prefill and a decode step on ``meta`` tensors equal the
  same counters on real CPU tensors, for one reduced config a family.
* The storage-keyed peak follows autograd's saved tensors: with remat off
  it is above a hand count of the saved activations, and above the peak
  with remat on.

The probes and the full-width cells are in ``test_torch_dryrun_cells.py``,
the pod sync's wire in ``test_torch_dryrun_wire.py``.

``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS`` on
import.  ``repro.roofline`` imports only the stdlib.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import roofline as RRL
from repro.configs import get_config as ref_config
from repro.configs import shape_cell as ref_cell
from repro_torch import roofline as RL
from repro_torch import tree as TR
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.configs.base import SHAPE_SUITE, ShapeCell
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optim
from repro_torch.train.train_step import make_train_step

FAMILIES = ("stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b", "recurrentgemma-2b",
            "musicgen-medium", "internvl2-26b")  # dense, moe, ssm, hybrid, audio, vlm
SMALL = {"train": ShapeCell("t64", 64, 2, "train"), "prefill": ShapeCell("p64", 64, 2, "prefill"),
         "decode": ShapeCell("d64", 64, 2, "decode")}


# ---------------------------------------------------------------------------
# The roofline against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_for_equals_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for cell in SHAPE_SUITE:
        got = RL.model_flops_for(cfg, cell, cfg.param_count(), cfg.active_param_count())
        want = RRL.model_flops_for(rcfg, ref_cell(cell.name), rcfg.param_count(),
                                   rcfg.active_param_count())
        assert got == want, (arch, cell.name)


@pytest.mark.parametrize("chips", [1, 2, 256])
def test_build_report_equals_reference_with_its_constants(monkeypatch, chips):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(RL, name, getattr(RRL, name))
    for cost, wire in (({"flops": 3.5e15, "bytes accessed": 2.25e12}, 7e9),
                       ({"flops": 1e9, "bytes accessed": 8e12}, 0.0),
                       ({"flops": 0.0}, 1e12)):
        kw = dict(arch="a", cell="c", mesh_name="m", chips=chips, cost=cost,
                  model_flops=2.5e15, per_device_peak_memory=1e9, notes="n")
        got = RL.build_report(collectives=RL.CollectiveStats({"all-reduce": 2}, wire,
                                                             {"all-reduce": wire}), **kw)
        want = RRL.build_report(collectives=RRL.CollectiveStats({"all-reduce": 2}, wire,
                                                                {"all-reduce": wire}), **kw)
        assert got.as_dict() == want.as_dict()


HLO_DTYPES = {"f32": 4, "bf16": 2, "s8": 1, "s32": 4}


def _hlo_line(op: str, dt: str, out_shape, in_shape, k: int) -> str:
    def shape(s):
        return f"{dt}[{','.join(map(str, s))}]{{{','.join(map(str, range(len(s))))}}}"

    groups = ("source_target_pairs={{0,1},{1,0}}" if op == "collective-permute"
              else "replica_groups={{" + ",".join(map(str, range(k))) + "}}")
    return f"  %x.1 = {shape(out_shape)} {op}({shape(in_shape)} %p.1), {groups}, to_apply=%add"


@pytest.mark.parametrize("k", [2, 4, 16])
@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_wire_bytes_equal_parse_collectives(op, k):
    """The ring formula of each op equals the reference's, read from a
    synthetic HLO line of that op (``k`` devices, a group of ``k``)."""
    for dt, size in HLO_DTYPES.items():
        for rows in (16, 48, 1024):
            full, part = (rows * k, 256), (rows, 256)
            out_shape, in_shape = {"all-gather": (full, part),
                                   "reduce-scatter": (part, full)}.get(op, (full, full))
            stats = RRL.parse_collectives(_hlo_line(op, dt, out_shape, in_shape, k), k)
            got = RL.wire_bytes(op, np.prod(out_shape) * size, np.prod(in_shape) * size, k)
            assert got == stats.wire_bytes_per_device, (op, dt, rows, k)
    assert RL.wire_bytes(op, 1024, 1024, 1) == 0.0


def test_h100_terms_are_their_formulas():
    coll = RL.CollectiveStats()
    coll.add("ring", 9e8)
    for dtype, peak in (("bfloat16", 989e12), ("float32", 67e12)):
        r = RL.build_report(arch="a", cell="c", mesh_name="h100x1", chips=2,
                            cost={"flops": 4e15, "bytes accessed": 6.7e12}, collectives=coll,
                            model_flops=1e15, compute_dtype=dtype)
        assert r.compute_s == 8e15 / (2 * peak)
        assert r.memory_s == 13.4e12 / (2 * 3.35e12)
        assert r.collective_s == 9e8 / 450e9
        assert r.collective_bytes == 1.8e9 and r.useful_ratio == 1e15 / 8e15
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_only_switches_that_change_the_program_tag_an_artifact(monkeypatch):
    cfg, cell = get_config("stablelm-1.6b"), SHAPE_SUITE[0]
    mesh, _, _ = D.make_mesh(False)
    rules = D.rules_for_cell(cfg, cell, mesh, False)
    for k in ("REPRO_OPT_KV_REPLICATE", "REPRO_OPT_ATTN_REPLICATE"):
        monkeypatch.setenv(k, "1")
    assert D._opt_tag() == "" and D.rules_for_cell(cfg, cell, mesh, False) == rules
    monkeypatch.setenv("REPRO_OPT_CE_CHUNK", "512")
    assert D._opt_tag() == "__opt_ce_chunk512"
    assert D.hillclimb_overrides(cfg).ce_chunk == 512


# ---------------------------------------------------------------------------
# The meta trace is the real program
# ---------------------------------------------------------------------------


def _real(args, cfg, seed=0):
    """The abstract arguments as CPU tensors drawn with numpy: floats
    normal(0, 0.02), token and label ids in the vocabulary, a cache
    length of the cell's prefill."""
    rng = np.random.default_rng(seed)

    def leaf(t):
        if t.dtype.is_floating_point:
            return torch.from_numpy(rng.normal(0, 0.02, t.shape).astype(np.float32)).to(t.dtype)
        if t.ndim == 0:
            return torch.tensor(SMALL["decode"].seq_len, dtype=t.dtype)
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, t.shape)).to(t.dtype)

    return TR.map_leaves(leaf, args)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_trace_counts_the_real_program(arch, kind):
    cfg = reduced(get_config(arch))
    mesh = D.make_mesh(False)[0]
    fn, args, _ = D.build_cell(cfg, SMALL[kind], mesh, False)
    assert all(t.device.type == "meta" for t in D._tensors(args))
    meta = D.count_step(fn, args)
    real = D.count_step(fn, _real(args, cfg))
    assert meta["flops"] > 0 and meta["bytes"] > 0
    assert (meta["flops"], meta["bytes"]) == (real["flops"], real["bytes"])


def test_abstract_caches_are_init_caches_on_meta():
    for arch in FAMILIES:
        cfg = reduced(get_config(arch))
        got = dict(TR.leaf_paths(T.abstract_caches(cfg, 3, 40)))
        want = dict(TR.leaf_paths(T.init_caches(cfg, 3, 40, device="cpu")))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), got[k].dtype) == (tuple(v.shape), v.dtype), (arch, k)
    with pytest.raises(ValueError):
        T.init_caches(cfg, 3, 40, device="meta")  # the entry point still refuses meta


def test_views_move_nothing_and_in_place_ops_count_once():
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    got = D.count_step(lambda x, y: (x.t()[:8], x.reshape(-1), x @ y), (a, b))
    assert got["bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4  # the matmul only
    assert got["flops"] == 2 * 64 * 32 * 16
    got = D.count_step(lambda x: x.mul_(2.0), (a,))
    assert got["bytes"] == 2 * 64 * 32 * 4  # read once, written once
    assert got["temp_bytes"] == 0  # an argument's storage is not the step's


# ---------------------------------------------------------------------------
# Peak memory follows storages
# ---------------------------------------------------------------------------


def test_peak_follows_saved_activations():
    """A 2-layer reduced dense config, 4 x 128, float32, on real CPU
    tensors.  Hand count of what the backward keeps: with remat each
    layer's input, the float32 logits and one recomputed layer; without,
    every layer's attention probabilities (one (B, S, H, chunk) tensor a
    key chunk) and its MLP's gate and up projections."""
    b, s = 4, 128
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b")), n_layers=2)
    params = L.init_params(T.model_defs(cfg), 0, torch.float32, device="cpu")
    opt = optim.adamw_init(params)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
             for k in ("tokens", "labels")}
    chunks = s // cfg.attn_chunk
    layer = 4 * b * s * (chunks * cfg.n_heads * cfg.attn_chunk + 2 * cfg.d_ff)
    logits = 4 * b * s * cfg.vocab_size
    peak = {}
    for remat in (True, False):
        step = make_train_step(dataclasses.replace(cfg, remat=remat))
        peak[remat] = D.count_step(step, (params, opt, batch))["temp_bytes"]
    assert peak[True] >= cfg.n_layers * 4 * b * s * cfg.d_model + logits + layer
    assert peak[False] >= cfg.n_layers * layer + logits
    assert peak[False] > peak[True] + (cfg.n_layers - 1) * layer // 2
