"""The port's row-sharded 2-D transform and its sharding rules, against ``repro``.

``repro_torch.kernels.sharded`` runs one level of the port's 2-D kernels
on each rank's halo-extended shard and crops it; the reference runs
interior math under ``shard_map``.  Here: ``check_shardable`` and the
sharding rules against the reference's, the ext-crop identity against
the interior-only primitives (``schemes.lift_*_axis_ext``), one spawned
4-rank gloo world (one process a rank, ``tests/torch_dist_ranks.py``)
over the reference's test grid compared with
``repro.kernels.dwt_fwd_2d_multi`` exactly, and the collective watchdog
on a one-rank world in this process.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax  # noqa: F401  (the reference runs on the CPU: JAX_PLATFORMS=cpu)

from repro import kernels as RK
from repro import sharding as RSH
from repro.configs import ARCH_IDS, SHAPE_SUITE, get_config
from repro.kernels import sharded as RSHD
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import kernels as TK
from repro_torch import obs
from repro_torch import sharding as TSH
from repro_torch import tree as T
from repro_torch.core import schemes as TS
from repro_torch.kernels import fused2d as TF2
from repro_torch.kernels import sharded as TSHD
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.resilience import inject
from repro_torch.resilience.errors import CollectiveTimeoutError
from torch_dist_ranks import run_world

SCHEMES = ("cdf53", "haar", "cdf22", "97m")


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001  the class and message are compared
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# check_shardable and the sharding rules: plain Python, same answers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_check_shardable_matches_reference(scheme):
    seen = set()
    for h in (8, 16, 60, 64, 96, 128, 2048):
        for w in (2, 3, 5, 17, 32, 33, 2048):
            for n in (1, 2, 4, 8):
                for levels in (0, 1, 2, 3, 5):
                    want = _raised(lambda: RSHD.check_shardable(h, w, n, levels, scheme))
                    got = _raised(lambda: TSHD.check_shardable(h, w, n, levels, scheme))
                    assert got == want, (h, w, n, levels)
                    seen.add(want is None)
    assert seen == ({False} if scheme == "cdf22" else {True, False})


def test_check_shardable_rejects_bad_shapes():
    """The reference's bad shapes (``tests/test_sharded2d.py``)."""
    with pytest.raises(ValueError, match="divisible"):
        TSHD.check_shardable(60, 32, 4, 2)  # 60 % (4*4) != 0
    with pytest.raises(ValueError, match="W >= 3"):
        TSHD.check_shardable(64, 2, 4, 1)
    with pytest.raises(ValueError, match="W >= 3"):
        TSHD.check_shardable(128, 5, 4, 3)  # width hits 2 at level 3
    with pytest.raises(ValueError, match="levels"):
        TSHD.check_shardable(64, 32, 4, 0)
    with pytest.raises(ValueError, match="reflection-asymmetric"):
        TSHD.check_shardable(64, 32, 4, 1, "cdf22")
    TSHD.check_shardable(64, 32, 4, 2)  # and a valid one passes


def test_mesh_makers_need_a_world():
    """Before any world is up in this process (the one-rank fixture below
    starts one)."""
    from repro_torch.launch import mesh as M

    if dist.is_initialized():
        pytest.skip("a world is up in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.smoke_mesh("cpu")


class _StubMesh:
    """A mesh of the production layouts without 256 devices: the rules
    read only its axis sizes."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_match_reference(arch):
    """``rules_for`` / ``spec_for`` (through ``tree_specs``) /
    ``validate_divisibility`` equal the reference's for every model
    config at full width, on the single- and multi-pod layouts and every
    shape cell's batch."""
    cfg = get_config(arch)
    defs = RT.model_defs(cfg)
    axes = RL.logical_axes(defs)
    shapes = [d.shape for d in jax.tree_util.tree_leaves(defs)]
    for multi_pod, mesh in ((False, _StubMesh(data=16, model=16)),
                            (True, _StubMesh(pod=2, data=16, model=16))):
        for fsdp in (False, True):
            for cell in SHAPE_SUITE:
                kw = dict(multi_pod=multi_pod, fsdp=fsdp, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                          d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
                          global_batch=cell.global_batch, prefer_replicated_kv=fsdp)
                rules = TSH.rules_for(mesh, **kw)
                assert rules == RSH.rules_for(mesh, **kw)
                want = [tuple(s) for s in jax.tree_util.tree_leaves(
                    RSH.tree_specs(axes, rules), is_leaf=lambda s: isinstance(s, RSH.P))]
                got = [tuple(s) for s in T.leaves(TSH.tree_specs(axes, rules),
                                                  is_leaf=lambda s: isinstance(s, TSH.P))]
                assert got == want
                for shape, spec in zip(shapes, got):
                    assert (TSH.validate_divisibility(shape, TSH.P(*spec), mesh)
                            == RSH.validate_divisibility(shape, RSH.P(*spec), mesh))
    assert TSH.base_rules(True, fsdp=True) == RSH.base_rules(True, fsdp=True)
    assert TSH.spec_for(("batch", "batch", "heads"), TSH.base_rules(True)) == TSH.P(
        ("pod", "data"), None, "model")


def test_placements_and_constrain_on_one_rank(one_rank_mesh):
    """``placements`` maps a spec onto mesh dims; ``constrain`` is the
    identity outside a rules context and redistributes a DTensor in one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    mesh = one_rank_mesh
    assert TSH.placements(TSH.P(None, "data"), mesh) == (Shard(1),)
    assert TSH.placements(TSH.P(), mesh) == (Replicate(),)
    with pytest.raises(ValueError, match="model"):
        TSH.placements(TSH.P("model"), mesh)
    x = torch.arange(12).reshape(3, 4)
    assert TSH.constrain(x, ("batch", None)) is x
    d = distribute_tensor(x, mesh, [Replicate()])
    with TSH.logical_rules({"batch": "data"}, mesh):
        got = TSH.constrain(d, ("batch", None))
        assert TSH.constrain(x, ("batch", None)) is x
    assert isinstance(got, DTensor) and tuple(got.placements) == (Shard(0),)
    assert torch.equal(got.full_tensor(), x)
    pairs = TSH.tree_shardings({"w": ("batch", "embed")}, {"batch": "data"}, mesh)
    assert pairs["w"] == (mesh, (Shard(0),))


# ---------------------------------------------------------------------------
# The ext-crop identity: one level of the 2-D kernels' plain version on
# the extended shard, cropped, is the reference's literal math.
# ---------------------------------------------------------------------------


def _ext_rows(x, halo, top, bot):
    """Rows of the extended shard by the module's index rule: ``top`` /
    ``bot`` are the neighbours' rows, or None at a global edge, where the
    whole-point reflect rows [halo..1] / [h-2..h-halo-1] stand in."""
    h = x.shape[-2]
    top = x[..., list(range(halo, 0, -1)), :] if top is None else top
    bot = x[..., [h - 2 - j for j in range(halo)], :] if bot is None else bot
    return np.concatenate([top, x, bot], axis=-2)


@pytest.mark.parametrize("mode", ["paper", "jpeg2000"])
@pytest.mark.parametrize("scheme", ["cdf53", "haar", "97m"])
def test_ext_crop_identity(scheme, mode):
    """Forward: ``fused2d`` (band policy) on the ext shard, rows
    ``[m, m + h/2)`` kept, equals the reference's width pass
    (``lift_fwd_axis``) then interior-only column math
    (``lift_fwd_axis_ext``) on the same rows, for interior and edge
    shards and for neighbour rows of any content.  Inverse: the same for
    ``inv_margin`` band rows and ``lift_inv_axis_ext``."""
    sch = TS.get_scheme(scheme)
    halo, m, mi = sch.halo, sch.fwd_margin, sch.inv_margin
    rng = np.random.default_rng(3)
    for h_loc, w in ((4, 7), (6, 8), (8, 3), (16, 33)):
        if h_loc < max(4, halo + 2):
            continue
        x = rng.integers(-2000, 2000, (2, h_loc, w)).astype(np.int32)
        for top_kind in ("edge", "random"):
            for bot_kind in ("edge", "random"):
                nb = [None if k == "edge" else
                      rng.integers(-2000, 2000, (2, halo, w)).astype(np.int32)
                      for k in (top_kind, bot_kind)]
                ext = torch.from_numpy(_ext_rows(x, halo, *nb))
                got = TF2.dwt_fwd_2d_multi(ext, levels=1, mode=mode, scheme=sch, checked=False)
                s_r, d_r = TS.lift_fwd_axis(ext, sch, axis=-1, mode=mode)
                ll, lh = TS.lift_fwd_axis_ext(s_r, sch, axis=-2, mode=mode)
                hl, hh = TS.lift_fwd_axis_ext(d_r, sch, axis=-2, mode=mode)
                core = slice(m, m + h_loc // 2)
                for g, want in zip((got.ll,) + tuple(got.details[0]), (ll, lh, hl, hh)):
                    np.testing.assert_array_equal(g[..., core, :].numpy(), want.numpy())
        # inverse: bands of n_loc rows extended by inv_margin rows each side
        n_loc = h_loc // 2
        bands = [rng.integers(-900, 900, (2, n_loc + 2 * mi, wd)).astype(np.int32)
                 for wd in (w - w // 2, w - w // 2, w // 2, w // 2)]
        bt = [torch.from_numpy(b) for b in bands]
        got = TF2.dwt_inv_2d_multi(TK.Pyramid2D(bt[0], ((bt[1], bt[2], bt[3]),)), mode=mode,
                                   scheme=sch, checked=False)
        s_r = TS.lift_inv_axis_ext(bt[0], bt[1], sch, axis=-2, mode=mode)
        d_r = TS.lift_inv_axis_ext(bt[2], bt[3], sch, axis=-2, mode=mode)
        want = TS.lift_inv_axis(s_r, d_r, sch, axis=-1, mode=mode)
        np.testing.assert_array_equal(got[..., 2 * mi:2 * mi + 2 * n_loc, :].numpy(),
                                      want.numpy())


def test_ext_crop_needs_reflection_symmetric_steps():
    """cdf22's gradient step is antisymmetric: reflect rows at a global
    edge do not reproduce its band policy, which is why
    ``check_shardable`` refuses it."""
    sch = TS.get_scheme("cdf22")
    x = torch.from_numpy(np.random.default_rng(4).integers(-900, 900, (16, 8)).astype(np.int32))
    whole = TF2.dwt_fwd_2d_multi(x, levels=1, scheme=sch, checked=False)
    ext = torch.from_numpy(_ext_rows(x.numpy(), sch.halo, None, None))
    crop = TF2.dwt_fwd_2d_multi(ext, levels=1, scheme=sch, checked=False)
    core = slice(sch.fwd_margin, sch.fwd_margin + 8)
    assert not torch.equal(crop.details[0][0][core], whole.details[0][0])


# ---------------------------------------------------------------------------
# One 4-rank gloo world over the reference's grid.
# ---------------------------------------------------------------------------

GRID_SHAPES = ((64, 32), (64, 33), (96, 48), (64, 3))


def _grid():
    cases = []
    for scheme in ("cdf53", "haar", "97m"):
        for mode in ("paper", "jpeg2000"):
            for lead in ((), (2,)):
                for h, w in GRID_SHAPES:
                    for levels in (1, 2, 3):
                        if _raised(lambda: RSHD.check_shardable(h, w, 4, levels, scheme)):
                            continue
                        cases.append(dict(scheme=scheme, mode=mode, lead=list(lead), h=h, w=w,
                                          levels=levels, mesh="4", dtensor_in=False,
                                          checked=False))
    # rows over `data` of a (2, 2) mesh; a DTensor input; checked mode
    cases.append(dict(scheme="cdf53", mode="jpeg2000", lead=[2], h=64, w=33, levels=3,
                      mesh="2x2", dtensor_in=False, checked=False))
    cases.append(dict(scheme="97m", mode="paper", lead=[], h=96, w=48, levels=2,
                      mesh="2x2", dtensor_in=True, checked=False))
    cases.append(dict(scheme="cdf53", mode="paper", lead=[], h=64, w=32, levels=2,
                      mesh="4", dtensor_in=True, checked=True))
    return cases


SERVE_SHAPES = ((32, 32), (64, 64), (20, 31), (64, 40), (32, 32), (9, 64))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The grid through 4 ranks; the reference's pyramids of each case."""
    work = tmp_path_factory.mktemp("world4")
    rng = np.random.default_rng(11)
    cases = _grid()
    inputs = {"cases": np.asarray(json.dumps(cases))}
    for i, c in enumerate(cases):
        inputs[f"x{i}"] = rng.integers(-900, 900, tuple(c["lead"]) + (c["h"], c["w"])).astype(
            np.int32)
    for i, shape in enumerate(SERVE_SHAPES):
        inputs[f"req{i}"] = rng.integers(-128, 128, shape).astype(np.int32)
    inputs["n_requests"] = np.asarray(len(SERVE_SHAPES))
    np.savez(work / "inputs.npz", **inputs)
    outs = run_world("sharded", 4, work)
    want = [RK.dwt_fwd_2d_multi(inputs[f"x{i}"], levels=c["levels"], mode=c["mode"],
                                scheme=c["scheme"]) for i, c in enumerate(cases)]
    return cases, inputs, outs, want


def _leaves_np(pyr):
    return [np.asarray(pyr.ll)] + [np.asarray(b) for lvl in pyr.details for b in lvl]


@pytest.mark.sharded
def test_sharded_fwd_bit_exact_on_4_ranks(world4):
    cases, _inputs, outs, want = world4
    assert len(cases) >= 110
    for i, (c, w) in enumerate(zip(cases, want)):
        for r, out in enumerate(outs):
            for j, band in enumerate(_leaves_np(w)):
                np.testing.assert_array_equal(out[f"c{i}_b{j}"], band, err_msg=f"{c} rank {r}")


@pytest.mark.sharded
def test_sharded_inv_round_trips_on_4_ranks(world4):
    """From the sharded pyramid and from full bands alike."""
    cases, inputs, outs, _want = world4
    for i, c in enumerate(cases):
        for out in outs:
            np.testing.assert_array_equal(out[f"c{i}_inv"], inputs[f"x{i}"], err_msg=str(c))
            np.testing.assert_array_equal(out[f"c{i}_inv_full"], inputs[f"x{i}"], err_msg=str(c))


@pytest.mark.sharded
def test_sharded_output_stays_sharded(world4):
    """Every band is a DTensor sharded on its row axis, each rank holding
    its own rows only (the reference: no silent all-gather)."""
    cases, _inputs, outs, want = world4
    for i, (c, w) in enumerate(zip(cases, want)):
        n = 4 if c["mesh"] == "4" else 2
        for out in outs:
            assert bool(out[f"c{i}_sharded"]), c
            for j, band in enumerate(_leaves_np(w)):
                local = tuple(out[f"c{i}_b{j}_local"])
                assert local == band.shape[:-2] + (band.shape[-2] // n, band.shape[-1]), c


@pytest.mark.sharded
def test_sharded_serve_on_4_ranks_equals_meshless_engine(world4):
    """A mesh engine on every rank serves the same pyramids and the same
    WZRC bytes as the mesh-less engine."""
    from repro_torch.serve import TransformRequest, WaveletServeEngine

    _cases, inputs, outs, _want = world4
    eng = WaveletServeEngine(buckets=[(32, 32), (64, 64)], batch_slots=2, levels=2,
                             scheme="cdf53", mode="jpeg2000", device="cpu",
                             encode_response=True)
    done = eng.run([TransformRequest(uid=i, image=inputs[f"req{i}"])
                    for i in range(len(SERVE_SHAPES))])
    assert len(done) == len(SERVE_SHAPES)
    for r in done:
        for out in outs:
            for j, band in enumerate(_leaves_np(r.pyramid)):
                np.testing.assert_array_equal(out[f"req{r.uid}_b{j}"], band)
            assert out[f"req{r.uid}_enc"].tobytes() == r.encoded
            assert int(out[f"req{r.uid}_idx"]) == r.batch_index


# ---------------------------------------------------------------------------
# One rank in this process: refusals and the collective watchdog.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    init = tmp_path_factory.mktemp("rendezvous") / "file"
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=1, rank=0)
    try:
        yield make_mesh_compat((1,), ("data",), "cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_makers_on_one_rank(one_rank_mesh):
    """The reference's mesh makers over a one-rank world: the smoke and
    elastic meshes have its axis names; a production layout needs 256 /
    512 ranks."""
    from repro_torch.launch import mesh as M

    smoke = M.smoke_mesh("cpu")
    assert smoke.mesh_dim_names == ("data", "model") and tuple(smoke.shape) == (1, 1)
    elastic = M.make_elastic_mesh(model_parallelism=2, device_type="cpu")
    assert M.axis_sizes(elastic) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="256 ranks"):
        M.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        M.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        M.make_mesh_compat((1,), ("data", "model"), "cpu")
    assert M.axis_size(one_rank_mesh, "data") == 1
    assert M.axis_size(_StubMesh(data=16, model=16), "model") == 16


def test_sharded_refuses_what_the_reference_refuses(one_rank_mesh):
    x = torch.zeros((16, 16), dtype=torch.int32)
    for kw, h, w in ((dict(scheme="cdf22"), 16, 16), (dict(levels=4), 16, 16),
                     (dict(levels=1), 16, 2)):
        want = _raised(lambda: RSHD.check_shardable(h, w, 1, kw.get("levels", 1),
                                                    kw.get("scheme", "cdf53")))
        got = _raised(lambda: TSHD.dwt_fwd_2d_sharded(x[:h, :w], one_rank_mesh, **kw))
        assert got == want and want is not None
    with pytest.raises(ValueError, match="need a"):
        TSHD.dwt_fwd_2d_sharded(torch.zeros(16, dtype=torch.int32), one_rank_mesh)
    with pytest.raises(TypeError, match="int64"):
        TSHD.dwt_fwd_2d_sharded(x.to(torch.int64), one_rank_mesh)
    with pytest.raises(KeyError, match="model"):
        TSHD.dwt_fwd_2d_sharded(x, one_rank_mesh, axis="model")


def test_collective_watchdog_times_out(one_rank_mesh):
    """As the reference's chaos test: a healthy mesh completes under the
    watchdog, a stuck neighbour (a delay inside the timed region) raises
    ``CollectiveTimeoutError``, and the transform serves again after."""
    mesh = one_rank_mesh
    x = torch.from_numpy(np.random.default_rng(5).integers(-100, 100, (16, 16), dtype=np.int32))
    want = TK.dwt_fwd_2d_multi(x, levels=1)
    obs.reset()
    pyr = TK.dwt_fwd_2d_sharded(x, mesh, levels=1, timeout_s=30.0)
    assert all(torch.equal(a.full_tensor(), b) for a, b in zip(
        [pyr.ll] + list(pyr.details[0]), [want.ll] + list(want.details[0])))
    inject.reset()
    try:
        with inject.armed("sharded.collective", action="delay", delay_s=1.0):
            with pytest.raises(CollectiveTimeoutError, match="stuck"):
                TK.dwt_fwd_2d_sharded(x, mesh, levels=1, timeout_s=0.05)
    finally:
        inject.reset()
    for t in __import__("threading").enumerate():
        if t.name.startswith(TSHD.WATCHDOG_THREAD):
            t.join(10.0)
    pyr2 = TK.dwt_inv_2d_sharded(TK.dwt_fwd_2d_sharded(x, mesh, levels=1, timeout_s=30.0), mesh,
                                 timeout_s=30.0)
    assert torch.equal(pyr2.full_tensor(), x)
    snap = obs.snapshot()
    assert snap["metrics"]["collectives.watchdog_trips"] == 1
    assert "collectives" in obs.subsystems()
    assert any(k.startswith("collectives.exchange_ms") for k in snap["metrics"])


def test_sharded_checked_and_aliases_on_one_rank(one_rank_mesh):
    """``checked=True`` certifies as the single-device transform does; the
    ``dwt53_*`` aliases are cdf53."""
    from repro_torch.resilience.errors import IntegerOverflowError

    mesh = one_rank_mesh
    x = torch.from_numpy(np.random.default_rng(6).integers(-900, 900, (2, 32, 24),
                                                           dtype=np.int32))
    pyr = TK.dwt53_fwd_2d_sharded(x, mesh, levels=2, mode="jpeg2000")
    want = TK.dwt_fwd_2d_multi(x, levels=2, mode="jpeg2000")
    assert torch.equal(pyr.ll.full_tensor(), want.ll)
    assert torch.equal(TK.dwt53_inv_2d_sharded(pyr, mesh, mode="jpeg2000").full_tensor(), x)
    back = TK.dwt_inv_2d_sharded(pyr, mesh, mode="jpeg2000", checked=True)
    assert torch.equal(back.full_tensor(), x)
    big = torch.full((16, 16), 2 ** 30, dtype=torch.int32)
    with pytest.raises(IntegerOverflowError):
        TK.dwt_fwd_2d_sharded(big, mesh, levels=2, scheme="97m", checked=True)
