"""The port's 2-D serve slice as a whole, against ``repro.serve``.

The same seeded requests go through ``repro_torch.serve`` on the CPU
(the kernels' plain versions) and through the reference engine; the
pyramids must be equal bit for bit, and every response must reconstruct
its request after the crop.  Also: the reference's retry, deadline and
load-shed semantics, and the refusals (no card, not-yet-ported routes).
With ``encode_response=True`` the per-batch WZRC containers must be the
reference engine's byte for byte, and the progressive tiers its tiers.
"""
import warnings

import numpy as np
import pytest
import torch

import jax

from repro import codec as RCODEC
from repro import serve as RSV
from repro.resilience import inject as RINJ
from repro_torch import codec as TCODEC
from repro_torch import serve as TSV
from repro_torch import kernels as TK
from repro_torch import obs
from repro_torch.resilience import inject
from repro_torch.resilience.errors import (
    DeadlineExceededError,
    LoadShedError,
    ResilienceWarning,
    RetryExhaustedError,
    RetryWarning,
)
from repro_torch.kernels import _build
from repro_torch.serve import (
    BucketScheduler,
    ProgressiveServeRoute,
    TransformRequest,
    WaveletServeEngine,
    crop_result,
    tier_shape,
)

BUCKETS = [(16, 16), (32, 32)]


def _requests(mod, seed=0, n=10):
    rng = np.random.default_rng(seed)
    shapes = [(16, 16), (32, 32), (10, 12), (32, 20), (16, 16), (5, 31), (32, 32),
              (17, 3), (2, 2), (16, 9)]
    return [
        mod.TransformRequest(uid=i, image=rng.integers(-128, 128, shapes[i % len(shapes)],
                                                      dtype=np.int32))
        for i in range(n)
    ]


@pytest.fixture(autouse=True)
def _disarm():
    inject.reset()
    yield
    inject.reset()


@pytest.mark.parametrize("scheme,mode", [("cdf53", "jpeg2000"), ("97m", "paper"),
                                         ("cdf22", "paper"), ("haar", "jpeg2000")])
def test_engine_matches_reference_engine(scheme, mode):
    port = WaveletServeEngine(buckets=BUCKETS, batch_slots=4, levels=2, scheme=scheme,
                              mode=mode, device="cpu")
    ref = RSV.WaveletServeEngine(buckets=BUCKETS, batch_slots=4, levels=2, scheme=scheme,
                                 mode=mode)
    assert port.warmup() == 2 and ref.warmup() == 2
    got = sorted(port.run(_requests(TSV)), key=lambda r: r.uid)
    want = sorted(ref.run(_requests(RSV)), key=lambda r: r.uid)
    assert [r.uid for r in got] == [r.uid for r in want] == list(range(10))
    for g, w in zip(got, want):
        assert g.done and g.error is None and g.bucket == w.bucket and g.padded == w.padded
        gl = [g.pyramid.ll] + [b for lvl in g.pyramid.details for b in lvl]
        wl = jax.tree_util.tree_leaves(w.pyramid)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        xr = crop_result(TK.dwt_inv_2d_multi(g.pyramid, scheme=scheme, mode=mode), g)
        np.testing.assert_array_equal(xr.numpy(), g.image)
    # one callable per bucket, reused for every batch
    assert port.executor.misses == port.executor.compiles == 2
    assert port.executor.hits > 0


def test_default_engine_refuses_to_serve_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    eng = WaveletServeEngine(buckets=BUCKETS)
    assert eng.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        eng.warmup()
    req = _requests(TSV, n=1)[0]
    eng.submit(req)
    with pytest.raises(RuntimeError, match="is_available"):
        eng.step()
    assert eng.scheduler.pending() == 1 and not req.done  # nothing lost


MESH = object()  # stands for a real one-rank mesh where the engine needs one


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat

    init = tmp_path_factory.mktemp("rendezvous") / "file"
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=1, rank=0)
    try:
        yield make_mesh_compat((1,), ("data",), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(buckets=[(4, 16, 16)], mesh=MESH), "sharded"),
        (dict(height=16, width=16, depth=4, mesh=MESH), "sharded"),
        (dict(buckets=BUCKETS, mesh=MESH), "sharded"),
    ],
)
def test_unported_routes_raise_naming_the_roadmap_item(kwargs, item, one_rank_mesh):
    """The sharded route (``mesh=``), ported: volume buckets with a mesh
    raise the reference's ``ValueError`` (the route is 2-D only); 2-D
    buckets with a mesh construct and serve the mesh-less engine's
    pyramids and WZRC bytes."""
    rest = {k: v for k, v in kwargs.items() if k != "mesh"}
    if rest.get("buckets") != BUCKETS:
        with pytest.raises(ValueError, match="2D-only") as port:
            WaveletServeEngine(device="cpu", mesh=one_rank_mesh, **rest)
        with pytest.raises(ValueError, match="2D-only") as ref:
            RSV.WaveletServeEngine(mesh=object(), **rest)
        assert str(port.value) == str(ref.value) and item in str(port.value)
        WaveletServeEngine(device="cpu", **rest)
        return
    engines = [WaveletServeEngine(device="cpu", encode_response=True, mesh=m, **rest)
               for m in (one_rank_mesh, None)]
    assert engines[0].warmup() == len(BUCKETS)
    done = [eng.run(_requests(TSV)) for eng in engines]
    assert len(done[0]) == len(done[1]) == 10
    for a, b in zip(*done):
        assert a.uid == b.uid and a.encoded == b.encoded and a.batch_index == b.batch_index
        for x, y in zip(_leaves(a.pyramid), _leaves(b.pyramid)):
            assert not hasattr(x, "placements") and torch.equal(x, y)
    with pytest.raises(ValueError, match="divisible"):  # check_shardable at construction
        WaveletServeEngine(device="cpu", mesh=one_rank_mesh, buckets=[(12, 16)], levels=3)


def _leaves(pyr):
    return [pyr.ll] + [b for lvl in pyr.details for b in lvl]


def test_mesh_signature_matches_reference(one_rank_mesh):
    from jax.sharding import Mesh

    ref = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    from repro_torch.launch.mesh import make_mesh_compat

    port = make_mesh_compat((1, 1), ("data", "model"), "cpu")
    assert TSV.mesh_signature(port) == RSV.mesh_signature(ref) == (("data", 1), ("model", 1))
    assert TSV.mesh_signature(one_rank_mesh) == (("data", 1),)
    assert TSV.mesh_signature(None) is RSV.mesh_signature(None) is None
    eng = WaveletServeEngine(device="cpu", mesh=one_rank_mesh, buckets=BUCKETS)
    assert eng._exec_key(BUCKETS[0]).mesh_axes == (("data", 1),)


@pytest.mark.parametrize("scheme,mode", [("cdf53", "jpeg2000"), ("97m", "paper")])
def test_checked_submit_rejects_what_the_reference_rejects(scheme, mode, monkeypatch):
    """``checked=True`` (and ``REPRO_DWT_CHECKED=1``) certify a request at
    submit: samples inside the certificate are admitted and served
    bit-exact, one step outside on both sides raises
    IntegerOverflowError, and every case has the reference's outcome on
    the same image."""
    from repro.core import ranges as RRANGES

    levels = 2
    cert = RRANGES.range_certificate(scheme, levels, np.int32, mode=mode, ndim=2)
    rng = np.random.default_rng(31)
    engines = {}
    # the certificate is the widest safe SYMMETRIC interval: one step out
    # on both sides must raise; one side alone is held to the reference
    for lo, hi, want in ((cert.lo, cert.hi, "ok"),
                         (cert.lo - 1, cert.hi + 1, "IntegerOverflowError"),
                         (cert.lo, cert.hi + 1, None), (cert.lo - 1, cert.hi, None)):
        img = rng.integers(-100, 100, (16, 16)).astype(np.int64)
        img[0, 0], img[3, 5] = lo, hi
        img = img.astype(np.int32)
        outcomes = []
        for mod, kw in ((RSV, {}), (TSV, dict(device="cpu"))):
            for flag in (True, None):
                if flag is None:
                    monkeypatch.setenv("REPRO_DWT_CHECKED", "1")
                eng = mod.WaveletServeEngine(buckets=BUCKETS, levels=levels, scheme=scheme,
                                             mode=mode, checked=flag, **kw)
                engines[(mod, flag)] = eng
                try:
                    eng.submit(mod.TransformRequest(uid=0, image=img))
                    outcomes.append("ok")
                except Exception as e:  # noqa: BLE001 - the outcome IS the comparison
                    outcomes.append(type(e).__name__)
                monkeypatch.delenv("REPRO_DWT_CHECKED", raising=False)
        want = want or outcomes[0]
        assert outcomes == [want] * 4, (lo, hi, outcomes)
        if want == "ok":
            (req,) = engines[(TSV, True)].step()
            xr = TK.dwt_inv_2d_multi(req.pyramid, mode=mode, scheme=scheme, checked=True)
            np.testing.assert_array_equal(crop_result(xr, req).numpy(), img)


def test_engine_validates_like_reference():
    with pytest.raises(ValueError, match="batch_slots"):
        WaveletServeEngine(buckets=BUCKETS, batch_slots=0, device="cpu")
    with pytest.raises(ValueError, match="unknown lifting scheme"):
        WaveletServeEngine(buckets=BUCKETS, scheme="db4", device="cpu")
    with pytest.raises(ValueError, match="too small"):
        WaveletServeEngine(buckets=[(4, 4)], levels=3, device="cpu")
    eng = WaveletServeEngine(height=16, width=16, device="cpu")
    assert eng.bucket_shape == (16, 16)
    with pytest.raises(TypeError, match="integer"):
        eng.submit(TransformRequest(uid=0, image=np.zeros((4, 4), np.float32)))
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(TransformRequest(uid=0, image=np.zeros((17, 4), np.int32)))


def test_retry_recovers_then_exhaustion_requeues():
    eng = WaveletServeEngine(buckets=BUCKETS, batch_slots=2, levels=1, device="cpu",
                             retry_backoff_s=0.0)
    reqs = _requests(TSV, n=2)
    for r in reqs:
        eng.submit(r)
    inject.arm("serve.transform", inject.Fault(at_call=1, times=1))
    with pytest.warns(RetryWarning):
        done = eng.step()
    assert [r.uid for r in done] == [0] and done[0].done
    assert not issubclass(ResilienceWarning, RuntimeWarning)
    inject.arm("serve.transform", inject.Fault(at_call=1, times=None))
    with pytest.warns(RetryWarning), pytest.raises(RetryExhaustedError):
        eng.step()
    assert eng.scheduler.pending() == 1  # re-queued, not lost
    inject.reset()
    assert [r.uid for r in eng.step()] == [1]


def test_load_shed_and_deadline():
    eng = WaveletServeEngine(buckets=BUCKETS, max_queue=2, deadline_s=0.0, device="cpu")
    reqs = _requests(TSV, n=3)
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    with pytest.raises(LoadShedError):
        eng.submit(reqs[2])
    out = eng.step()
    assert {r.uid for r in out} == {0, 1}
    assert all(isinstance(r.error, DeadlineExceededError) and not r.done for r in out)


def test_scheduler_is_the_reference_scheduler():
    port, ref = BucketScheduler([(64, 64), (16, 16), (32, 32)]), RSV.BucketScheduler(
        [(64, 64), (16, 16), (32, 32)])
    assert port.buckets == ref.buckets
    for shape in [(16, 16), (17, 8), (16, 33), (64, 1)]:
        assert port.route(shape) == ref.route(shape)
    for bad in [(65, 2), (16, 16, 16)]:
        with pytest.raises(ValueError):
            port.route(bad)


def test_serve_reports_to_the_ports_own_obs():
    obs.reset()
    eng = WaveletServeEngine(buckets=BUCKETS, batch_slots=4, levels=2, device="cpu")
    eng.run(_requests(TSV, n=5))
    snap = obs.snapshot()
    assert snap["metrics"]["serve.requests_served"] == 5
    assert {"serve"} <= obs.subsystems()
    assert snap["spans"]["subsystems"].get("serve", 0) > 0


def test_crop_result_keeps_tensors_on_their_device():
    req = TransformRequest(uid=0, image=np.zeros((3, 5), np.int32))
    t = torch.arange(64, dtype=torch.int32).reshape(8, 8)
    assert isinstance(crop_result(t, req), torch.Tensor)
    assert crop_result(t, req).shape == (3, 5)
    assert crop_result(t.numpy(), req).shape == (3, 5)


# ---------------------------------------------------------------------------
# The encoded-response route.
# ---------------------------------------------------------------------------


def _encoded_pair(scheme="cdf53", mode="jpeg2000", slots=4, levels=2, n=10):
    port = WaveletServeEngine(buckets=BUCKETS, batch_slots=slots, levels=levels, scheme=scheme,
                              mode=mode, device="cpu", encode_response=True)
    ref = RSV.WaveletServeEngine(buckets=BUCKETS, batch_slots=slots, levels=levels,
                                 scheme=scheme, mode=mode, encode_response=True)
    got = sorted(port.run(_requests(TSV, n=n)), key=lambda r: r.uid)
    want = sorted(ref.run(_requests(RSV, n=n)), key=lambda r: r.uid)
    return port, got, want


@pytest.mark.parametrize("scheme,mode", [("cdf53", "jpeg2000"), ("97m", "paper")])
def test_encoded_engine_containers_equal_the_reference(scheme, mode):
    # 10 requests in 4 slots over two buckets: undersized requests and a
    # partial last batch per bucket
    port, got, want = _encoded_pair(scheme, mode)
    assert any(r.padded for r in got)
    assert [r.uid for r in got] == [r.uid for r in want]
    batches = set()
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        assert g.encoded == w.encoded and g.batch_index == w.batch_index
        batches.add((id(g.encoded), g.bucket))
        row = TCODEC.decode_batch(g.encoded, device="cpu")[g.batch_index]
        for a, b in zip([row.ll] + [t for lvl in row.details for t in lvl],
                        [g.pyramid.ll] + [t for lvl in g.pyramid.details for t in lvl]):
            assert torch.equal(a, b)
        xr = crop_result(TK.dwt_inv_2d_multi(row, scheme=scheme, mode=mode), g)
        np.testing.assert_array_equal(xr.numpy(), g.image)
    # one shared container object per micro-batch, holding only live rows
    assert len(batches) == len({(id(w.encoded), w.bucket) for w in want})
    for g in got:
        assert TCODEC.peek(g.encoded)["lead"][0] == sum(
            1 for o in got if o.encoded is g.encoded)


def test_encoded_engine_degrades_and_quarantines_like_the_reference():
    def run(mod, inj, faults):
        eng = mod.WaveletServeEngine(buckets=[(16, 16)], batch_slots=3, levels=1,
                                     encode_response=True,
                                     **({"device": "cpu"} if mod is TSV else {}))
        for r in _requests(mod, n=3)[:3]:
            r.image = r.image[:16, :16]
            eng.submit(r)
        inj.reset()
        for site, fault in faults:
            inj.arm(site, fault)
        try:
            return sorted(eng.step(), key=lambda r: r.uid)
        finally:
            inj.reset()

    obs.reset()
    for faults in (
        [("serve.encode_batch", dict(times=1))],
        [("serve.encode_batch", dict(times=1)), ("serve.encode", dict(at_call=2, times=1))],
    ):
        with pytest.warns(ResilienceWarning):
            got = run(TSV, inject, [(s, inject.Fault(**f)) for s, f in faults])
        want = run(RSV, RINJ, [(s, RINJ.Fault(**f)) for s, f in faults])
        for g, w in zip(got, want):
            assert g.encoded == w.encoded and g.batch_index == w.batch_index is None
            assert type(g.error).__name__ == type(w.error).__name__
            if g.encoded is not None:
                dec = TCODEC.decode_pyramid(g.encoded, device="cpu")
                assert dec.lead == () and torch.equal(dec.pyramid.ll, g.pyramid.ll)
    assert [r.error is not None for r in got] == [False, True, False]
    snap = obs.snapshot()["metrics"]
    assert snap["serve.encode_degrades"] == 2 and snap["serve.encode_quarantines"] == 1


# an asynchronous CUDA fault surfaces as torch's RuntimeError at the next sync
_ASYNC_FAULT = "CUDA error: an illegal memory access was encountered"


@pytest.mark.parametrize("err", [_build.KernelBuildError, _build.KernelLaunchError, RuntimeError])
def test_kernel_faults_in_the_encode_propagate(monkeypatch, err):
    from repro_torch.codec import rice

    def broken(bands):
        raise err(_ASYNC_FAULT if err is RuntimeError else "rice kernel broke")

    # batch_fault: the batch encode degrades first, and the kernel fault
    # then hits the per-request encode
    for batch_fault in (False, True):
        eng = WaveletServeEngine(buckets=BUCKETS, batch_slots=2, levels=1, device="cpu",
                                 encode_response=True)
        reqs = _requests(TSV, n=5)[::4]  # two 16x16 requests: one batch
        for r in reqs:
            eng.submit(r)
        monkeypatch.setattr(rice, "encode_bands", broken)
        obs.reset()
        inject.reset()
        if batch_fault:
            inject.arm("serve.encode_batch", inject.Fault(times=1))
        with pytest.raises(err), warnings.catch_warnings():
            warnings.simplefilter("ignore", ResilienceWarning)
            eng.step()
        inject.reset()
        metrics = obs.snapshot()["metrics"]
        assert metrics.get("serve.encode_degrades", 0) == int(batch_fault)
        assert metrics.get("serve.encode_quarantines", 0) == 0
        for r in reqs:  # not served without bytes, and not lost: back in the queue
            assert r.encoded is None and r.pyramid is None and r.error is None
            assert not r.done
        monkeypatch.undo()
        done = eng.run([])
        assert [r.uid for r in done] == [r.uid for r in reqs]
        assert all(r.done and r.encoded is not None for r in done)


def test_device_errors_become_kernel_launch_errors():
    with pytest.raises(_build.KernelLaunchError, match="payload to host: CUDA error"):
        with _build.device_errors("payload to host"):
            raise RuntimeError(_ASYNC_FAULT)
    with pytest.raises(ValueError):  # anything else passes through unchanged
        with _build.device_errors("payload to host"):
            raise ValueError("not a device fault")
    assert _build.is_kernel_fault(RuntimeError(_ASYNC_FAULT))
    assert not _build.is_kernel_fault(RuntimeError("shape mismatch"))


def test_encoded_engine_warmup_runs_the_rice_coder(monkeypatch):
    from repro_torch.codec import rice

    calls = []
    real = rice.encode_band
    monkeypatch.setattr(rice, "encode_band", lambda x: calls.append(x.numel()) or real(x))
    eng = WaveletServeEngine(buckets=BUCKETS, levels=1, device="cpu", encode_response=True)
    assert eng.warmup() == 2 and calls
    calls.clear()
    WaveletServeEngine(buckets=BUCKETS, levels=1, device="cpu").warmup()
    assert not calls


def test_route_tiers_equal_the_reference_route():
    port, got, want = _encoded_pair(levels=2)
    rt, rr = ProgressiveServeRoute(device="cpu"), RSV.ProgressiveServeRoute()
    for g, w in zip(got, want):
        rt.store(g)
        rr.store(w)
    for g in got:
        assert rt.tiers(g.uid) == rr.tiers(g.uid)
        thumb = rt.thumbnail(g.uid)
        assert isinstance(thumb, torch.Tensor) and thumb.device.type == "cpu"
        np.testing.assert_array_equal(thumb.numpy(), rr.thumbnail(g.uid))
        assert tuple(thumb.shape) == tier_shape(g.image.shape, 2, 0)
        np.testing.assert_array_equal(rt.refine(g.uid, 1).numpy(), rr.refine(g.uid, 1))
        np.testing.assert_array_equal(rt.full(g.uid).numpy(), g.image)
    with pytest.raises(ValueError, match="no encoded response"):
        rt.store(TransformRequest(uid=99, image=np.zeros((4, 4), np.int32)))
    with pytest.raises(KeyError, match="no stored response"):
        rt.thumbnail(1234)
    blob = RCODEC.encode_pyramid(want[0].pyramid, mode="jpeg2000")  # a single-request blob
    rt.put(500, blob)
    rr.put(500, blob)
    np.testing.assert_array_equal(rt.full(500).numpy(), rr.full(500))
