"""The port's 2-D serve slice as a whole, against ``repro.serve``.

The same seeded requests go through ``repro_torch.serve`` on the CPU
(the kernels' plain versions) and through the reference engine; the
pyramids must be equal bit for bit, and every response must reconstruct
its request after the crop.  Also: the reference's retry, deadline and
load-shed semantics, and the refusals (no card, not-yet-ported routes).
"""
import numpy as np
import pytest
import torch

import jax

from repro import serve as RSV
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
from repro_torch.serve import (
    BucketScheduler,
    TransformRequest,
    WaveletServeEngine,
    crop_result,
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


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(buckets=BUCKETS, encode_response=True), "codec"),
        (dict(buckets=BUCKETS, checked=True), "checked ranges"),
        (dict(buckets=[(4, 16, 16)]), "3-D engine"),
        (dict(height=16, width=16, depth=4), "3-D engine"),
        (dict(buckets=BUCKETS, mesh=object()), "sharded"),
    ],
)
def test_unported_routes_raise_naming_the_roadmap_item(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        WaveletServeEngine(device="cpu", **kwargs)


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
