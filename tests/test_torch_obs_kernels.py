"""The kernels layer's spans (``kernels.call`` / ``kernels.level`` /
``kernels.launch``, ``repro_torch.obs.tracing("kernels")``) and the
tracer's clock, which is the ``torch.profiler`` trace's: off by default
and free when off, nested as the dispatch runs, one call span a public
call, and a span laid on a profile contains the op it timed."""
import ctypes
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels as K
from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.obs import _state
from repro_torch.obs import trace as T


@pytest.fixture(autouse=True)
def _fresh_tracer():
    obs.reset()
    yield
    obs.reset()


def _kernel_spans(name=None):
    return obs.tracer.spans(subsystem="kernels", name=name)


def _inside(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def _roundtrip_2d(levels=3):
    # 256^2 is past the whole-image budget (58,112 samples): level 1 is
    # tiled, levels 2-3 one whole-image chain
    x = torch.randint(-128, 128, (2, 256, 256), dtype=torch.int32)
    pyr = K.dwt_fwd_2d_multi(x, levels, mode="jpeg2000")
    assert torch.equal(K.dwt_inv_2d_multi(pyr, mode="jpeg2000"), x)


def _roundtrip_3d(levels=2):
    v = torch.randint(-2048, 2048, (2, 8, 16, 16), dtype=torch.int32)
    pyr = K.dwt_fwd_nd(v, levels, mode="jpeg2000")
    assert torch.equal(K.dwt_inv_nd(pyr, mode="jpeg2000"), v)


def test_kernels_spans_are_off_by_default_and_allocate_nothing(monkeypatch):
    assert _state.kernels is False

    def boom(*a, **k):
        raise AssertionError("a kernels span was made outside obs.tracing('kernels')")

    monkeypatch.setattr(T, "_Span", boom)
    monkeypatch.setattr(obs.tracer, "record", boom)
    _roundtrip_2d()
    _roundtrip_3d()
    assert obs.tracer.total == 0


def test_tracing_scope_restores_and_names_only_the_kernels_layer():
    with obs.tracing("kernels"):
        with obs.tracing("kernels"):
            assert _state.kernels
        assert _state.kernels
    assert _state.kernels is False
    with pytest.raises(ValueError):
        with obs.tracing("serve"):
            pass
    with pytest.raises(RuntimeError):
        with obs.tracing("kernels"):
            raise RuntimeError("boom")
    assert _state.kernels is False


def test_kernels_spans_follow_the_scope_not_repro_obs():
    with obs.disabled(), obs.tracing("kernels"):
        _roundtrip_2d(levels=1)
        with obs.span("serve.step", subsystem="serve"):
            pass
    assert len(_kernel_spans("kernels.call")) == 2
    assert not obs.tracer.spans(subsystem="serve")


def test_2d_round_trip_records_calls_around_levels():
    with obs.tracing("kernels"):
        _roundtrip_2d()
    calls = _kernel_spans("kernels.call")
    assert [c.args for c in calls] == [
        {"direction": "fwd", "ndim": 2, "levels": 3, "batch": 2},
        {"direction": "inv", "ndim": 2, "levels": 3, "batch": 2},
    ]
    levels = _kernel_spans("kernels.level")
    # one span a tiled level, one a whole-image chain run (its finest level)
    assert [s.args for s in levels] == [
        {"level": 1, "engine": "tiled2d", "direction": "fwd"},
        {"level": 2, "engine": "whole2d", "direction": "fwd"},
        {"level": 2, "engine": "whole2d", "direction": "inv"},
        {"level": 1, "engine": "tiled2d", "direction": "inv"},
    ]
    for s in levels:
        (owner,) = [c for c in calls if _inside(s, c)]
        assert owner.args["direction"] == s.args["direction"]


@pytest.mark.parametrize("slab", [False, True], ids=["whole3d", "slab3d"])
def test_3d_round_trip_records_calls_around_levels(monkeypatch, slab):
    if slab:
        monkeypatch.setenv("REPRO_DWT_SLAB", "4")
    with obs.tracing("kernels"):
        _roundtrip_3d()
    calls = _kernel_spans("kernels.call")
    assert [c.args for c in calls] == [
        {"direction": "fwd", "ndim": 3, "levels": 2, "batch": 2},
        {"direction": "inv", "ndim": 3, "levels": 2, "batch": 2},
    ]
    engine = "slab3d" if slab else "whole3d"
    levels = _kernel_spans("kernels.level")
    assert [(s.args["level"], s.args["direction"]) for s in levels] == [
        (1, "fwd"), (2, "fwd"), (2, "inv"), (1, "inv")]
    assert {s.args["engine"] for s in levels} == {engine}
    for s in levels:
        assert sum(_inside(s, c) for c in calls) == 1


@pytest.mark.parametrize("route", ["nd-2d", "checked-2d", "checked-3d", "nd-2d-checked"])
def test_nested_public_calls_record_one_call_span(route):
    x = torch.randint(-128, 128, (3, 32, 32), dtype=torch.int32)
    v = torch.randint(-128, 128, (2, 8, 8, 8), dtype=torch.int32)
    with obs.tracing("kernels"):
        if route == "nd-2d":
            pyr = K.dwt_fwd_nd(x, 2, ndim=2)
            back = K.dwt_inv_nd(pyr)
        elif route == "checked-2d":
            pyr = K.dwt_fwd_2d_multi(x, 2, checked=True)
            back = K.dwt_inv_2d_multi(pyr, checked=True)
        elif route == "checked-3d":
            x = v
            pyr = K.dwt_fwd_nd(v, 2, checked=True)
            back = K.dwt_inv_nd(pyr, checked=True)
        else:
            pyr = K.dwt_fwd_nd(x, 2, ndim=2, checked=True)
            back = K.dwt_inv_nd(pyr, checked=True)
    assert torch.equal(back, x)
    ndim = x.ndim - 1
    assert [c.args for c in _kernel_spans("kernels.call")] == [
        {"direction": "fwd", "ndim": ndim, "levels": 2, "batch": x.shape[0]},
        {"direction": "inv", "ndim": ndim, "levels": 2, "batch": x.shape[0]},
    ]


class _Lib:
    """A stand-in for a loaded kernel library: each launcher returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.repro_error_string = lambda rc: b"stand-in error"

    def __getattr__(self, fn):
        return lambda *args: self.rc


def test_launch_span_wraps_the_launcher_call(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda name: _Lib())
    monkeypatch.setattr(_build, "current_stream_handle", lambda device: 0)
    room = ctypes.c_int(0)
    _build.call("whole2d", "repro_whole2d_cluster_room", (0, 2, 0, ctypes.addressof(room)))
    assert not _kernel_spans()
    with obs.tracing("kernels"):
        t0 = time.time_ns()
        _build.launch("tiled2d", "repro_tiled_fwd", 0, [None, 0], [1, 2])
        t1 = time.time_ns()
    (span,) = _kernel_spans("kernels.launch")
    assert span.args == {"fn": "repro_tiled_fwd"}
    assert t0 <= span.start_ns <= span.end_ns <= t1
    monkeypatch.setattr(_build, "library", lambda name: _Lib(rc=700))
    with obs.tracing("kernels"), pytest.raises(_build.KernelLaunchError):
        _build.call("tiled2d", "repro_tiled_inv", ())
    assert [s.args["fn"] for s in _kernel_spans("kernels.launch")] == [
        "repro_tiled_fwd", "repro_tiled_inv"]


def test_spans_lie_on_the_profilers_clock():
    """A span converted to a profile's base (``trace_start_ns``) contains
    the ``aten::add`` the profiler recorded inside it, as
    ``bench``'s readers lay kernels spans on the device trace."""
    tracer = obs.Tracer()
    x = torch.ones(1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with tracer.record("t.add", "t"):
                torch.add(x, x)
    base = prof.profiler.kineto_results.trace_start_ns()
    adds = [e for e in prof.events() if e.name == "aten::add"]
    spans = tracer.spans()
    assert len(adds) == len(spans) == 20
    for s, e in zip(spans, adds):
        assert (s.start_ns - base) / 1e3 <= e.time_range.start
        assert e.time_range.end <= (s.end_ns - base) / 1e3


def test_unix_offset_matches_the_wall_clock():
    off = T.unix_offset_ns()
    a = time.time_ns()
    b = time.perf_counter_ns() + off
    c = time.time_ns()
    assert a - 50_000 <= b <= c + 50_000


def test_chrome_export_keeps_origin_relative_microseconds():
    tracer = obs.Tracer()
    with tracer.record("k.l", "kernels", level=1):
        time.sleep(0.002)
    (ev,) = tracer.export_chrome_trace()["traceEvents"]
    (rec,) = tracer.spans()
    assert ev["ts"] == round((rec.start_ns - tracer.origin_ns) / 1e3, 3) >= 0
    assert ev["dur"] >= 2000 and ev["args"] == {"level": 1} and ev["cat"] == "kernels"
