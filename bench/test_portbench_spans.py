"""The port's kernels spans on the device trace, on the CPU: the five
readers on a made-up trace (hand-worked numbers, none a measurement),
None where a run holds no span (a program without them), starved and
queued idle told apart, gaps named by the innermost port span, and a
real CPU profile's records on one base with the spans."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench import harness, spans
from repro_torch import kernels as K
from repro_torch import obs

NEW = ("dispatch.call_ms", "dispatch.prep_ms", "dispatch.launch_ms",
       "kernels.level1_device_ms", "device.idle_starved_pct")


def _read(name, ctx):
    return harness.load_file(harness.BENCH / "metrics" / f"{name}.py").read(ctx)


def _ctx():
    """One traced batch (us): a forward call with a level-1 tiled level and
    a level-2 chain run, then the inverse; one launch span a level."""
    lvl = lambda n, e, d: {"level": n, "engine": e, "direction": d}  # noqa: E731
    sp = [
        ("kernels.launch", 20.0, 30.0, {"fn": "repro_tiled_fwd"}),
        ("kernels.level", 10.0, 50.0, lvl(1, "tiled2d", "fwd")),
        ("kernels.launch", 70.0, 75.0, {"fn": "repro_whole2d_cluster_fwd"}),
        ("kernels.level", 60.0, 90.0, lvl(2, "whole2d", "fwd")),
        ("kernels.call", 0.0, 100.0, {"direction": "fwd"}),
        ("kernels.launch", 125.0, 130.0, {"fn": "repro_whole2d_cluster_inv"}),
        ("kernels.level", 120.0, 140.0, lvl(2, "whole2d", "inv")),
        ("kernels.launch", 160.0, 180.0, {"fn": "repro_tiled_inv"}),
        ("kernels.level", 150.0, 190.0, lvl(1, "tiled2d", "inv")),
        ("kernels.call", 110.0, 200.0, {"direction": "inv"}),
    ]
    runtime = [
        ("cudaLaunchKernel", 21.0, 29.0, 1),
        ("cudaLaunchKernelExC", 71.0, 74.0, 2),
        ("cudaLaunchKernelExC", 126.0, 129.0, 3),
        ("cudaLaunchKernel", 161.0, 179.0, 4),
        ("cudaEventSynchronize", 200.0, 400.0, 5),
        ("cudaLaunchKernel", 600.0, 605.0, 6),  # outside every span
    ]
    dev = [
        ("void tiled_fwd(int)", 30.0, 330.0, 1),
        ("void chain_fwd", 330.0, 340.0, 2),
        ("void chain_inv", 345.0, 355.0, 3),  # gap 340-345: launched at 126, queued
        ("void tiled_inv(int)", 355.0, 555.0, 4),
        ("void late", 610.0, 620.0, 6),  # gap 555-610: launched at 600, starved
    ]
    return {"spans": sp, "runtime": runtime, "device_ops": dev, "trace_batches": 1}


@pytest.mark.parametrize("name,want", [
    ("dispatch.call_ms", 0.190),  # 100 + 90 us
    ("dispatch.prep_ms", 0.090),  # levels 130 us less their launches 40
    ("dispatch.launch_ms", 0.040),
    ("kernels.level1_device_ms", 0.500),  # tiled_fwd 300 + tiled_inv 200 us
    ("device.idle_starved_pct", 55 / 590 * 100),  # window 30-620 us
])
def test_readers_on_a_made_up_trace(name, want):
    assert _read(name, _ctx()) == pytest.approx(want)
    two = _ctx()
    two["trace_batches"] = 2
    assert _read(name, two) == pytest.approx(want if name.endswith("_pct") else want / 2)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_spans(name):
    # the keys a round-trip run's ctx has, and no span
    ctx = {"submitted": 10, "window_batches": 9, "window_s": 1.0, "host_s": 0.01,
           "launches": {"tiled2d_fwd": 40}, "bytes_per_batch": 16, "trace": None,
           "trace_batches": 200}
    assert _read(name, ctx) is None
    assert _read(name, dict(_ctx(), spans=[])) is None


def test_new_readers_are_none_on_a_roundtrip_cpu_run():
    """The round-trip traffic puts no span in its ``ctx``: a run of it
    reads every new metric as absent, without error."""
    cell = harness.find_cell("jp3d.ct-512")
    cell.config.update(shape=[6, 8, 10], levels=2)
    cell.traffic.update(batch=2, check_span=2, trace_batches=3)
    out = harness.driver(cell).run(cell, 2**31 + 7, 0.1, True, torch.device("cpu"))
    assert all(_read(n, out["ctx"]) is None for n in NEW)
    assert _read("dispatch.host_ms", out["ctx"]) > 0


def test_launch_matching_and_levels():
    ctx = _ctx()
    assert spans.launch_match_share(ctx) == pytest.approx(4 / 5)
    levels = spans.level_of_launch(ctx)
    assert {c: v["level"] for c, v in levels.items()} == {1: 1, 2: 2, 3: 2, 4: 1}
    assert spans.launch_match_share(dict(ctx, runtime=ctx["runtime"][4:5])) is None


def test_starved_and_queued_gaps():
    window, gaps = spans.gaps(_ctx()["device_ops"])
    assert window == 590.0
    assert [(a, b) for a, b, _ in gaps] == [(340.0, 345.0), (555.0, 610.0)]
    launched_at = {r[3]: r[1] for r in _ctx()["runtime"]}
    assert [spans.starved(g, launched_at) for g in gaps] == [False, True]
    # an operation with no runtime call found is not counted as starved
    assert not spans.starved(gaps[1], {})


def test_gap_labels_name_the_innermost_port_span():
    ctx = _ctx()
    window, gaps = spans.gaps(ctx["device_ops"])
    # 340-345: the host is in cudaEventSynchronize (200-400): it keeps its name
    assert spans.label(gaps[0], ctx) == "cudaEventSynchronize before chain_inv (queued)"
    # 555-610: in no runtime call and no span
    assert spans.label(gaps[1], ctx) == "python before late (starved)"
    # the same gap while the host was inside a level's plans
    ctx["spans"].append(("kernels.call", 500.0, 700.0, {}))
    ctx["spans"].append(("kernels.level", 560.0, 640.0, {"level": 1}))
    assert spans.label(gaps[1], ctx) == "kernels.level before late (starved)"


def test_records_put_spans_and_ops_on_the_profiles_base():
    """A CPU profile of a round trip inside ``obs.tracing("kernels")``:
    every kept span lies inside the profile, and the aten ops of each
    public call lie inside its ``kernels.call`` span."""
    x = torch.randint(-128, 128, (2, 64, 64), dtype=torch.int32)
    obs.reset()
    with obs.tracing("kernels"):
        K.dwt_fwd_2d_multi(x, 2)  # recorded before the profile: left out
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            K.dwt_inv_2d_multi(K.dwt_fwd_2d_multi(x, 2))
    ctx = spans.records(prof, obs.tracer.spans(subsystem="kernels"))
    obs.reset()
    calls = spans.Intervals(ctx["spans"], "kernels.call")
    assert [s[3]["direction"] for s in calls.spans] == ["fwd", "inv"]
    assert not ctx["device_ops"]
    ops = [r for r in ctx["runtime"] if r[0].startswith("aten::")]
    assert ops and all(r[1] >= 0 for r in ops)
    # the profile holds nothing but the two calls
    assert all(calls.holding(r[1], r[2]) for r in ops)
