"""Lay the port's kernels spans on the profiler's device trace.

Inside ``obs.tracing("kernels")`` the port records three spans in Unix
nanoseconds, the time base of ``torch.profiler``'s kineto events:
``kernels.call`` (a public transform), ``kernels.level`` (one level, or
one whole-level chain run: ``level``, 1 the finest, and ``engine``) and
``kernels.launch`` (an exported launcher's call: ``fn``).  :func:`records`
puts a finished profile's records and those spans on the profile's
microsecond base (``trace_start_ns``), as the per-layer readers
``dispatch.call_ms``, ``dispatch.prep_ms``, ``dispatch.launch_ms``,
``kernels.level1_device_ms`` and ``device.idle_starved_pct`` read them
from a run's ``ctx``:

  * ``spans``: ``(name, start_us, end_us, attrs)`` of each kernels span;
  * ``device_ops``: ``(name, start_us, end_us, correlation)`` of each
    operation the card ran;
  * ``runtime``: the same of each CUDA runtime call; a launch call
    (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, a copy) shares its
    correlation id with the device operation it enqueued.

Where ``ctx`` holds no spans (a program without them, or a run that
records none) every reader returns None.

Run as a script, it measures those metrics for one cell on the card (the
cell's set-up and loop, ``bench/drivers/roundtrip.py``): untraced and
traced host time a batch (the spans' cost), then two profiles of CUDA
activity with the spans on, the first discarded; it prints one JSON
line, with the share of launch calls that lie inside a ``kernels.launch``
span and the longest gaps named by the innermost port span::

    python3 bench/spans.py --workload <cell> --seed <n> [--batches 200]
"""
from __future__ import annotations

import bisect
import json
import pathlib
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

Record = Tuple[str, float, float, int]  # name, start_us, end_us, correlation
Span = Tuple[str, float, float, dict]  # name, start_us, end_us, attrs

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC")


def records(prof, spans) -> Dict[str, list]:
    """``spans``, ``device_ops`` and ``runtime`` of a finished profile and
    the kernels spans (``obs.SpanRecord``) recorded during it, on the
    profile's microsecond base."""
    kineto = prof.profiler.kineto_results
    base = kineto.trace_start_ns()
    dev: List[Record] = []
    runtime: List[Record] = []
    for ev in kineto.events():
        rec = (ev.name(), (ev.start_ns() - base) / 1e3, (ev.end_ns() - base) / 1e3,
               int(ev.correlation_id()))
        (dev if str(ev.device_type()).endswith("CUDA") else runtime).append(rec)
    kept = [(s.name, (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3, s.args)
            for s in spans if s.start_ns >= base]
    return {"spans": kept, "device_ops": dev, "runtime": runtime}


class Intervals:
    """Spans of one name, sorted by start, none overlapping another (the
    kernels spans of one thread; nested ones have other names)."""

    def __init__(self, spans: Sequence[Span], name: str):
        self.spans = sorted((s for s in spans if s[0] == name), key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]

    def total_ms(self) -> float:
        return sum(b - a for _, a, b, _ in self.spans) / 1e3

    def holding(self, a: float, b: float) -> Optional[Span]:
        """The span that holds ``[a, b]``, or None."""
        i = bisect.bisect_right(self.starts, a) - 1
        return self.spans[i] if i >= 0 and self.spans[i][2] >= b else None


def traced_batches(ctx: dict) -> int:
    """Round trips under the profile whose spans ``ctx`` holds; 0 where it
    holds no kernels span."""
    return ctx.get("trace_batches", 0) if ctx.get("spans") else 0


def level_of_launch(ctx: dict) -> Dict[int, dict]:
    """Each runtime call's correlation id -> the attrs of the
    ``kernels.level`` span around the ``kernels.launch`` span the call
    lies in (calls outside such a pair are left out)."""
    launches = Intervals(ctx["spans"], "kernels.launch")
    levels = Intervals(ctx["spans"], "kernels.level")
    out = {}
    for _, a, b, corr in ctx["runtime"]:
        launch = launches.holding(a, b)
        level = launch and levels.holding(launch[1], launch[2])
        if level:
            out[corr] = level[3]
    return out


def launch_match_share(ctx: dict) -> Optional[float]:
    """Share of the ``cudaLaunchKernel*`` calls that lie inside a
    ``kernels.launch`` span."""
    calls = [r for r in ctx["runtime"] if r[0] in LAUNCH_CALLS]
    if not calls:
        return None
    launches = Intervals(ctx["spans"], "kernels.launch")
    return sum(launches.holding(a, b) is not None for _, a, b, _ in calls) / len(calls)


def gaps(device_ops: Sequence[Record]) -> Tuple[float, List[Tuple[float, float, Record]]]:
    """The window's length in us (first device start to last end) and its
    idle gaps ``(start, end, the first device operation after it)``."""
    ops = sorted(device_ops, key=lambda r: r[1])
    out = []
    end = ops[0][2]
    for op in ops[1:]:
        if op[1] > end:
            out.append((end, op[1], op))
        end = max(end, op[2])
    return end - ops[0][1], out


def starved(gap: Tuple[float, float, Record], launched_at: Dict[int, float]) -> bool:
    """True where the runtime call that enqueued the operation ending the
    gap started after the card ran dry: the host held the card up.
    Otherwise (launched before, or no call found) the work was queued and
    the idle is on the device's side."""
    a, _, op = gap
    return op[3] in launched_at and launched_at[op[3]] > a


def _innermost(recs, t: float):
    return min((r for r in recs if r[1] <= t <= r[2]), key=lambda r: r[2] - r[1], default=None)


def label(gap: Tuple[float, float, Record], ctx: dict) -> str:
    """What the host was in at the gap's middle (the innermost CUDA
    runtime call, else the innermost port span, else "python"), what
    ended the gap, and whether the card was starved or the work queued."""
    a, b, op = gap
    mid = (a + b) / 2
    inner = _innermost(ctx["runtime"], mid) or _innermost(ctx["spans"], mid)
    kind = "starved" if starved(gap, {r[3]: r[1] for r in ctx["runtime"]}) else "queued"
    what = inner[0][:60] if inner else "python"
    return f"{what} before {op[0].removeprefix('void ').split('(')[0][:60]} ({kind})"


# ---------------------------------------------------------------------------
# The script: one cell's spans on the card.
# ---------------------------------------------------------------------------


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _span_cost_us(obs, n: int = 20000) -> Dict[str, float]:
    """Host us of an empty span site with the kernels switch on (a span
    recorded into a tracer of its own) and off (one flag read, ``NULL``)."""
    import time

    tracer = obs.Tracer(capacity=n)
    out = {}
    for arm in ("on", "off", "bare"):
        on = arm == "on"
        t0 = time.perf_counter()
        if arm == "bare":
            for _ in range(n):
                pass
        else:
            for _ in range(n):
                with (tracer.record("kernels.level", "kernels", level=1, engine="tiled2d",
                                    direction="fwd") if on else obs.NULL):
                    pass
        out[arm] = (time.perf_counter() - t0) / n * 1e6
    return out


def _gc_summary(pauses) -> Dict[int, Tuple[int, float, float]]:
    out: Dict[int, Tuple[int, float, float]] = {}
    for g, a, b in pauses:
        n, total, longest = out.get(g, (0, 0.0, 0.0))
        out[g] = (n + 1, total + (b - a) * 1e3, max(longest, (b - a) * 1e3))
    return out


def _outside_levels_ms(ctx: dict, batches: int) -> Dict[str, float]:
    """Host ms a batch inside ``kernels.call`` spans and outside their
    ``kernels.level`` spans, by direction."""
    calls = Intervals(ctx["spans"], "kernels.call")
    out = {c[3]["direction"]: 0.0 for c in calls.spans}
    for c in calls.spans:
        out[c[3]["direction"]] += (c[2] - c[1]) / 1e3 / batches
    for lvl in Intervals(ctx["spans"], "kernels.level").spans:
        c = calls.holding(lvl[1], lvl[2])
        if c:
            out[c[3]["direction"]] -= (lvl[2] - lvl[1]) / 1e3 / batches
    return out


def main(argv=None) -> None:
    import argparse
    import gc
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench import devtrace, harness
    from repro_torch import obs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=0, help="traced round trips (the mix's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench/spans.py: no CUDA card", file=sys.stderr)
        sys.exit(3)
    if not hasattr(obs, "tracing"):
        print("bench/spans.py: this program records no kernels spans", file=sys.stderr)
        sys.exit(3)
    device = torch.device("cuda", 0)
    cell = harness.find_cell(args.workload)
    t = cell.traffic
    batches = args.batches or t["trace_batches"]
    drv = harness.driver(cell)
    fwd, inv = drv.transforms(cell.config)
    pool = drv.make_pool(cell, args.seed, device)

    def loop(n: int):
        out = drv._Loop(pool, fwd, inv, t["in_flight"], device).run(batches=n)
        torch.cuda.synchronize(device)
        return out

    loop(len(pool) + t["in_flight"] + 1)  # warm-up: builds, plans, allocator
    # host ms a batch inside the public calls, spans off and on, in turns
    host = {"off": [], "on": []}
    for _ in range(5):
        for arm in ("off", "on"):
            if arm == "on":
                before = obs.tracer.total
                with obs.tracing("kernels"):
                    lp = loop(batches)
                recorded = obs.tracer.total - before
                spans_a_batch = recorded / lp.submitted
                # the same split without the profiler, on the tracer's own base
                unprofiled = {"trace_batches": lp.submitted, "spans": [
                    (r.name, r.start_ns / 1e3, r.end_ns / 1e3, r.args)
                    for r in obs.tracer.spans(subsystem="kernels")[-recorded:]]}
            else:
                lp = loop(batches)
            host[arm].append(lp.host_s / lp.submitted * 1e3)
    # two profiles with the spans on; the first is discarded (its profiler
    # start-up leaves the card idle) and its parsed events collected, so
    # that the collector's pass over them does not fall in the kept one
    pauses: List[Tuple[int, float, float]] = []  # the collector's: generation, start, end

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            on_gc.t0 = time.perf_counter()
        else:
            pauses.append((info["generation"], on_gc.t0, time.perf_counter()))

    gc.callbacks.append(on_gc)
    with obs.tracing("kernels"), profile(activities=[ProfilerActivity.CUDA]):
        loop(batches)
    gc.collect()
    before = obs.tracer.total
    t_kept = time.perf_counter()
    with obs.tracing("kernels"), profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = loop(batches).submitted
    t_kept = (t_kept, time.perf_counter())
    recorded = obs.tracer.total - before
    ctx = records(prof, obs.tracer.spans(subsystem="kernels"))
    if len(ctx["spans"]) != recorded:
        raise RuntimeError(f"{recorded} spans recorded, {len(ctx['spans'])} in the ring")
    ctx.update(trace_batches=traced, trace=devtrace.summarise(*devtrace.from_profiler(prof)))
    def read(name: str, c: dict):
        return harness.load_file(harness.BENCH / "metrics" / f"{name}.py").read(c)

    split = ("dispatch.call_ms", "dispatch.prep_ms", "dispatch.launch_ms")
    metrics = {n: read(n, ctx) for n in split + (
        "kernels.level1_device_ms", "device.idle_starved_pct", "kernels.device_ms",
        "device.idle_pct")}
    window, found = gaps(ctx["device_ops"])
    first = min(r[1] for r in ctx["device_ops"])
    found.sort(key=lambda g: g[0] - g[1])
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    level = level_of_launch(ctx)
    by_level: Dict[str, float] = {}
    for _, a, b, corr in ctx["device_ops"]:
        at = level.get(corr)
        key = f"{at['level']} {at['engine']} {at['direction']}" if at else "outside"
        by_level[key] = by_level.get(key, 0.0) + (b - a) / 1e3 / traced
    launched = {r[3] for r in ctx["runtime"]}
    gc.collect()
    t_cost = time.perf_counter()
    cost = _span_cost_us(obs)
    gc.callbacks.remove(on_gc)
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "batches": traced, "card": _power_limit(),
        "metrics": metrics,
        "launch_match_share": launch_match_share(ctx),
        "launch_calls": sum(r[0] in LAUNCH_CALLS for r in ctx["runtime"]),
        "device_ops_with_a_call": sum(r[3] in launched for r in ctx["device_ops"])
        / len(ctx["device_ops"]),
        "device_ms_by_level": by_level,
        "outside_levels_ms": _outside_levels_ms(ctx, traced),
        "unprofiled_split_ms": {n: read(n, unprofiled) for n in split},
        "unprofiled_outside_levels_ms": _outside_levels_ms(unprofiled, unprofiled["trace_batches"]),
        "spans_a_batch": spans_a_batch,
        "host_ms_untraced": host["off"], "host_ms_traced": host["on"],
        "traced_less_untraced_us_a_span":
            (med(host["on"]) - med(host["off"])) * 1e3 / spans_a_batch,
        "span_cost_us": cost,
        # the collector's passes by generation: count, total ms, longest ms
        "gc_in_kept_profile": _gc_summary(p for p in pauses if t_kept[0] <= p[1] <= t_kept[1]),
        "gc_in_span_cost": _gc_summary(p for p in pauses if p[1] >= t_cost),
        "gc_objects": len(gc.get_objects()),
        "window_ms": window / 1e3,
        # the longest gaps: label, ms, ms from the window's start
        "gaps": [(label(g, ctx), (g[1] - g[0]) / 1e3, (g[0] - first) / 1e3)
                 for g in found[:10]],
    }), flush=True)


if __name__ == "__main__":
    sys.path[:0] = [str(pathlib.Path(__file__).resolve().parents[1] / p) for p in ("", "src")]
    main()
