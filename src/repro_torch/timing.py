"""Timing on the card for the port's measurement scripts.

``chip_smoke.py``, ``benchmarks/torch_table3_timing.py`` and the
``tools/*_anatomy.py`` scripts time kernels with these: CUDA-event
medians over back-to-back calls (:func:`median_ms`), device time by
kernel from ``torch.profiler`` (:func:`pass_ms`, :func:`device_ms`),
host microseconds a call (:func:`host_us`), the card's name and power
limit (:func:`card_line`) and the least time the card could take for a
piece of work (:func:`bound`).  Every function here needs a CUDA card;
nothing runs on import.
"""
from __future__ import annotations

import functools
import statistics
import subprocess
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores; the integer rate is the card's
# own (int32_ops_per_s)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
INT32_LANES_PER_SM = 64  # Hopper: 16 INT32 lanes in each of an SM's 4 partitions


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` field list of card 0, as printed."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return smi("name,power.limit")


@functools.lru_cache(maxsize=1)
def int32_ops_per_s() -> float:
    """The card's INT32 rate: SMs x 64 INT32 lanes x the SM clock's
    maximum, as ``nvidia-smi`` reads it (1.98 GHz on an H100 SXM)."""
    mhz = float(smi("clocks.max.sm").split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * INT32_LANES_PER_SM * mhz * 1e6


def bound(nbytes: float, ops: float, ops_per_s: float | None = None):
    """(bound ms, what bounds it): the bytes at the HBM rate or the
    operations at ``ops_per_s`` (the card's INT32 rate unless given),
    whichever takes longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / (ops_per_s or int32_ops_per_s()) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event times of one call of ``fn`` (two
    warm-up calls first)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def pass_ms(fn, reps: int = 5, per_call: int | None = None, warm: int = 3,
            tries: int = 3, every_kernel: bool = False) -> dict:
    """Device ms of each kernel ``fn`` launches, per call, by kernel name
    (``torch.profiler``).  The profiler on the card loses kernel records
    now and then (two a profile, every time, late in ``chip_smoke.py``'s
    run), so a total divided by the calls made under-counts.  One profile
    holds ``warm + reps`` identical calls and is read from its last ``reps
    * per_call`` kernel records by start time (``per_call``: the launches
    one call makes, from the caller, else from the count); a profile with
    fewer records is taken again, up to ``tries`` times, and then the
    result is ``{"not measured": ...}``, never a short total.  Kernel
    records are those named ``*kernel*`` (the port's kernels, PyTorch's
    elementwise ones) or ``passes::*``; ``every_kernel`` takes every
    device record but copies and fills (PyTorch's concatenation, cuDNN's
    convolutions)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(warm + reps):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:  # a profiler that cannot trace the card: the event medians stand
            return {"profiler unavailable": str(e)[:200]}
        recs = sorted((ev.time_range.start, ev.name, ev.time_range.elapsed_us())
                      for ev in prof.events()
                      if str(ev.device_type).endswith("CUDA") and _is_kernel(ev.name, every_kernel))
        seen.append(len(recs))
        calls = per_call if per_call is not None else max(1, round(len(recs) / (warm + reps)))
        if len(recs) >= reps * calls:
            out = {}
            for _, name, us in recs[len(recs) - reps * calls:]:
                key = name.split("(")[0][:80]
                out[key] = out.get(key, 0.0) + us / 1e3 / reps
            return out
    return {"not measured": f"kernel records seen {seen} of {warm + reps} calls, "
                            f"want {reps} x {per_call or 'the launches a call makes'}"}


def _is_kernel(name: str, every_kernel: bool) -> bool:
    if every_kernel:
        return not name.startswith(("Memcpy", "Memset"))
    return "kernel" in name or "passes::" in name


def device_ms(fn, per_call: int | None, every_kernel: bool = False) -> float | None:
    """Device ms per call of all the kernels ``fn`` launches (``per_call``
    launches a call, or None: counted), None where the profiler gave too
    few records."""
    ms = pass_ms(fn, per_call=per_call, every_kernel=every_kernel)
    return sum(ms.values()) if all(isinstance(v, float) for v in ms.values()) else None


def fmt_ms(v) -> str:
    return f"{v:.4f}" if isinstance(v, float) else "not measured" if v is None else str(v)


def host_us(fn, dev, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``: calls enqueued back to back,
    then one sync (the card idles behind the host at a small level)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize(dev)
    return us
