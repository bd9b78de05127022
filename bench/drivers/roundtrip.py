"""The ``roundtrip`` traffic: forward + inverse of device-resident batches.

A library user's pipeline keeps a few batches queued on its stream.  The
loop takes the next batch from a pool of distinct input batches made on
the device from the seed, records a CUDA event, enqueues the port's
public forward and inverse (``repro_torch.kernels``, ``checked`` left at
its default), records a second event, and once ``in_flight`` batches
are outstanding waits on the oldest.

The mix's JSON file (``bench/traffic/<name>.json``) gives ``batch``
(items a batch), ``in_flight``, ``pool`` (distinct batches), ``check_span``
(the batch kept for the output check is drawn from the seed among the
window's first ``check_span`` after the first ``in_flight``) and
``trace_batches`` (round trips under the profiler in a traced run).  The
configuration gives the item's ``shape``, ``ndim``, ``levels``,
``scheme``, ``mode``, ``dtype``, ``content`` and ``reference``.

What is measured:
  * ``roundtrip_msps``: samples of the batches retired in the window over
    the window's host seconds (first submission to last retirement);
  * ``batch_p95_ms``: 95th percentile, over every batch submitted in the
    window, of the device-clock time between its two events: its turn on
    the stream, idle time inside it included;
  * ``peak_mem_gib``: ``torch.cuda.max_memory_allocated`` over the window;
  * for the per-layer readers: host seconds inside the forward and
    inverse calls, the port's launch counts, and a profiler trace of
    ``trace_batches`` further round trips.
Once the window has closed, the kept batch and the window's last batch
are copied to the host, the card's state is freed, and every band of
every level and every reconstructed sample is compared with the plain
reference worked out again from the same inputs.
"""
from __future__ import annotations

import gc
import os
import random
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from math import prod
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import devtrace, harness, roofline

Transform = Tuple[Callable, Callable]


def transforms(config: dict) -> Transform:
    """The port's public forward and inverse for ``config``."""
    from repro_torch import kernels as K

    kw = dict(mode=config["mode"], scheme=config["scheme"])
    levels, ndim = config["levels"], config["ndim"]
    if ndim == 2:
        return (lambda x: K.dwt_fwd_2d_multi(x, levels, **kw),
                lambda p: K.dwt_inv_2d_multi(p, **kw))
    return (lambda x: K.dwt_fwd_nd(x, levels, ndim=ndim, **kw),
            lambda p: K.dwt_inv_nd(p, **kw))


def make_pool(cell: harness.Cell, seed: int, device: torch.device) -> List[torch.Tensor]:
    """``pool`` distinct batches of ``batch`` items, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    make = harness.content(cell).make
    t = cell.traffic
    return [make(gen, t["batch"], cell.config, device) for _ in range(t["pool"])]


class _HostEvent:
    """A CUDA event's interface on the host clock, for CPU runs (tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


def _event(device: torch.device):
    return torch.cuda.Event(enable_timing=True) if device.type == "cuda" else _HostEvent()


class _Loop:
    """One closed loop of round trips, and what it saw."""

    def __init__(self, pool, fwd, inv, in_flight: int, device: torch.device):
        self.pool, self.fwd, self.inv = pool, fwd, inv
        self.in_flight, self.device = in_flight, device
        self.lat_ms: List[float] = []
        self.host_s = 0.0  # inside the forward and inverse calls
        self.submitted = self.retired = 0
        self.kept: Dict[int, tuple] = {}
        self.last: Optional[tuple] = None

    def _retire(self, item, keep) -> tuple:
        k, start, end, pyr, out = item
        end.synchronize()
        self.t_last = time.perf_counter()
        self.retired += 1
        self.lat_ms.append(start.elapsed_time(end))
        if k in keep:
            self.kept[k] = (pyr, out)
        return (k, pyr, out)

    def run(self, deadline: Optional[float] = None, batches: Optional[int] = None,
            keep=frozenset()) -> "_Loop":
        """Submit round trips until ``batches`` were submitted, or until a
        retirement comes past ``deadline`` after every kept batch has
        retired; then drain.  The window's end is the last retirement
        before the drain."""
        pending = deque()
        self.t0 = time.perf_counter()
        k = 0
        last = None
        while True:
            x = self.pool[k % len(self.pool)]
            start = _event(self.device)
            start.record()
            a = time.perf_counter()
            pyr = self.fwd(x)
            out = self.inv(pyr)
            self.host_s += time.perf_counter() - a
            end = _event(self.device)
            end.record()
            pending.append((k, start, end, pyr, out))
            del pyr, out
            k += 1
            if len(pending) >= self.in_flight:
                item = self._retire(pending.popleft(), keep)
                if batches is not None:
                    done = k >= batches
                else:
                    done = self.t_last >= deadline and self.retired > max(keep, default=-1)
                if done:
                    last = item
                    break
                del item
        self.window_batches, self.window_end = self.retired, self.t_last
        while pending:
            last = self._retire(pending.popleft(), keep)
        self.submitted = k
        self.last = last
        return self


def _diff(got: np.ndarray, want: np.ndarray) -> int:
    """Samples of ``got`` that differ from ``want``; all of them where the
    shape or the dtype differs."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def _check_item(ref, config: dict, x: np.ndarray, approx, details, out) -> Tuple[int, int]:
    """(band, output) mismatches of one item against the reference."""
    dtype = np.dtype(config["dtype"])
    r_approx, r_details = ref.forward(x, config["levels"], config["ndim"], dtype)
    bad = _diff(approx, r_approx)
    for i, r_lvl in enumerate(r_details):
        lvl = details[i] if i < len(details) else ()
        for j, r_band in enumerate(r_lvl):
            bad += _diff(lvl[j], r_band) if j < len(lvl) else int(r_band.size)
    # the reference's inverse of its own pyramid is the input (lossless):
    # the output is held against the input, in the configuration's dtype
    return bad, _diff(out, x.astype(dtype))


def _to_host(pyr, out) -> tuple:
    """A batch's pyramid and output as host arrays."""
    return (pyr[0].cpu().numpy(), [[b.cpu().numpy() for b in lvl] for lvl in pyr[1]],
            out.cpu().numpy())


def check(cell: harness.Cell, batches: List[Tuple[np.ndarray, tuple]]) -> Dict[str, int]:
    """Mismatched band and output samples of the checked batches
    ``(inputs, (approx, details, out))``, and the batches with any, item
    by item in threads (NumPy releases the interpreter lock)."""
    ref = harness.reference(cell)
    jobs = []
    for n, (x, (approx, details, out)) in enumerate(batches):
        for i in range(x.shape[0]):
            jobs.append((n, x[i], approx[i], [[b[i] for b in lvl] for lvl in details], out[i]))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        res = list(ex.map(lambda j: (j[0], *_check_item(ref, cell.config, *j[1:])), jobs))
    return {
        "band_mismatches": sum(r[1] for r in res),
        "recon_mismatches": sum(r[2] for r in res),
        "batches_checked": len(batches),
        "batches_failed": len({r[0] for r in res if r[1] or r[2]}),
    }


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, fwd_inv: Optional[Transform] = None) -> dict:
    """Set up, measure for ``seconds``, trace if asked, and check.
    ``fwd_inv`` stands in for the port's transforms (controls, faults)."""
    t = cell.traffic
    cuda = device.type == "cuda"
    fwd, inv = fwd_inv or transforms(cell.config)
    samples = t["batch"] * prod(cell.config["shape"])
    itemsize = np.dtype(cell.config["dtype"]).itemsize
    keep_at = t["in_flight"] + random.Random(seed).randrange(t["check_span"])

    t_card = time.perf_counter()
    torch.empty(0, device=device)  # reach the card
    t_pool = time.perf_counter()
    pool = make_pool(cell, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter()
    # warm up the cell's one shape: kernels built and loaded, plans made,
    # and the allocator holding what the window's queue and kept batch need
    _Loop(pool, fwd, inv, t["in_flight"], device).run(
        batches=len(pool) + t["in_flight"] + 1, keep={t["in_flight"]})
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    t_ready = time.perf_counter()
    print(f"set-up: card {t_pool - t_card:.3f} s, inputs {t_warm - t_pool:.3f} s, "
          f"warm-up {t_ready - t_warm:.3f} s", file=sys.stderr)

    from repro_torch.kernels import launches

    before = launches.snapshot()
    t_first = time.perf_counter()
    win = _Loop(pool, fwd, inv, t["in_flight"], device).run(
        deadline=t_first + seconds, keep={keep_at})
    counts = launches.snapshot()
    delta = {k: v - before.get(k, 0) for k, v in counts.items() if v != before.get(k, 0)}
    window_s = win.window_end - win.t0
    memory_peak = 0
    e2e = {
        "roundtrip_msps": win.window_batches * samples / window_s / 1e6,
        "batch_p95_ms": float(np.percentile(win.lat_ms, 95)),
    }
    if cuda:
        window_peak = torch.cuda.max_memory_allocated(device)
        memory_peak = max(setup_peak, window_peak)
        e2e["peak_mem_gib"] = window_peak / 2**30

    # the window's products to the host, before the traced round trips
    # reuse their memory; the card's state is freed before the check
    checked = [(pool[k % len(pool)].cpu().numpy(), _to_host(*win.kept[k])) for k in sorted(win.kept)]
    checked.append((pool[win.last[0] % len(pool)].cpu().numpy(), _to_host(win.last[1], win.last[2])))
    del win.kept, win.last

    summary, traced = None, 0
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        # CUDA activity only (bench/devtrace.py); a first, discarded
        # profile keeps the profiler's own start-up out of the traced one
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced = _Loop(pool, fwd, inv, t["in_flight"], device).run(
                    batches=t["trace_batches"]).submitted
                torch.cuda.synchronize(device)
        dev, host = devtrace.from_profiler(prof)
        summary = devtrace.summarise(dev, host) if dev else None

    del pool
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    checks = check(cell, checked)

    ctx = {
        "submitted": win.submitted,
        "window_batches": win.window_batches,
        "window_s": window_s,
        "host_s": win.host_s,
        "launches": delta,
        "bytes_per_batch": roofline.roundtrip_bytes(t["batch"], cell.config["shape"], itemsize),
        "trace": summary,
        "trace_batches": traced,
    }
    return {
        "t_first": t_first,
        "e2e": e2e,
        "ctx": ctx,
        "checks": checks,
        "attempted": win.submitted,
        "memory_peak_bytes": memory_peak,
        "trace": summary,
    }
