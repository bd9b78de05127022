"""Paper Table 3 on the port: fixed-point lifting vs a float filter bank.

The counterpart of ``benchmarks/table3_timing.py``.  The paper reports
12 us (its FPGA modules) vs 400 us (DSP float) vs 20 us (FPGA float
[10]) for 256 samples; 2002-era microseconds are not reproducible, so
the claim checked is the ORDERING on one device, with this card's own
numbers for the record.  Four implementations, each at the paper's size
(1 x 256: int16 into the lifting, int32 into the float bank, as the
reference feeds them) and at (a) 64 x 65,536 and (b) 1024 x 65,536
int32:

- ``int_lifting``: ``kernels.dwt53_fwd_1d``, one level (the ``lift1d``
  kernel; at 1 x 256 a cast kernel first, for the int16 input);
- ``float_kernel``: ``kernels.filterbank53_fwd_float``, one launch of
  ``csrc/filterbank.cu`` (the counterpart of the reference's jitted
  baseline, which XLA fuses into one kernel);
- ``float_plain``: its plain version ``core.lifting.filterbank53_fwd_float``
  on the same device (the reference transcribed: about 20 launches);
- ``float_conv1d``: one ``torch.nn.functional.conv1d`` call, stride 2, on
  the input reflect-padded beforehand (the "Library" column; full
  float32: TF32 off).

Rows ``table3.<shape>.<impl>.<metric>``: ``ms`` (CUDA-event median of
one call), ``device_ms`` (``torch.profiler``, every kernel the call
launches), ``host_us`` (host time a call enqueued back to back),
``bound_ms`` (each sample read once as int32 and written once as a
4-byte coefficient, 8 bytes at 3.35 TB/s; the operations at the card's
INT32 or the published FP32 rate never take longer); the reference's
rows come first, from the device times at 1 x 256.

    PYTHONPATH=src python -m benchmarks.torch_run --only table3

``run(device="cpu", small=True)`` runs the same rows on the CPU at small
shapes with the host clock (``device_ms`` and ``host_us`` are then NaN:
not measured); it checks the rows, not speed.
"""
from __future__ import annotations

import contextlib
import math
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch import timing as TM
from repro_torch.core import lifting as L

PAPER_SHAPE = (1, 256)
SHAPES = {"a": (64, 65536), "b": (1024, 65536)}
SMALL_SHAPES = {"a": (4, 1024), "b": (16, 1024)}
IMPLS = ("int_lifting", "float_kernel", "float_plain", "float_conv1d")
# the plain chain and the library call are comparisons: a caller that
# guards the main path against plain versions on the card pauses it there
COMPARISONS = ("float_plain", "float_conv1d")
BYTES_PER_SAMPLE = 8  # int32 in, a 4-byte coefficient out
INT_OPS_PER_SAMPLE = 3  # cdf53: 4 adds + 2 shifts a pair
FLOPS_PER_SAMPLE = 7  # 8 multiplies + 6 adds a pair


def conv1d_weight(device) -> torch.Tensor:
    """(2, 1, 5): the low-pass centred on tap 2, the high-pass on tap 3."""
    w = torch.zeros((2, 1, 5), dtype=torch.float32)
    w[0, 0] = L.H_LO
    w[1, 0, 2:] = L.H_HI
    return w.to(device)


def _cases(x_int: torch.Tensor, x32: torch.Tensor) -> dict:
    n = x32.shape[-1]
    xp = F.pad(x32.to(torch.float32).unsqueeze(1), (2, 2), mode="reflect")
    w = conv1d_weight(x32.device)
    return {
        "int_lifting": lambda: K.dwt53_fwd_1d(x_int),
        "float_kernel": lambda: K.filterbank53_fwd_float(x32),
        "float_plain": lambda: L.filterbank53_fwd_float(x32),
        "float_conv1d": lambda: (lambda o: (o[:, 0], o[:, 1, : n // 2]))(
            F.conv1d(xp, w, stride=2)),
    }


def _host_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _measure(fn, on_card: bool, dev, reps: int) -> dict:
    if not on_card:
        return {"ms": _host_ms(fn, reps), "device_ms": math.nan, "host_us": math.nan}
    dms = TM.device_ms(fn, per_call=None, every_kernel=True)
    return {"ms": TM.median_ms(fn, reps), "device_ms": math.nan if dms is None else dms,
            "host_us": TM.host_us(fn, dev)}


def _bound_ms(impl: str, samples: int, on_card: bool) -> float:
    """The card's bound; on the CPU (no card to read the INT32 rate from)
    the bytes alone, which bound the card's lifting by ~13x anyway."""
    if impl == "int_lifting":
        return TM.bound(BYTES_PER_SAMPLE * samples, INT_OPS_PER_SAMPLE * samples,
                        ops_per_s=None if on_card else math.inf)[0]
    return TM.bound(BYTES_PER_SAMPLE * samples, FLOPS_PER_SAMPLE * samples,
                    ops_per_s=TM.PEAK_FP32_FLOPS)[0]


def measure_shape(rows: int, n: int, dev, rng, compare=contextlib.nullcontext,
                  int16: bool = False, reps: int = 20) -> dict:
    """{impl: {ms, device_ms, host_us, bound_ms, max_abs_err}} at one
    shape; ``max_abs_err`` is each float output's against the plain
    version's (0 for the kernel: bit-equal)."""
    on_card = dev.type == "cuda"
    x_np = rng.integers(0, 256, (rows, n)).astype(np.int16 if int16 else np.int32)
    x_int = torch.from_numpy(x_np).to(dev)
    x32 = x_int.to(torch.int32)
    cases = _cases(x_int, x32)
    out = {}
    with compare():
        want = cases["float_plain"]()
    for impl in IMPLS:
        ctx = compare() if impl in COMPARISONS else contextlib.nullcontext()
        tf32 = (torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
                if impl == "float_conv1d" and on_card else contextlib.nullcontext())
        with ctx, tf32:
            got = cases[impl]()
            m = _measure(cases[impl], on_card, dev, reps if impl != "float_plain" else 5)
        err = (0.0 if impl == "int_lifting" else
               max(float((g - w).abs().max()) for g, w in zip(got, want)))
        m.update(bound_ms=_bound_ms(impl, rows * n, on_card), max_abs_err=err)
        out[impl] = m
    return out


def run(device: str = "cuda", small: bool = False, compare=contextlib.nullcontext) -> list:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("table3: device='cuda' but no CUDA card; pass device='cpu'")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    where = TM.card_line() if on_card else "CPU host clock, plain versions (no card)"
    clock = "device time" if on_card else "host clock on the CPU"
    rng = np.random.default_rng(0)
    shapes = {"paper": PAPER_SHAPE, **(SMALL_SHAPES if small else SHAPES)}
    res = {key: measure_shape(r, n, dev, rng, compare, int16=key == "paper")
           for key, (r, n) in shapes.items()}

    def t(key, impl):  # the ordering's time: device on the card, host on the CPU
        m = res[key][impl]
        return m["device_ms"] if on_card else m["ms"]

    t_int, t_float = t("paper", "int_lifting") * 1e3, t("paper", "float_kernel") * 1e3
    rows = [
        ("table3.int_lifting_us", round(t_int, 3),
         f"paper: 12us on Virtex FPGA; 1 x 256 int16, {clock} of the call; {where}"),
        ("table3.float_filterbank_us", round(t_float, 3),
         f"paper: 400us DSP / 20us FPGA; 1 x 256 int32, the one-launch float kernel, "
         f"{clock}; {where}"),
        ("table3.speedup", round(t_float / t_int, 3),
         "paper claim: fixed-point faster (ordering)"),
        ("table3.ordering_holds", int(t_int <= t_float),
         f"1 = reproduced; from {clock} at 1 x 256, lifting vs the float kernel"),
    ]
    a_rows, a_n = shapes["a"]
    t_big = res["a"]["int_lifting"]["ms"] * 1e3
    rows.append((f"table3.kernel_{a_rows}x{a_n}_us", round(t_big, 1),
                 f"int lifting, one level, events (host clock on the CPU); {where}"))
    rows.append(("table3.kernel_throughput_msamples_s", round(a_rows * a_n / t_big, 1),
                 "samples per us * 1e6"))
    notes = {
        "ms": f"median of one call, {'CUDA events' if on_card else 'host clock'}; {where}",
        "device_ms": (f"torch.profiler, every kernel of the call; {where}" if on_card
                      else "not measured (no card)"),
        "host_us": (f"host time a call, calls back to back; {where}" if on_card
                    else "not measured (no card)"),
        "bound_ms": "8 bytes a sample at 3.35 TB/s (H100 SXM)",
        "max_abs_err": "against the plain float version on the same input",
    }
    for key, (r, n) in shapes.items():
        for impl in IMPLS:
            for metric, note in notes.items():
                if metric == "max_abs_err" and impl == "int_lifting":
                    continue
                rows.append((f"table3.{key}.{impl}.{metric}", res[key][impl][metric],
                             f"{r} x {n}: {note}"))
        rows.append((f"table3.{key}.float_kernel_over_int_lifting",
                     round(t(key, "float_kernel") / t(key, "int_lifting"), 4),
                     f"{r} x {n}: {clock} ratio"))
    return rows
