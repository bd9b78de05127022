"""The observability layer end to end, on the port
(``examples/observe_serve.py`` on ``repro_torch``): a bucketed serve run
with the ``repro_torch.obs`` instrumentation live, a fault armed so the
event taxonomy lights up, the metrics snapshot printed, and a
Chrome-trace JSON artifact written for Perfetto.

    PYTHONPATH=src python examples/torch_observe_serve.py [--device cpu]

Runs on the card by default (the 2-D and Rice kernels); ``--device cpu``
runs their plain PyTorch versions.

  1. serve a mixed-bucket request stream; the scheduler, executor,
     engine, and codec publish counters / gauges / histograms into the
     process-wide registry as a side effect of normal operation
  2. arm one transient transform fault: the retry ladder emits
     RetryEvent -> HealEvent (and the RetryWarning still fires, with
     its category intact)
  3. print ``obs.snapshot()`` — every metric series, event counts, and
     per-subsystem span counts in one dict — plus the p50/p95/p99 of
     the batch-latency histogram and the Prometheus text exposition
  4. write the recorded spans as Chrome-trace JSON; open the file at
     https://ui.perfetto.dev to see the serve steps, codec encodes,
     and retry timing on one timeline
"""
import argparse
import json
import warnings

import numpy as np

from repro_torch import obs
from repro_torch.resilience import inject
from repro_torch.serve import TransformRequest, WaveletServeEngine

TRACE_PATH = "observe_serve_trace.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device
    rng = np.random.default_rng(7)
    obs.reset()  # a clean ledger so the printout is this run only

    engine = WaveletServeEngine(
        buckets=((16, 16), (32, 32)),
        batch_slots=4,
        levels=2,
        encode_response=True,
        device=device,
    )
    engine.warmup()

    shapes = [(16, 16), (13, 11), (32, 24), (32, 32), (28, 30), (16, 12),
              (32, 32), (9, 9)]
    for uid, (h, w) in enumerate(shapes):
        img = rng.integers(-2048, 2048, (h, w)).astype(np.int32)
        engine.submit(TransformRequest(uid=uid, image=img))

    # one transient fault on the first batch: the retry ladder recovers,
    # and the obs layer records the whole episode
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with inject.armed("serve.transform", times=1):
            while engine.scheduler.pending():
                engine.step()
    print(f"served {len(shapes)} requests; {len(caught)} warning(s) "
          f"fired ({', '.join(type(w.message).__name__ for w in caught)})")

    snap = obs.snapshot()
    print("\n-- obs.snapshot() --")
    print(json.dumps(snap, indent=2, default=str))

    lat = obs.histogram("serve.batch_latency_ms", bucket="32x32").summary()
    print(f"\n32x32 batch latency: n={lat['count']} p50={lat['p50']:.3g}ms "
          f"p95={lat['p95']:.3g}ms p99={lat['p99']:.3g}ms")

    retries = obs.events.query(kind=obs.RetryEvent)
    heals = obs.events.query(kind=obs.HealEvent)
    print(f"retry episode: {len(retries)} retry -> {len(heals)} heal "
          f"({heals[0].mechanism if heals else 'none'})")

    print("\n-- Prometheus exposition (first 15 lines) --")
    print("\n".join(obs.render_prometheus().splitlines()[:15]))

    path = obs.write_chrome_trace(TRACE_PATH)
    n_spans = len(obs.export_chrome_trace()["traceEvents"])
    print(f"\nwrote {n_spans} spans to {path} — load it at "
          "https://ui.perfetto.dev")
    return snap


if __name__ == "__main__":
    main()
