"""The port's serve tier end to end (``examples/serve_decode.py`` on
``repro_torch``): bucketed transform serving with a callable cache,
batch-level WZRC encode, progressive thumbnail -> refinement -> full
decode from ONE stored bitstream, then the LM continuous-batching
engine on the reduced granite-3-8b.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]

Runs on the card by default (the hand-written kernels); ``--device cpu``
runs every kernel's plain PyTorch version.

  1. submit mixed-shape integer images; the scheduler routes each to its
     nearest bucket (zero-pad admission) and forms micro-batches
  2. the executor runs each batch through ONE cached transform callable
     per bucket — after warmup the cache never misses
  3. each micro-batch is encoded into a single shared WZRC container
     (lead dim = batch); per-request responses carry a row index
  4. the progressive route serves the LL thumbnail from a byte-range
     read, then refines tier by tier, then reconstructs the original
     samples bit-exactly — all from the same stored blob
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import codec
from repro_torch.codec import progressive
from repro_torch.serve import ProgressiveServeRoute, TransformRequest, WaveletServeEngine


def wavelet_demo(device):
    rng = np.random.default_rng(7)
    engine = WaveletServeEngine(
        buckets=((16, 16), (32, 32), (64, 64)),
        batch_slots=4,
        levels=2,
        encode_response=True,
        device=device,
    )
    compiled = engine.warmup()
    print(f"warmup built {compiled} transform callables "
          f"(one per bucket: {engine.scheduler.buckets})")

    # mixed shapes: exact fits and zero-padded admissions
    shapes = [(16, 16), (13, 11), (32, 24), (64, 48), (28, 30), (16, 12)]
    requests = []
    for uid, (h, w) in enumerate(shapes):
        img = rng.integers(-2048, 2048, (h, w)).astype(np.int32)
        requests.append(TransformRequest(uid=uid, image=img))

    ex = engine.executor
    warm_misses = ex.misses
    t0 = time.perf_counter()
    done = engine.run(requests)
    dt = time.perf_counter() - t0
    new_misses = ex.misses - warm_misses
    print(f"served {len(done)} requests in {dt * 1e3:.1f} ms — "
          f"{ex.hits} cache hits, {new_misses} new callables after warmup")
    assert new_misses == 0

    shared = len({id(r.encoded) for r in done if r.batch_index is not None})
    print(f"batch-level encode: {len(done)} responses share {shared} container(s)")

    # progressive serving: thumbnail first, refine on demand
    route = ProgressiveServeRoute(device=device)
    for r in done:
        route.store(r)
    uid = 3  # the (64, 48) request
    blob = done[uid].encoded
    reader = progressive.CountingReader(blob)
    codec.decode_lowband(reader, device=device)  # byte-range read, counted by the reader
    print(f"req {uid}: thumbnail {tuple(route.thumbnail(uid).shape)} from "
          f"{reader.bytes_read}/{len(blob)} bytes "
          f"({reader.bytes_read / len(blob):.1%} of the container)")
    for level, shape in route.tiers(uid).items():
        print(f"  tier {level}: {shape}")
    full = route.full(uid)
    exact = bool(np.array_equal(full.cpu().numpy(), requests[uid].image))
    print(f"  full tier bit-exact vs submitted image: {exact}")
    assert exact


def lm_demo(device):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    cfg = reduced(get_config("granite-3-8b"))
    params = L.init_params(T.model_defs(cfg), 0, device=device)
    engine = ServeEngine(cfg, params, batch_slots=4, prefill_len=16, device=device)

    rng = np.random.default_rng(1)
    requests = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab_size,
                                    size=rng.integers(2, 12)).astype(np.int32),
                max_new=int(rng.integers(4, 12)))
        for i in range(10)
    ]
    t0 = time.perf_counter()
    done = engine.run(requests)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    where = torch.cuda.get_device_name(engine.device) if engine.device.type == "cuda" else "CPU"
    print(f"served {len(done)} LM requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s on {where}, reduced config)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = torch.device(ap.parse_args().device)
    print("== wavelet transform serving (bucketed + progressive) ==")
    wavelet_demo(device)
    print("\n== LM continuous batching ==")
    lm_demo(device)


if __name__ == "__main__":
    main()
