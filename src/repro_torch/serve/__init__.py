"""The port's serve tier: the 2-D wavelet-transform route.

    scheduler.py   bucketed FIFO admission — shape routing, load
                   shedding, deadlines (host-only, no device work)
    executor.py    transform callables cached per
                   (bucket, slots, scheme, levels, mode, device)
    engine.py      micro-batch assembly, bounded retry

Port of ``repro.serve`` without the codec response route, the
progressive tiers and the LM engine (``ROADMAP.md``, Queue 1).
"""
from repro_torch.serve.engine import (  # noqa: F401
    TransformRequest,
    WaveletServeEngine,
    crop_result,
)
from repro_torch.serve.executor import ExecKey, TransformExecutor  # noqa: F401
from repro_torch.serve.scheduler import BucketScheduler  # noqa: F401

__all__ = [
    "BucketScheduler",
    "ExecKey",
    "TransformExecutor",
    "TransformRequest",
    "WaveletServeEngine",
    "crop_result",
]
