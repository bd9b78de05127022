"""The port's serve tier: the 2-D and 3-D wavelet-transform routes and
the LM engine.

    scheduler.py   bucketed FIFO admission — shape routing, load
                   shedding, deadlines (host-only, no device work)
    executor.py    transform callables cached per
                   (bucket, slots, scheme, levels, mode, device, mesh)
    engine.py      micro-batch assembly, bounded retry, batch-level
                   WZRC response encode
    routes.py      progressive fidelity tiers (thumbnail / refine /
                   full) from one stored bitstream per micro-batch
    serve_step.py  the batched-LM serving engine (prefill + decode
                   slots; ``Request``, ``ServeEngine``)

Port of ``repro.serve``, which exports the same names (the LM engine
from ``serve_step``).
"""
from repro_torch.serve.engine import (  # noqa: F401
    TransformRequest,
    WaveletServeEngine,
    crop_result,
)
from repro_torch.serve.executor import (  # noqa: F401
    ExecKey,
    TransformExecutor,
    mesh_signature,
)
from repro_torch.serve.routes import (  # noqa: F401
    ProgressiveServeRoute,
    StoredResponse,
    tier_shape,
)
from repro_torch.serve.scheduler import BucketScheduler  # noqa: F401
from repro_torch.serve.serve_step import Request, ServeEngine  # noqa: F401

__all__ = [
    "BucketScheduler",
    "ExecKey",
    "ProgressiveServeRoute",
    "Request",
    "ServeEngine",
    "StoredResponse",
    "TransformExecutor",
    "TransformRequest",
    "WaveletServeEngine",
    "crop_result",
    "mesh_signature",
    "tier_shape",
]
