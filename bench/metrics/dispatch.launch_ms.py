"""Host milliseconds a traced batch inside the port's ``kernels.launch``
spans: the ctypes calls of the exported launchers, with the CUDA
runtime's attribute and launch calls they make (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    n = spans.traced_batches(ctx)
    return spans.Intervals(ctx["spans"], "kernels.launch").total_ms() / n if n else None
