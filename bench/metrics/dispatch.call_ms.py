"""Host milliseconds a traced batch inside the port's ``kernels.call``
spans: its outermost public forward and inverse calls, timed by the
program itself (``obs.tracing("kernels")``) in the traced round trips
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    n = spans.traced_batches(ctx)
    return spans.Intervals(ctx["spans"], "kernels.call").total_ms() / n if n else None
