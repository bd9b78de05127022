"""Host milliseconds a traced batch inside the port's ``kernels.level``
spans but outside their ``kernels.launch`` spans: the levels' plans, band
and scratch allocation and argument packing (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    n = spans.traced_batches(ctx)
    if not n:
        return None
    levels = spans.Intervals(ctx["spans"], "kernels.level")
    launches = spans.Intervals(ctx["spans"], "kernels.launch")
    inside = sum(b - a for _, a, b, _ in launches.spans if levels.holding(a, b)) / 1e3
    return (levels.total_ms() - inside) / n
