"""Device milliseconds a batch of every operation the card ran (kernels,
copies, fills) in the traced round trips, from the profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["trace_batches"]:
        return None
    return tr.device_op_s / ctx["trace_batches"] * 1e3
