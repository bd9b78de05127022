"""The round trip's share of its roofline, in %: the bytes a batch must
move (``bench/roofline.py``) at the H100's published HBM rate, over the
device milliseconds a batch took in the traced round trips."""
from bench import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["trace_batches"] or not tr.device_op_s:
        return None
    device_ms = tr.device_op_s / ctx["trace_batches"] * 1e3
    return roofline.bound_ms(ctx["bytes_per_batch"]) / device_ms * 100
