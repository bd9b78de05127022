"""The whole round trip's share of the card's peak, in %: the bytes a
batch must move (``bench/roofline.py``) over the window's host seconds a
retired batch, at the H100's published HBM rate.  No kernel's name enters
it, so it bounds every kernel's gain."""
from bench import roofline


def read(ctx):
    if not ctx["window_batches"]:
        return None
    per_batch_s = ctx["window_s"] / ctx["window_batches"]
    return ctx["bytes_per_batch"] / per_batch_s / roofline.PEAK_BYTES_PER_S * 100
