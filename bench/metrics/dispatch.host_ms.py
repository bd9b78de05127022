"""Host milliseconds a batch inside the port's public forward and inverse
calls (``time.perf_counter`` around each call, no sync), over every batch
of the window: level dispatch, plans, allocation and launches."""


def read(ctx):
    if not ctx["submitted"]:
        return None
    return ctx["host_s"] / ctx["submitted"] * 1e3
