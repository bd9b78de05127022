"""Share of the traced window, in %, in which the card was idle and the
operation that ended the idle had not yet been launched (its CUDA runtime
call started after the card ran dry): idle the host caused, apart from
idle with work already queued (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    if not spans.traced_batches(ctx) or not ctx.get("device_ops"):
        return None
    window, gaps = spans.gaps(ctx["device_ops"])
    launched_at = {r[3]: r[1] for r in ctx["runtime"]}
    idle = sum(g[1] - g[0] for g in gaps if spans.starved(g, launched_at))
    return idle / window * 100 if window else None
