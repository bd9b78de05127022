"""Device milliseconds a traced batch of the operations whose launch call
(by correlation id) lies in a ``kernels.launch`` span inside a
``kernels.level`` span of level 1, the finest, both directions
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    n = spans.traced_batches(ctx)
    if not n:
        return None
    level = spans.level_of_launch(ctx)
    return sum(b - a for _, a, b, corr in ctx["device_ops"]
               if level.get(corr, {}).get("level") == 1) / 1e3 / n
