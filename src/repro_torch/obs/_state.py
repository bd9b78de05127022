"""Process-wide observability switches.

Copied from ``repro.obs._state`` so the port imports nothing of the
reference package; ``kernels`` is the port's.

Module-level bools read by every instrument's hot path (one attribute
load: the disabled path must cost nothing measurable, and the overhead
bench A/Bs exactly this flag).  Lives in its own module so
``metrics``/``events``/``trace`` can import it without cycles.

``enabled``: ``REPRO_OBS=0`` disables the metrics, events and the
serve / codec / ckpt / collectives spans for the whole process at
import; everything else (including unset) leaves them on — the
subsystem is designed to be cheap enough to leave on, and the bench
gate bounds that claim.

``kernels``: the kernels layer's spans, off unless inside
``obs.tracing("kernels")`` (no environment variable turns them on).
"""
from __future__ import annotations

import os

enabled: bool = os.environ.get("REPRO_OBS", "").strip() not in ("0", "off", "false")
kernels: bool = False


def set_enabled(value: bool) -> None:
    global enabled
    enabled = bool(value)


def is_enabled() -> bool:
    return enabled
