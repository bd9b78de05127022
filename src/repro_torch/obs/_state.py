"""Process-wide observability on/off switch.

Copied unchanged from ``repro.obs._state`` so the port imports nothing of the
reference package.

A single module-level bool read by every instrument's hot path (one
attribute load — the disabled path must cost nothing measurable, and
the overhead bench A/Bs exactly this flag).  Lives in its own module so
``metrics``/``events``/``trace`` can import it without cycles.

``REPRO_OBS=0`` disables instrumentation for the whole process at
import; everything else (including unset) leaves it on — the subsystem
is designed to be cheap enough to leave on, and the bench gate bounds
that claim.
"""
from __future__ import annotations

import os

enabled: bool = os.environ.get("REPRO_OBS", "").strip() not in ("0", "off", "false")


def set_enabled(value: bool) -> None:
    global enabled
    enabled = bool(value)


def is_enabled() -> bool:
    return enabled
