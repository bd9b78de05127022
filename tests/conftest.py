"""Tier-1 test configuration.

Registers the deterministic ``hypothesis`` fallback shim when the real
package is unavailable (kernel CI images bake in only the jax/pallas
toolchain), so test collection succeeds everywhere.  The real hypothesis
always wins when installed; pin it via requirements-dev.txt locally.

Warning policy: every RuntimeWarning is an ERROR except
``BackendDegradeWarning`` (the dedicated category for backend-degrade
notices, ``kernels/backend.py``), which is expected on CPU runs — an
explicit ``pallas`` request legitimately degrades to the emulator
off-accelerator.  The seed leaked those notices into the pytest warnings
summary; with the dedicated category filtered and everything else
escalated, a degrade-warning leak (or any new stray RuntimeWarning)
fails the tier-1 suite — and therefore the CI smoke gate — outright.
Filters are ini-ordered: the later (more specific) line wins.
"""
import importlib.util
import pathlib
import sys

try:  # real hypothesis preferred
    import hypothesis  # noqa: F401
except ImportError:
    _path = pathlib.Path(__file__).with_name("hypothesis_shim.py")
    _spec = importlib.util.spec_from_file_location("hypothesis", _path)
    _shim = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_shim)
    sys.modules["hypothesis"] = _shim
    sys.modules["hypothesis.strategies"] = _shim.strategies


def pytest_configure(config):
    config.addinivalue_line("filterwarnings", "error::RuntimeWarning")
    config.addinivalue_line(
        "filterwarnings",
        "ignore::repro.kernels.backend.BackendDegradeWarning",
    )
    # degraded-but-correct resilience notices (retry succeeded, restore
    # self-healed, encode degraded) are expected under chaos injection;
    # tests assert them explicitly with pytest.warns where they matter
    config.addinivalue_line(
        "filterwarnings",
        "ignore::repro.resilience.errors.ResilienceWarning",
    )
    # CI lanes (.github/workflows/ci.yml): the PR lane runs -m "not slow"
    # for fast feedback; the main-branch lane runs the full suite.
    config.addinivalue_line(
        "markers",
        "slow: long-running sweep (2048x2048 images, CPU-mesh subprocess "
        "sweeps); excluded from the CI pull-request lane via -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "sharded: spawns subprocesses with a forced multi-device CPU mesh "
        "(XLA_FLAGS=--xla_force_host_platform_device_count)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the repro_torch kernels have no CPU mode); "
        "skips without one — tests/test_torch_cuda.py says how to run it there",
    )
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection suite (tests/test_resilience.py) — every "
        "injected fault must recover bit-exactly, degrade with a typed "
        "warning, or fail with a typed error; CI runs it as its own lane "
        "with a fixed REPRO_CHAOS_SEED",
    )
