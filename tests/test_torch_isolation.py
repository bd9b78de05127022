"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch`` or ``chip_smoke.py``, and its copied stdlib layers
(``obs``, ``resilience``) behave like the reference's."""
import ast
import os
import pathlib
import subprocess
import sys
import warnings

import pytest

from repro import obs as ROBS
from repro.resilience import inject as RINJ
from repro_torch import obs as TOBS
from repro_torch.resilience import errors as TERR
from repro_torch.resilience import inject as TINJ

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_the_scan_sees_every_port_module():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("chip_smoke.py", "src/repro_torch/core/schemes.py",
                 "src/repro_torch/kernels/fused2d.py", "src/repro_torch/serve/engine.py"):
        assert must in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_port_file_imports_jax_or_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_fresh_interpreter_imports_the_port_without_jax():
    code = (
        "import sys; import repro_torch.serve, repro_torch.kernels; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_obs_copy_matches_reference_registry():
    reg_t, reg_r = TOBS.MetricRegistry(), ROBS.MetricRegistry()
    for reg in (reg_t, reg_r):
        reg.counter("serve.batches").inc(3)
        reg.gauge("serve.queue_depth").set(7)
        h = reg.histogram("serve.batch_latency_ms")
        for v in (0.5, 2.0, 9.0, 40.0):
            h.observe(v)
    assert reg_t.snapshot() == reg_r.snapshot()
    assert reg_t.render_prometheus() == reg_r.render_prometheus()


def test_device_spans_use_the_torch_profiler_hook():
    tracer = TOBS.Tracer()
    with tracer.span("serve.step", subsystem="serve", device=True, bucket="16x16"):
        pass
    (rec,) = tracer.spans()
    assert rec.cat == "serve" and rec.args == {"bucket": "16x16"}
    src = (ROOT / "src" / "repro_torch" / "obs" / "trace.py").read_text()
    assert "record_function" in src and "TraceAnnotation" not in src


def test_port_warnings_are_not_runtime_warnings():
    """tests/conftest.py escalates RuntimeWarning; the port's resilience
    notices are their own category."""
    assert not issubclass(TERR.ResilienceWarning, RuntimeWarning)
    assert issubclass(TERR.RetryWarning, TERR.ResilienceWarning)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        warnings.filterwarnings("error", category=RuntimeWarning)
        warnings.warn(TERR.RetryWarning("retrying"), stacklevel=1)
    assert len(rec) == 1
    assert issubclass(TERR.IntegerOverflowError, OverflowError)


def test_inject_copy_fires_deterministically():
    TINJ.reset()
    try:
        TINJ.arm("serve.transform", TINJ.Fault(at_call=2, times=1))
        TINJ.check("serve.transform")
        with pytest.raises(TINJ.InjectedFault):
            TINJ.check("serve.transform")
        TINJ.check("serve.transform")
    finally:
        TINJ.reset()
    assert TINJ.flip_bit(b"\x00\x00", 9) == RINJ.flip_bit(b"\x00\x00", 9) == b"\x00\x02"
