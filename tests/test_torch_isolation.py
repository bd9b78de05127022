"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch``, ``chip_smoke.py``, the port's benchmarks
(``benchmarks/torch_*.py``, which also leave the reference's
``benchmarks.gate`` alone) or its examples (``examples/torch_*.py``), and its copied stdlib layers (``obs``,
``resilience``) behave like the reference's."""
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
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "benchmarks").glob("torch_*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path: pathlib.Path):
    """Every module an import statement names: ``a.b`` for ``import a.b``;
    ``a`` and ``a.b`` for ``from a import b``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def _imported_roots(path: pathlib.Path):
    return {m.split(".")[0] for m in _imported_modules(path)}


def test_the_scan_sees_every_port_module():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("chip_smoke.py", "src/repro_torch/core/schemes.py",
                 "src/repro_torch/kernels/fused2d.py", "src/repro_torch/serve/engine.py",
                 "src/repro_torch/codec/rice.py", "src/repro_torch/core/ranges.py",
                 "src/repro_torch/kernels/ops.py", "src/repro_torch/kernels/dwt53.py",
                 "src/repro_torch/configs/dwt53.py", "src/repro_torch/kernels/fused3d.py",
                 "src/repro_torch/core/compression.py", "src/repro_torch/ckpt/checkpoint.py",
                 "src/repro_torch/ckpt/ft.py", "src/repro_torch/train/grad_compress.py",
                 "src/repro_torch/tree.py", "src/repro_torch/core/opcount.py",
                 "src/repro_torch/core/pe.py", "src/repro_torch/kernels/filterbank.py",
                 "src/repro_torch/timing.py", "benchmarks/torch_table2_opcounts.py",
                 "benchmarks/torch_table3_timing.py", "benchmarks/torch_fig5_lossless.py",
                 "benchmarks/torch_run.py", "src/repro_torch/kernels/sharded.py",
                 "src/repro_torch/sharding.py", "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/collectives.py", "src/repro_torch/configs/base.py",
                 "src/repro_torch/configs/stablelm_1_6b.py", "src/repro_torch/models/layers.py",
                 "src/repro_torch/models/attention.py", "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/rglru.py", "src/repro_torch/models/rwkv6.py",
                 "src/repro_torch/models/transformer.py", "src/repro_torch/serve/serve_step.py",
                 "src/repro_torch/data/pipeline.py", "src/repro_torch/train/optim.py",
                 "src/repro_torch/train/train_step.py", "src/repro_torch/launch/train.py",
                 "benchmarks/torch_grad_compression.py", "benchmarks/torch_ckpt_compression.py",
                 "examples/torch_train_lm.py", "examples/torch_multipod_train.py",
                 "examples/torch_serve_decode.py", "src/repro_torch/roofline.py",
                 "src/repro_torch/launch/dryrun.py", "src/repro_torch/launch/dryrun_wavelet.py",
                 "examples/torch_quickstart.py", "examples/torch_wavelet_pipeline.py",
                 "examples/torch_codec_roundtrip.py", "examples/torch_observe_serve.py",
                 "benchmarks/torch_roofline_table.py",
                 "benchmarks/torch_experiments_tables.py"):
        assert must in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_port_file_imports_jax_or_repro(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "benchmarks.gate" not in set(_imported_modules(path))


def test_fresh_interpreter_imports_the_port_without_jax():
    code = (
        "import sys; import repro_torch.serve, repro_torch.kernels, repro_torch.codec, "
        "repro_torch.core.ranges, repro_torch.configs.dwt53, repro_torch.core.compression, "
        "repro_torch.ckpt, repro_torch.train.grad_compress, repro_torch.core.opcount, "
        "repro_torch.core.pe, repro_torch.timing, benchmarks.torch_run, "
        "benchmarks.torch_table2_opcounts, benchmarks.torch_table3_timing, "
        "benchmarks.torch_fig5_lossless, repro_torch.kernels.sharded, repro_torch.sharding, "
        "repro_torch.launch.mesh, repro_torch.collectives, repro_torch.configs, "
        "repro_torch.models.transformer, repro_torch.serve.serve_step, "
        "repro_torch.data.pipeline, repro_torch.train.optim, repro_torch.train.train_step, "
        "repro_torch.launch.train, benchmarks.torch_grad_compression, "
        "benchmarks.torch_ckpt_compression, repro_torch.roofline, repro_torch.launch.dryrun, "
        "repro_torch.launch.dryrun_wavelet, benchmarks.torch_roofline_table, "
        "benchmarks.torch_experiments_tables; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
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
