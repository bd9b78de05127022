"""The port's dry run cell by cell (``repro_torch.launch.dryrun``): the
probes' linear extrapolation equals a full-depth trace of the same probe
config (FLOPs, bytes and the multi-pod wire), and stablelm-1.6b at full
width over every cell of ``SHAPE_SUITE`` (``meta`` tensors: no
allocation), with the reference's SKIP where it gives one and the
sharded-mesh SKIP of the port."""
import dataclasses

import pytest

from repro.configs import get_config as ref_config
from repro.configs import shape_cell as ref_cell
from repro.configs.base import cell_applicable as ref_applicable
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import SHAPE_SUITE, ShapeCell
from repro_torch.launch import dryrun as D

TRAIN = ShapeCell("t64", 64, 2, "train")
ARTIFACT_KEYS = ("status", "reason", "lower_s", "compile_s", "memory_analysis", "cost_analysis",
                 "collectives", "roofline", "probe", "rules", "device", "trace")


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,depth,multi_pod", [
    ("stablelm-1.6b", 4, False), ("stablelm-1.6b", 6, False), ("stablelm-1.6b", 4, True),
    ("recurrentgemma-2b", 4, False), ("recurrentgemma-2b", 6, False),
    ("rwkv6-7b", 4, False), ("phi3.5-moe-42b-a6.6b", 6, False)])
def test_probe_extrapolation_equals_full_depth_trace(arch, depth, multi_pod):
    cell = TRAIN
    mesh, _, multi_pod = D.make_mesh(multi_pod)
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=depth)
    probes = D._probe_costs(cfg, cell, mesh, multi_pod, mesh.size)
    full = D._cost_of(D.probe_cfg(cfg, cell, depth), cell, mesh, multi_pod, mesh.size)
    assert (probes["flops"], probes["bytes"], probes["wire_per_device"]) == full
    assert (full[2] > 0) == multi_pod


# ---------------------------------------------------------------------------
# Full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", [c.name for c in SHAPE_SUITE])
def test_stablelm_full_width_cells(cell):
    r = D.run_cell("stablelm-1.6b", cell, multi_pod=False, save=False)
    ok, why = ref_applicable(ref_config("stablelm-1.6b"), ref_cell(cell))
    if not ok:
        assert (r["status"], r["reason"]) == ("SKIP", why)
        return
    assert r["status"] == "OK", r.get("traceback")
    assert set(ARTIFACT_KEYS) <= set(r)
    rl = r["roofline"]
    assert rl["hlo_flops"] >= 0.8 * rl["model_flops"]
    assert rl["dominant"] in ("compute", "memory", "collective") and rl["collective_s"] == 0
    assert r["trace"]["flops"] >= 0.8 * rl["model_flops"]
    cost = r["cost_analysis"]
    assert (cost["flops"], cost["bytes_accessed"]) == (r["trace"]["flops"], r["trace"]["bytes"])
    assert (rl["hlo_flops"], rl["hlo_bytes"]) == (r["trace"]["flops"], r["trace"]["bytes"])
    assert r["probe"]["equals_trace"]
    mem = r["memory_analysis"]
    assert mem["peak_bytes_est"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["fits"] == (mem["peak_bytes_est"] <= mem["total_memory"])
    assert r["device"]["card"] == D.NO_CARD and r["mesh"] == "h100x1"


def test_a_sharded_mesh_is_a_skip_not_a_failure():
    r = D.run_cell("stablelm-1.6b", "decode_32k", multi_pod=False, save=False,
                   debug_mesh=(1, 2, 1))
    assert (r["status"], r["reason"]) == ("SKIP", D.SKIP_SHARDED)
    assert r["mesh"] == "debug1x2x1"
    assert D.main(["--arch", "stablelm-1.6b", "--cell", "decode_32k", "--debug-mesh", "2,1",
                   "--no-save"]) == 0
