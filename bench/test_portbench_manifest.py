"""``BENCHMARK.json``'s schema and limits, the harness's
isolation from JAX and the JAX package, and the lookup of every piece by
file name (a new cell or metric is a new file, never an edit)."""
import ast
import json
import re
import shutil
import sys

import pytest
import torch

from bench import harness

ROOT = harness.ROOT
BENCH = harness.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BANNED = {"jax", "jaxlib", "flax", "repro"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def _imports(path):
    """Top-level names of every module ``path`` imports (absolute imports)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_under_bench_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & BANNED, path


def test_reference_imports_nothing_of_the_port():
    assert set(_imports(BENCH / "reference.py")) <= {"__future__", "typing", "numpy"}


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    allowed, banned = ("repro_torch_like", "jaxish", "reproducible"), ("jax.numpy", "repro")
    for name in allowed + banned:
        monkeypatch.setitem(sys.modules, name, sys)
    found = harness.banned_modules()
    assert set(banned) <= set(found) and not set(allowed) & set(found)


def test_top_level_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "bench/run.py"]
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and p != "benchmarks"
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(manifest["workloads"])
    # 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell to compile,
    # 1200 s spare, in 43200 s with the full 24 cells
    full = (2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 180 + 1200
    assert 1 <= cells <= 24 and full <= 43200


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        for key in ("scheme", "mode", "levels", "ndim", "shape", "bits", "dtype",
                    "content", "reference", "assumed", "guarantees"):
            assert key in body, key
        assert (BENCH / "inputs" / f"{body['content']}.py").is_file()
        assert (BENCH / f"{body['reference']}.py").is_file()


def test_workloads(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    names = [w["name"] for w in manifest["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(manifest["per_layer"]) <= 128
    names = list(e2e) + [m["name"] for m in manifest["per_layer"]]
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        # every cell that reports this metric reports the metric it moves
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), layers
    for cell in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        mine = [m for m in manifest["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in manifest["per_layer"])


def test_find_cell_reads_every_piece_by_name(manifest):
    for w in manifest["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.chips == w["chips"]
        assert cell.traffic["driver"] == "roundtrip"
        assert {m["name"] for m in cell.per_layer} <= {m["name"] for m in manifest["per_layer"]}
        for m in cell.per_layer:
            assert callable(harness.metric_reader(cell, m["name"]).read)
    with pytest.raises(KeyError):
        harness.find_cell("no-such-cell")


def test_a_new_cell_and_metric_are_files_not_edits(tmp_path):
    """A copy of the benchmark gains a cell (a traffic file and an entry in
    BENCHMARK.json) and a per-layer metric (a reader file), with no other
    file edited, and a run on the CPU picks both up."""
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = harness.load_manifest()
    manifest["workloads"].append({"name": "jp3d.ct-tiny", "config": "jp3d-rev53-ct12",
                                  "traffic": "roundtrip.tiny", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "test.batches", "unit": "batches", "better": "higher",
                                  "source": "host_clock", "layer": "round trip: test",
                                  "moves": "roundtrip_msps", "workloads": ["jp3d.ct-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = dict(json.loads((BENCH / "traffic" / "roundtrip.b8.q3.json").read_text()),
                   batch=2, check_span=2, trace_batches=3)
    (tmp_path / "bench" / "traffic" / "roundtrip.tiny.json").write_text(json.dumps(traffic))
    (tmp_path / "bench" / "metrics" / "test.batches.py").write_text(
        "def read(ctx):\n    return float(ctx['window_batches'])\n")
    before = {p.relative_to(BENCH): p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    cell = harness.find_cell("jp3d.ct-tiny", root=tmp_path)
    assert cell.root == tmp_path and cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["test.batches"]
    cell.config.update(shape=[6, 8, 10], levels=2)
    res = harness.measure(cell, 2**31 + 3, 0.2, True, torch.device("cpu"), 0.0)
    assert res["correct"] and res["metrics"]["test.batches"]["value"] >= 1
    assert list(res)[-1] == "checks"
    after = {p.relative_to(BENCH): p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert before == after
