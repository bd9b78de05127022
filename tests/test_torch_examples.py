"""The four ported examples (``examples/torch_quickstart.py``,
``torch_wavelet_pipeline.py``, ``torch_codec_roundtrip.py``,
``torch_observe_serve.py``) run with ``--device cpu`` beside the
reference's examples, in a temporary working directory: every flag they
print is True, and their numbers equal the reference's.  The one line
that differs by design is quickstart's "interpret == compiled?", which
the port prints as "kernel == plain?" (on the card; on the CPU it says
it compares nothing).  Quickstart prints only the lifting pair's op
counts, so the float filter bank's recorded difference (ROADMAP Queue 3,
"Op counts (PR 25)") does not show here."""
import importlib.util
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_ONLY = "kernel == plain?"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, capsys, argv=None):
    mod = _load(name)
    got = mod.main() if argv is None else mod.main(argv)
    return capsys.readouterr().out.splitlines(), got


def _flags(lines):
    """The flags the example prints: each line that asks a question
    (``?``) or names losslessness, with the True / False words that
    follow a ``?`` or ``:`` in it."""
    return [(line, re.findall(r"[?:]\s*(True|False)\b", line)) for line in lines
            if "?" in line or "lossless" in line]


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("name", ["quickstart", "wavelet_pipeline", "codec_roundtrip"])
def test_example_prints_what_the_reference_prints(name, in_tmp, capsys):
    port, _ = _run(f"torch_{name}", capsys, ["--device", "cpu"])
    ref, _ = _run(name, capsys)
    flags = _flags(port)
    assert flags and all(v == ["True"] for line, v in flags if not line.startswith(PORT_ONLY))
    if name == "quickstart":
        (line,) = [ln for ln in port if ln.startswith(PORT_ONLY)]
        assert "not compared" in line
        ref = [ln for ln in ref if not ln.startswith("interpret == compiled?")]
        port = [ln for ln in port if not ln.startswith(PORT_ONLY)]
    assert port == ref


def test_observe_serve_records_what_the_reference_records(in_tmp, capsys):
    lines, snap = _run("torch_observe_serve", capsys, ["--device", "cpu"])
    trace = json.loads((in_tmp / "observe_serve_trace.json").read_text())
    assert trace["traceEvents"]
    (episode,) = [ln for ln in lines if ln.startswith("retry episode:")]
    assert episode.startswith("retry episode: 1 retry -> 1 heal")
    assert any("RetryWarning" in ln for ln in lines if ln.startswith("served 8 requests"))

    def names(metrics):
        return {k.split("{")[0] for k in metrics}

    _run("observe_serve", capsys)
    from repro import obs as ROBS

    # the reference's names, less its backend-dispatch counter (the port
    # has no backend= and records no dispatch)
    assert names(snap["metrics"]) == names(ROBS.snapshot()["metrics"]) - {"kernels.dispatch"}
    assert set(snap["events"]) == set(ROBS.snapshot()["events"])
