"""The output check sees planted faults and the controls, on the CPU.

Each test drives a whole run of a cell (``harness.measure``: inputs,
warm-up, window, check), skipping only the look for a card, at a small
size, with the timed path broken underneath, and reads ``correct``.
The faults a round trip on one card can have: a step that returns its
state unchanged, half of the batch left out, an answer altered where it
is produced (a band, an output sample).  The controls are those of
``bench/control.py``.
"""
import subprocess
import sys

import pytest
import torch

from bench import control, harness

CPU = torch.device("cpu")
SMALL = {"jp2k2d.frames-2048": dict(shape=[40, 36], levels=3),
         "jp3d.ct-512": dict(shape=[10, 12, 14], levels=2)}


def _cell(name):
    cell = harness.find_cell(name)
    cell.config.update(SMALL[name])
    cell.traffic.update(batch=2, check_span=3, trace_batches=3)
    return cell


def _run(cell, fwd_inv=None, seed=2**31 + 17):
    return harness.measure(cell, seed, 0.15, False, CPU, 0.0, fwd_inv=fwd_inv)


def _port(cell):
    return harness.driver(cell).transforms(cell.config)


def _stale(cell):
    """The inverse hands back the previous batch's output unchanged."""
    fwd, inv = _port(cell)
    prev = []

    def stale_inv(pyr):
        out = inv(pyr)
        prev.append(out)
        return prev[-2] if len(prev) > 1 else out
    return fwd, stale_inv


def _half(cell):
    """Only the first half of the batch is transformed; the rest of the
    bands and outputs are left zero."""
    fwd, inv = _port(cell)

    def half_fwd(x):
        n = x.shape[0] // 2
        part = fwd(x[:n])
        grow = lambda t: torch.cat([t, torch.zeros((x.shape[0] - n,) + t.shape[1:], dtype=t.dtype)])
        return type(part)(grow(part[0]), tuple(tuple(grow(b) for b in lvl) for lvl in part[1]))

    def half_inv(pyr):
        n = pyr[0].shape[0] // 2
        out = inv(type(pyr)(pyr[0][:n], tuple(tuple(b[:n] for b in lvl) for lvl in pyr[1])))
        return torch.cat([out, torch.zeros((pyr[0].shape[0] - n,) + out.shape[1:], dtype=out.dtype)])
    return half_fwd, half_inv


def _band_altered(cell):
    """One sample of the finest level's last band is off by one."""
    fwd, inv = _port(cell)

    def bad_fwd(x):
        pyr = fwd(x)
        band = pyr[1][-1][-1].clone()
        band.view(-1)[band.numel() // 2] += 1
        return type(pyr)(pyr[0], pyr[1][:-1] + (pyr[1][-1][:-1] + (band,),))
    return bad_fwd, inv


def _output_altered(cell):
    """One reconstructed sample is off by one."""
    fwd, inv = _port(cell)

    def bad_inv(pyr):
        out = inv(pyr).clone()
        out.view(-1)[7] -= 1
        return out
    return fwd, bad_inv


FAULTS = {"stale": _stale, "half_batch": _half, "band_altered": _band_altered,
          "output_altered": _output_altered}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    res = _run(_cell(name))
    assert res["correct"], res["checks"]
    assert res["checks"]["batches_checked"]["value"] == 2
    assert set(res["metrics"]) == {"roundtrip_msps", "batch_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_planted_fault_is_not_correct(name, fault):
    cell = _cell(name)
    res = _run(cell, FAULTS[fault](cell))
    assert not res["correct"], (fault, res["checks"])
    assert res["failed"] >= 1


@pytest.mark.parametrize("control_name,correct", [("program", True), ("int16", False),
                                                  ("int16-values", True), ("paper", False)])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_controls(name, control_name, correct):
    """``int16`` fails by its dtype alone: at 8- and 12-bit content every
    value fits 16 bits (``int16-values``); ``paper`` fails the bands."""
    cell = _cell(name)
    res = _run(cell, control.variants(cell)[control_name])
    assert res["correct"] is correct, res["checks"]
    if control_name == "paper":
        assert res["checks"]["band_mismatches"]["value"] > 0
        assert res["checks"]["recon_mismatches"]["value"] == 0


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload", "jp3d.ct-512",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode == 3 and proc.stdout == ""
    assert "no CUDA card" in proc.stderr
