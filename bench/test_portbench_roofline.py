"""The yardstick on the CPU: a round trip's needed bytes and bound, the
reduction of a device trace, and the per-layer readers on made-up
readings (the numbers are hand-worked, none is a measurement)."""
import pytest

from bench import devtrace, harness, roofline


@pytest.mark.parametrize("name,samples,nbytes,ms", [
    # 32 x 2048^2 = 134,217,728 samples; x 16 B; at 3.35 TB/s
    ("jp2k2d.frames-2048", 134_217_728, 2_147_483_648, 0.641040),
    # 8 x 64 x 512^2 = 134,217,728 samples; x 16 B
    ("jp3d.ct-512", 134_217_728, 2_147_483_648, 0.641040),
])
def test_cell_roundtrip_bytes_and_bound(name, samples, nbytes, ms):
    cell = harness.find_cell(name)
    batch, shape = cell.traffic["batch"], cell.config["shape"]
    assert batch * shape[0] * shape[1] * (shape[2] if len(shape) > 2 else 1) == samples
    got = roofline.roundtrip_bytes(batch, shape, 4)
    assert got == nbytes == samples * 16
    assert roofline.bound_ms(got) == pytest.approx(ms, abs=5e-7)


def test_peak_is_the_data_sheet_figure():
    assert roofline.PEAK_BYTES_PER_S == 3.35e12


def test_summarise_busy_gaps_and_names():
    dev = [("void k1(int)", 0.0, 10.0), ("void k2", 10.0, 15.0), ("k1(int)", 20.0, 30.0),
           ("Memcpy DtoD", 25.0, 28.0), ("k2", 40.0, 41.0)]
    host = [("cudaLaunchKernel", 16.0, 19.0), ("cudaLaunchKernel", 31.0, 32.0)]
    s = devtrace.summarise(dev, host)
    assert s.window_s == pytest.approx(41e-6)
    assert s.busy_s == pytest.approx(26e-6)  # 0-15, 20-30, 40-41
    assert s.device_op_s == pytest.approx(29e-6)  # the copy overlaps a kernel
    assert s.longest_gap_s == pytest.approx(10e-6)
    assert s.idle_gaps == [("python before k2", pytest.approx(10e-6)),
                           ("cudaLaunchKernel before k1", pytest.approx(5e-6))]
    assert s.device_ops[0] == ("k1", pytest.approx(20e-6))
    with pytest.raises(ValueError):
        devtrace.summarise([], host)


def _ctx(trace):
    return {"submitted": 100, "window_batches": 98, "window_s": 0.2, "host_s": 0.08,
            "launches": {"tiled2d_fwd": 400, "whole2d_fwd": 100},
            "bytes_per_batch": 1_073_741_824, "trace": trace, "trace_batches": 200}


def test_readers_on_made_up_readings():
    cell = harness.find_cell("jp3d.ct-512")
    s = devtrace.Summary(window_s=0.5, busy_s=0.4, device_op_s=0.4, longest_gap_s=0.002,
                         device_ops=[], idle_gaps=[])
    got = {k: v["value"] for k, v in harness.read_per_layer(cell, _ctx(s)).items()}
    assert set(got) == {m["name"] for m in cell.per_layer}
    assert got["dispatch.host_ms"] == pytest.approx(0.8)
    assert got["dispatch.launches"] == pytest.approx(5.0)
    assert got["kernels.device_ms"] == pytest.approx(2.0)
    assert got["roundtrip_roofline"] == pytest.approx(0.320520 / 2.0 * 100, rel=1e-5)
    assert got["device.idle_pct"] == pytest.approx(20.0)
    assert got["device.longest_gap_ms"] == pytest.approx(2.0)
    # 1 GiB a batch in 0.2 / 98 s, against 3.35 TB/s
    assert got["batch.peak_bw_pct"] == pytest.approx(1_073_741_824 * 98 / 0.2 / 3.35e12 * 100)


def test_readers_find_nothing_without_a_trace_or_launches():
    cell = harness.find_cell("jp2k2d.frames-2048")
    ctx = dict(_ctx(None), launches={})
    assert set(harness.read_per_layer(cell, ctx)) == {"dispatch.host_ms", "batch.peak_bw_pct"}
