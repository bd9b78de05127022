"""The paper's own evaluation on the port against the reference, on the CPU.

The PE hardware model (``core.pe``), the op counter over ``make_fx``
graphs (``core.opcount``), the float (5,3) filter bank
(``core.lifting.filterbank53_fwd_float`` and the kernel wrapper's CPU
path) and the port's Table 2 / Fig. 5 / Table 3 benchmarks
(``benchmarks/torch_*.py``), fed the same seeded inputs as ``repro`` and
compared exactly.  The float kernel itself is held against its plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 11).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig5_lossless as RFIG5
from benchmarks import gate as GATE
from benchmarks import table2_opcounts as RT2
from benchmarks import torch_fig5_lossless as TFIG5
from benchmarks import torch_run as TRUN
from benchmarks import torch_table2_opcounts as TT2
from benchmarks import torch_table3_timing as TT3
from repro.core import lifting as RL
from repro.core import opcount as RO
from repro.core import pe as RPE
from repro.core import schemes as RS
from repro_torch import kernels as TK
from repro_torch.core import lifting as TL
from repro_torch.core import opcount as TO
from repro_torch.core import pe as TPE
from repro_torch.core import schemes as TS
from repro_torch.kernels import _build

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)


# ---------------------------------------------------------------------------
# The PE hardware model.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 64, 101])
@pytest.mark.parametrize("mode", MODES)
def test_pe_model_matches_reference_and_the_port_oracle(mode, n):
    x = np.random.default_rng(n).integers(-300, 300, size=n)
    am_t, am_r = TPE.AnalysisModule(mode), RPE.AnalysisModule(mode)
    s_t, d_t = am_t.process(x)
    s_r, d_r = am_r.process(x)
    assert (s_t, d_t) == (s_r, d_r)
    assert am_t.pe.ledger.as_dict() == am_r.pe.ledger.as_dict()
    s_o, d_o = TL.dwt53_fwd_1d(torch.from_numpy(x.astype(np.int32)), mode)
    assert s_t == s_o.tolist() and d_t == d_o.tolist()

    rm_t, rm_r = TPE.ReconstructionModule(mode), RPE.ReconstructionModule(mode)
    out_t = rm_t.process(s_t, d_t)
    assert out_t == rm_r.process(s_r, d_r) == [int(v) for v in x]
    assert rm_t.pe.ledger.as_dict() == rm_r.pe.ledger.as_dict()
    assert out_t == TL.dwt53_inv_1d(s_o, d_o, mode).tolist()


def test_pe_model_refuses_what_the_reference_refuses():
    for mod in (TPE, RPE):
        with pytest.raises(ValueError):
            mod.AnalysisModule("lossy")
        with pytest.raises(ValueError):
            mod.AnalysisModule().process([1])
        with pytest.raises(ValueError):
            mod.ReconstructionModule().process([1, 2, 3], [1])


# ---------------------------------------------------------------------------
# Op counts: make_fx graphs against jaxprs, all five summary keys.
# ---------------------------------------------------------------------------


def test_lifting_pair_counts_equal_reference():
    got = TO.arithmetic_summary(TO.lifting_pair, *TO.example_int_args(4))
    assert got == RO.arithmetic_summary(RO.lifting_pair, *RO.example_int_args(4))
    assert (got["adders"], got["shifters"], got["multipliers"]) == (4, 2, 0)


def test_direct_form_pair_counts_equal_reference():
    got = TO.arithmetic_summary(TO.direct_form_pair, *TO.example_int_args(5))
    assert got == RO.arithmetic_summary(RO.direct_form_pair, *RO.example_int_args(5))
    # the traced direct form: 7 adders and 5 shifters (the paper says 8 / 4)
    assert (got["adders"], got["shifters"], got["multipliers"]) == (7, 5, 0)


@pytest.mark.parametrize("name", SCHEMES)
def test_scheme_counts_equal_reference_and_the_derived_ledger(name):
    got = TO.scheme_arithmetic_summary(name)
    assert got == RO.scheme_arithmetic_summary(name)
    want = TS.get_scheme(name).pair_op_counts()
    assert {k: got[k] for k in want} == want
    assert got["multipliers"] == 0


@pytest.mark.parametrize("w", [1, 2, 3, 5, 7, 9, -3, -7])
def test_wmul_counts_equal_reference(w):
    got = TO.arithmetic_summary(lambda a: TS.wmul(a, w), torch.tensor(3, dtype=torch.int32))
    assert got == RO.arithmetic_summary(lambda a: RS.wmul(a, w), np.int32(3))
    assert got["multipliers"] == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_traced_plain_forward_has_no_multiplies(name, mode):
    x = torch.zeros((2, 64), dtype=torch.int32)
    counts = TO.count_primitives(lambda a: TL.dwt_fwd_1d(a, mode, name), x)
    assert not [k for k in counts if TO._op_name(k) in TO.MUL_PRIMS], counts
    assert TO.arithmetic_summary(lambda a: TL.dwt_fwd_1d(a, mode, name), x)["multipliers"] == 0
    assert counts, "the trace must hold the lifting arithmetic"


def test_filterbank_trace_shows_its_tap_multiplies():
    """The negative control: the counter sees multiplies where there are
    some.  The port's trace holds exactly the two convolutions' 8
    multiplies and 6 adds.  The reference's jaxpr has 2 more ``mul`` and
    2 more ``add`` (and 2 ``iota``: other) from the index arithmetic of
    the ``gather`` jnp emits for ``[..., 0::2]``; a torch strided slice
    is a view, so the port has no twin of them, and the test states the
    difference rather than imitating it."""
    x = np.zeros((1, 16), np.int32)
    got = TO.arithmetic_summary(TL.filterbank53_fwd_float, torch.from_numpy(x))
    assert got == {"adders": 6, "shifters": 0, "multipliers": 8, "other_arith": 0,
                   "total_arith": 14}
    ref = RO.arithmetic_summary(RL.filterbank53_fwd_float, jnp.asarray(x))
    assert ref == {"adders": 8, "shifters": 0, "multipliers": 10, "other_arith": 2,
                   "total_arith": 20}
    counts = TO.count_primitives(TL.filterbank53_fwd_float, torch.from_numpy(x))
    assert counts["aten.mul.Tensor"] == 8 and counts["aten.add.Tensor"] == 6


def test_op_names_bucket_in_place_and_dunder_forms():
    assert TO._op_name("aten.add_.Tensor") == "aten.add"
    assert TO._op_name("aten.__rshift__.Scalar") == "aten.__rshift__"
    assert TO._op_name("aten._to_copy.default") == "aten._to_copy"
    got = TO.arithmetic_summary(lambda a, b: (a.mul_(b), torch.mm(a, b)),
                                torch.ones((2, 2)), torch.ones((2, 2)))
    assert got["multipliers"] == 2


# ---------------------------------------------------------------------------
# The float (5,3) filter bank.
# ---------------------------------------------------------------------------


def _fb_input(rng, kind, rows, n):
    if kind == "8-bit":
        return rng.integers(0, 256, (rows, n)).astype(np.int32)
    x = rng.integers(I32.min, I32.max, (rows, n), dtype=np.int32, endpoint=True)
    x[:, ::3], x[:, 1::3] = I32.min, I32.max
    return x


@pytest.mark.parametrize("kind", ["8-bit", "int32 extremes"])
@pytest.mark.parametrize("n", [3, 4, 5, 16, 17, 255, 256])
def test_float_filterbank_equals_reference(n, kind):
    """Bit-equal (``assert_array_equal``): XLA:CPU contracts no product
    of the reference into an FMA on these inputs."""
    x = _fb_input(np.random.default_rng(n), kind, 5, n)
    s_r, d_r = RL.filterbank53_fwd_float(jnp.asarray(x))
    for fn in (TL.filterbank53_fwd_float, TK.filterbank53_fwd_float):
        s_t, d_t = fn(torch.from_numpy(x))
        assert s_t.dtype == d_t.dtype == torch.float32
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_r))


def test_float_filterbank_lead_dims_and_narrow_dtypes():
    rng = np.random.default_rng(5)
    for dt in (np.int8, np.int16, np.uint8, np.uint16):
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, (2, 3, 33), endpoint=True).astype(dt)
        s_r, d_r = RL.filterbank53_fwd_float(jnp.asarray(x))
        s_t, d_t = TK.filterbank53_fwd_float(torch.from_numpy(x))
        assert s_t.shape == (2, 3, 17) and d_t.shape == (2, 3, 16)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_r))
    np.testing.assert_array_equal(TL.H_LO.numpy(), np.asarray(RL.H_LO))
    np.testing.assert_array_equal(TL.H_HI.numpy(), np.asarray(RL.H_HI))


def test_float_filterbank_wrapper_refuses_what_the_kernel_cannot_take():
    with pytest.raises(TypeError):
        TK.filterbank53_fwd_float(torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(TypeError):
        TK.filterbank53_fwd_float(torch.zeros((2, 8), dtype=torch.float32))
    with pytest.raises(ValueError, match="at least 3"):
        TK.filterbank53_fwd_float(torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="at least 3"):
        TL.filterbank53_fwd_float(torch.zeros((2, 2), dtype=torch.int32))


def test_filterbank_source_is_registered_with_its_c_signature():
    assert "filterbank" in _build.SOURCES
    src = (_build.CSRC / "filterbank.cu").read_text()
    for fn, argtypes in _build._SIGNATURES["filterbank"].items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn
    assert "repro_error_string" in src
    # one rounding a product and a sum, in the plain version's order
    assert "__fmul_rn" in src and "__fadd_rn" in src and "__fmaf" not in src


# ---------------------------------------------------------------------------
# The port's paper benchmarks.
# ---------------------------------------------------------------------------


def test_table2_rows_equal_reference_rows():
    port = TT2.run(device="cpu")
    ref = RT2.run()
    assert [k for k, _, _ in port] == [k for k, _, _ in ref]
    assert {k: v for k, v, _ in port} == {k: v for k, v, _ in ref}
    rows = {k: str(v) for k, v, _ in port}
    assert GATE.check_table2(rows) == []
    assert rows["table2.direct.adders"] == "7" and rows["table2.ops_reduction"] == "2.0"


def test_fig5_rows_equal_reference_rows():
    port = {k: v for k, v, _ in TFIG5.run(device="cpu")}
    ref = {k: v for k, v, _ in RFIG5.run()}
    assert {k: port[k] for k in ref} == ref
    assert set(port) - set(ref) == {"fig5.lossless_kernel_multilevel"}
    assert port["fig5.lossless_kernel_multilevel"] == 1
    assert port["fig5.detail_energy_fraction"] == 0.0747
    np.testing.assert_array_equal(TFIG5.make_fig5_signal(), RFIG5.make_fig5_signal())


def test_table3_rows_exist_and_are_numbers_on_the_cpu():
    rows = TT3.run(device="cpu", small=True)
    names = [k for k, _, _ in rows]
    assert len(names) == len(set(names))
    for key in ("table3.int_lifting_us", "table3.float_filterbank_us", "table3.speedup",
                "table3.ordering_holds"):
        assert key in names
    for shape in ("paper", "a", "b"):
        for impl in TT3.IMPLS:
            for metric in ("ms", "device_ms", "host_us", "bound_ms"):
                assert f"table3.{shape}.{impl}.{metric}" in names
        assert f"table3.{shape}.float_kernel.max_abs_err" in names
    for key, value, note in rows:
        assert isinstance(value, (int, float)), key
        if key.endswith(("device_ms", "host_us")):
            assert np.isnan(value) and "not measured" in note, key  # no card: no device number
    vals = {k: v for k, v, _ in rows}
    assert vals["table3.a.float_kernel.max_abs_err"] == 0.0
    assert vals["table3.b.float_kernel.bound_ms"] == vals["table3.b.int_lifting.bound_ms"]


def test_paper_benchmarks_need_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    for mod in (TT2, TT3, TFIG5):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mod.run()


def test_torch_run_prints_csv_and_exits_nonzero_on_failure(capsys):
    assert TRUN.main(["--only", "table2,fig5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,value,notes"
    assert "fig5.lossless_kernel_multilevel,1," in "\n".join(out)
    assert TRUN.main(["--only", "table9", "--device", "cpu"]) == 1
    assert "table9.ERROR,KeyError" in capsys.readouterr().out
