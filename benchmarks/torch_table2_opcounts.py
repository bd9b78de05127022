"""Paper Table 2 on the port: adders/shifters per output pair — LS vs
direct form.

The counterpart of ``benchmarks/table2_opcounts.py``: the same rows,
name for name, counted from a ``make_fx`` graph of the port's own
computation (``repro_torch.core.opcount``) and from the port's copy of
the PE hardware model's operation ledger (``repro_torch.core.pe``).
Tracing and the PE model run on the host, so ``device`` only checks
that the card is there when asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import schemes as S
from repro_torch.core.opcount import (
    arithmetic_summary,
    direct_form_pair,
    example_int_args,
    lifting_pair,
    scheme_arithmetic_summary,
)
from repro_torch.core.pe import AnalysisModule, ReconstructionModule


def run(device: str = "cuda") -> list:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("table2: device='cuda' but no CUDA card; pass device='cpu'")
    rows = []
    ls = arithmetic_summary(lifting_pair, *example_int_args(4))
    direct = arithmetic_summary(direct_form_pair, *example_int_args(5))
    rows.append(("table2.ls.adders", ls["adders"], "paper claims 4"))
    rows.append(("table2.ls.shifters", ls["shifters"], "paper claims 2"))
    rows.append(("table2.ls.multipliers", ls["multipliers"], "multiplierless => 0"))
    # per-scheme ledger: every registered lifting scheme, traced from the
    # port's own step application — multipliers must be 0 for all of them
    for name in S.available_schemes():
        traced = scheme_arithmetic_summary(name)
        sch = S.get_scheme(name)
        rows.append(
            (
                f"table2.scheme.{name}.adders",
                traced["adders"],
                f"derived ledger says {sch.pair_op_counts()['adders']}",
            )
        )
        rows.append(
            (
                f"table2.scheme.{name}.shifters",
                traced["shifters"],
                f"derived ledger says {sch.pair_op_counts()['shifters']}",
            )
        )
        rows.append(
            (
                f"table2.scheme.{name}.multipliers",
                traced["multipliers"],
                "multiplierless => 0 for every registered scheme",
            )
        )
    rows.append(("table2.direct.adders", direct["adders"], "paper (Kishore) claims 8"))
    rows.append(("table2.direct.shifters", direct["shifters"], "paper (Kishore) claims 4"))
    rows.append(
        (
            "table2.ops_reduction",
            round(direct["total_arith"] / ls["total_arith"], 3),
            "LS vs standard filterbank total ops",
        )
    )
    # PE hardware-model ledger (per output pair over a 64-sample frame)
    x = np.random.default_rng(0).integers(0, 255, size=64)
    am = AnalysisModule()
    s, d = am.process(x)
    rm = ReconstructionModule()
    rm.process(s, d)
    pairs = 32
    rows.append(("table2.pe.analysis.adds_per_pair", am.pe.ledger.adds / pairs, "4 in paper"))
    rows.append(("table2.pe.analysis.shifts_per_pair", am.pe.ledger.shifts / pairs, "2 in paper"))
    rows.append(
        (
            "table2.pe.fwd_bwd_complexity_equal",
            int(am.pe.ledger.adds == rm.pe.ledger.adds and am.pe.ledger.shifts == rm.pe.ledger.shifts),
            "paper conclusion: same complexity",
        )
    )
    return rows
