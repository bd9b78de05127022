"""Quickstart on the port: the paper's integer (5,3) lifting DWT in five
minutes (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card by default, where the transforms launch the
hand-written kernels and "kernel == plain?" holds them against their
plain PyTorch versions; ``--device cpu`` runs the plain versions and
compares nothing.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import lifting as L
from repro_torch.core import schemes as SCH
from repro_torch.core.opcount import arithmetic_summary, example_int_args, lifting_pair
from repro_torch.core.pe import AnalysisModule, ReconstructionModule
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = torch.device(ap.parse_args(argv).device)

    # --- the paper's Fig.5 experiment: 64 samples, lossless round trip ----
    rng = np.random.default_rng(2010)
    x = torch.from_numpy(
        np.clip(np.round(rng.normal(128, 40, size=64)), 0, 255).astype(np.int32)[None]
    ).to(dev)
    s, d = L.dwt53_fwd_1d(x)  # eq. (5) + eq. (7)
    x_rec = L.dwt53_inv_1d(s, d)  # eqs. (8)-(10)
    print("signal[:8]       ", x.cpu().numpy()[0, :8])
    print("approx s[:4]     ", s.cpu().numpy()[0, :4])
    print("details d[:4]    ", d.cpu().numpy()[0, :4])
    print("lossless?        ", bool(torch.equal(x_rec, x)))

    # --- multi-level + non-power-of-two length ----------------------------
    y = torch.from_numpy(rng.integers(0, 255, size=(1, 321)).astype(np.int32)).to(dev)
    pyr = L.dwt53_fwd(y, levels=4)
    print("321 samples, 4 levels, lossless?", bool(torch.equal(L.dwt53_inv(pyr), y)))

    # --- the multiplierless claim (Table 2) -------------------------------
    print("ops per output pair:", arithmetic_summary(lifting_pair, *example_int_args(4)))

    # --- the hardware PE model (Fig. 2-4) ---------------------------------
    samples = x.cpu().numpy()[0]
    am = AnalysisModule()
    s_pe, d_pe = am.process(samples)
    rm = ReconstructionModule()
    ok = rm.process(s_pe, d_pe) == [int(v) for v in samples]
    print("PE model bit-exact?", ok, "| ledger:", am.pe.ledger.as_dict())

    # --- the kernel engine: the hand-written kernels on a CUDA tensor, their
    # plain PyTorch versions on a CPU tensor ------------------------------
    big_host = rng.integers(0, 255, size=(8, 4096)).astype(np.int32)
    big = torch.from_numpy(big_host).to(dev)
    s_k, d_k = ops.dwt53_fwd_1d(big)
    print("kernel engine lossless?", bool(torch.equal(ops.dwt53_inv_1d(s_k, d_k), big)))
    if dev.type == "cuda":
        s_p, d_p = ops.dwt53_fwd_1d(torch.from_numpy(big_host))
        print("kernel == plain?", bool(torch.equal(s_k.cpu(), s_p) and torch.equal(d_k.cpu(), d_p)))
    else:
        print("kernel == plain? not compared: --device cpu runs the plain versions")

    # --- scheme selection: the (5,3) is one entry in a lifting-scheme
    # registry; every transform takes scheme="haar" / "cdf22" / "97m" /
    # anything you register (core/schemes.py) — same multiplierless
    # shift-add contract, same bit-exact invertibility, derived halos ----
    for name in SCH.available_schemes():
        sch = SCH.get_scheme(name)
        s_n, d_n = ops.dwt_fwd_1d(big, scheme=name)
        ok = bool(torch.equal(ops.dwt_inv_1d(s_n, d_n, scheme=name), big))
        print(
            f"scheme {name:6s} halo={sch.halo} "
            f"ops/pair={sch.pair_op_counts()} lossless? {ok}"
        )


if __name__ == "__main__":
    main()
