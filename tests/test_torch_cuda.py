"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Kernels written in CUDA have no CPU mode, so every test here is marked
``cuda`` and skips without a card.  This file imports no JAX (the card's
machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest names the reference's warning
classes, which import JAX).  ``chip_smoke.py`` runs the same comparisons
at the serve path's real sizes.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as TK
from repro_torch.core import schemes as TS
from repro_torch.kernels import fused2d as TF
from repro_torch.kernels import tiled2d as TT
from repro_torch.serve import WaveletServeEngine, TransformRequest, crop_result

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)


@pytest.fixture
def cuda_device():
    """The card, or a skip: kernels written in CUDA have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there (chip_smoke.py)")
    return torch.device("cuda")


def _img(rng, shape, lo=-1000, hi=1000):
    return rng.integers(lo, hi, shape).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCHEMES)
def test_cuda_kernels_match_plain_versions(name, mode, cuda_device):
    rng = np.random.default_rng(7)
    sch = TS.get_scheme(name)
    for hw in [(2, 2), (3, 3), (7, 9), (257, 383), (512, 512)]:
        for kind in ("rand", "min", "max"):
            x = _img(rng, (2,) + hw) if kind == "rand" else np.full(
                (2,) + hw, I32.min if kind == "min" else I32.max, np.int32)
            xt = torch.from_numpy(x).to(cuda_device)
            want = TF._fwd2d_math(xt, mode, name)
            for a, b in zip(TF.fwd2d_whole_cuda(xt, mode, name), want):
                assert torch.equal(a, b)
            assert torch.equal(TF.inv2d_whole_cuda(*want, mode, name),
                               TF._inv2d_math(*want, mode, name))
            if sch.can_window(hw[0]) and sch.can_window(hw[1]):
                for th, tw in ((4, 6), (64, 64)):
                    for a, b in zip(TT.fwd2d_tiled_cuda(xt, mode, th, tw, name),
                                    TT.fwd2d_tiled_plain(xt, mode, th, tw, name)):
                        assert torch.equal(a, b)
                    assert torch.equal(TT.inv2d_tiled_cuda(*want, mode, th, tw, name),
                                       TT.inv2d_tiled_plain(*want, mode, th, tw, name))
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
def test_cuda_pyramid_launches_every_kernel(cuda_device):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_img(rng, (2, 512, 512), -128, 128)).to(cuda_device)
    TK.launches.reset()
    pyr = TK.dwt_fwd_2d_multi(x, levels=3, scheme="cdf53", mode="jpeg2000")
    y = TK.dwt_inv_2d_multi(pyr, scheme="cdf53", mode="jpeg2000")
    assert torch.equal(y, x)
    counts = TK.launches.snapshot()
    assert all(counts.get(k, 0) > 0 for k in
               ("tiled2d_fwd", "tiled2d_inv", "whole2d_fwd", "whole2d_inv")), counts


@pytest.mark.cuda
def test_cuda_engine_serves_what_the_cpu_engine_serves(cuda_device):
    rng = np.random.default_rng(9)
    images = [_img(rng, s, -128, 128) for s in [(300, 300), (256, 256), (200, 280), (64, 64)]]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = WaveletServeEngine(buckets=[(64, 64), (300, 300)], batch_slots=2, levels=3,
                                 device=dev)
        done = eng.run([TransformRequest(uid=i, image=im) for i, im in enumerate(images)])
        out[dev] = sorted(done, key=lambda r: r.uid)
    for c, g in zip(out["cpu"], out["cuda"]):
        for a, b in zip([c.pyramid.ll] + [t for lvl in c.pyramid.details for t in lvl],
                        [g.pyramid.ll] + [t for lvl in g.pyramid.details for t in lvl]):
            assert torch.equal(a, b.cpu())
        xr = crop_result(TK.dwt_inv_2d_multi(g.pyramid), g)
        assert torch.equal(xr.cpu(), torch.from_numpy(g.image))
