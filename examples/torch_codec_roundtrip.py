"""Lossless entropy-coded bitstreams over the integer wavelet bands, on
the port (``examples/codec_roundtrip.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_codec_roundtrip.py [--device cpu]

The multiplierless DWT is the front half of a lossless coder; this demo
runs the back half (``repro_torch.codec``): a checkpoint-like tensor and
a 3-D volume become self-describing WZRC / WZRS bytes, decode bit-exactly
from those bytes alone, and beat plain zlib while doing it.  Runs on the
card by default (the 1-D, 2-D and 3-D kernels and the Rice kernels);
``--device cpu`` runs their plain PyTorch versions.  The bytes are the
same either way.
"""
import argparse
import zlib

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.ckpt.checkpoint import _decode, _encode
from repro_torch.codec import container, stream


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = torch.device(ap.parse_args(argv).device)
    rng = np.random.default_rng(2010)

    # --- checkpoint-like smooth tensor: wz-rice vs plain zlib -------------
    yy, xx = np.meshgrid(
        np.linspace(0, 2, 192), np.linspace(0, 2, 128), indexing="ij"
    )
    w = (np.sin(yy + xx) + 0.01 * rng.normal(size=yy.shape)).astype(np.float32)
    rice_bytes, meta = _encode(torch.from_numpy(w).to(dev), "wz-rice", 2)
    zlib_bytes = zlib.compress(w.tobytes(), level=1)
    restored = _decode(rice_bytes, w.shape, "float32", "wz-rice", meta, dev).cpu().numpy()
    print(f"smooth {w.shape} fp32 tensor: raw {w.nbytes}B")
    print(f"  plain zlib : {len(zlib_bytes)}B ({w.nbytes / len(zlib_bytes):.2f}x)")
    print(f"  wz-rice    : {len(rice_bytes)}B ({w.nbytes / len(rice_bytes):.2f}x)")
    print(f"  beats zlib by {len(zlib_bytes) / len(rice_bytes):.2f}x, "
          f"max restore err {np.max(np.abs(restored - w)):.2e} "
          f"(<= scale/2 = {meta['scale'] / 2:.2e})")

    # --- integer pyramid -> bytes -> pyramid, bit-exact -------------------
    img = torch.from_numpy(rng.integers(-2000, 2000, (64, 64)).astype(np.int32)).to(dev)
    pyr = K.dwt_fwd_2d_multi(img, levels=3, scheme="97m")
    blob = container.encode_pyramid(pyr, scheme="97m")
    dec = container.decode_pyramid(blob, device=dev)  # bytes alone: self-describing
    back = container.inverse_transform(dec)
    print(f"\n2D pyramid (97m, 3 levels): {len(blob)}B, header {container.peek(blob)['shape']}")
    print("  bit-exact roundtrip?", bool(torch.equal(back, img)))

    # --- 3-D volume, streamed per depth-slab ------------------------------
    t = np.linspace(0, 4, 24)
    vol = np.round(
        3000 * np.sin(t)[:, None, None] * np.cos(t)[None, :24, None]
        * np.sin(t + 1)[None, None, :24]
        + 20 * rng.normal(size=(24, 24, 24))
    ).astype(np.int32)
    frames = list(stream.encode_volume(vol, slab=8, levels=2, scheme="cdf53", device=dev))
    data = b"".join(frames)
    out = stream.decode_volume(data, device=dev)
    print(f"\n3-D volume {vol.shape}: raw {vol.nbytes}B -> "
          f"{len(data)}B in {len(frames) - 2} slab frames "
          f"({vol.nbytes / len(data):.2f}x vs int32, "
          f"zlib gets {vol.nbytes / len(zlib.compress(vol.tobytes(), 1)):.2f}x)")
    print("  bit-exact roundtrip?", bool(np.array_equal(out.cpu().numpy(), vol)))


if __name__ == "__main__":
    main()
