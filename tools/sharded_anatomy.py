"""Where the time of the sharded (mesh) serve step goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/sharded_anatomy.py [--reps N] [--json-out PATH]

(``--device cpu`` runs the same steps on the plain versions over a gloo
rank: a rehearsal of the control flow, whose times are not the card's.)

On a one-rank NCCL mesh (one GPU admits one NCCL rank), the pieces of one
serve step of the 8 x 2048^2 batch (cdf53 / jpeg2000, 5 levels, 8-bit
samples) are timed alone, each the median host ms of ``--reps`` calls
ending in a device sync, in turns with the mesh-less path they replace:

  * ``forward``: ``dwt_fwd_2d_multi`` of the batch already on the card;
    the sharded forward from the same tensor on the card; and from the
    host batch (the engine's call: each rank moves only its rows);
  * ``level``: one level of the sharded forward on the card
    (``sharded._fwd_level_local``: the crop copies, no exchange on one
    rank) against ``dwt_fwd_2d_multi(levels=1)`` of the same rows;
  * ``gather``: ``full_tensor()`` of the 16 bands;
  * ``encode``: ``codec.container.encode_batch`` of the mesh-less
    pyramid (band views of one allocation) and of the gathered one;
  * ``step``: one engine step with and without the mesh (the host batch
    built, moved, transformed, encoded).

Every output is checked equal to the mesh-less one before it is timed.
Prints the card's name and power limit beside every number.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.timing import card_line  # noqa: E402

SHAPE, LEVELS, SCHEME, MODE = (8, 2048, 2048), 5, "cdf53", "jpeg2000"  # phase 3's batch


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int) -> float:
    """Median host ms of ``fn()`` followed by a device sync (two warm-ups)."""
    times = []
    for i in range(reps + 2):
        _sync(dev)
        t = time.perf_counter()
        fn()
        _sync(dev)
        if i >= 2:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _leaves(pyr):
    return [pyr.ll] + [b for lvl in pyr.details for b in lvl]


def _same(a, b) -> None:
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        if not torch.equal(x, y):
            raise AssertionError("sharded pyramid differs from the mesh-less one")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json-out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sharded_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.codec import container
    from repro_torch.kernels import sharded as SHD
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.serve import TransformRequest, WaveletServeEngine

    if args.device == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card, backend = card_line(), "nccl"
    else:
        dev, card, backend = torch.device("cpu"), "CPU rehearsal, not the card", "gloo"
    tmp = tempfile.mkdtemp()
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1,
                            rank=0)
    mesh = make_mesh_compat((1,), ("data",), dev.type)
    rng = np.random.default_rng(0)
    host = torch.from_numpy(rng.integers(-128, 128, SHAPE, dtype=np.int32))
    xd = host.to(dev)
    kw = dict(levels=LEVELS, mode=MODE, scheme=SCHEME)
    rec = {"card": card, "reps": args.reps}
    try:
        want = K.dwt_fwd_2d_multi(xd, **kw)
        got = SHD.dwt_fwd_2d_sharded(host, mesh, **kw)
        gathered = type(got)(got.ll.full_tensor(),
                             tuple(tuple(b.full_tensor() for b in lvl) for lvl in got.details))
        _same(gathered, want)
        rec["forward"] = {
            "meshless_on_card": host_ms(lambda: K.dwt_fwd_2d_multi(xd, **kw), dev, args.reps),
            "sharded_on_card": host_ms(lambda: SHD.dwt_fwd_2d_sharded(xd, mesh, **kw), dev,
                                       args.reps),
            "sharded_from_host": host_ms(lambda: SHD.dwt_fwd_2d_sharded(host, mesh, **kw), dev,
                                         args.reps),
            "meshless_from_host": host_ms(lambda: K.dwt_fwd_2d_multi(host.to(dev), **kw), dev,
                                          args.reps),
        }
        comm = SHD.AxisComm(mesh, "data")
        lv = {}
        x = xd
        for level in range(LEVELS):
            sh = SHD._fwd_level_local(x, SCHEME, MODE, comm)
            one = K.dwt_fwd_2d_multi(x, levels=1, mode=MODE, scheme=SCHEME)
            for a, b in zip(sh, [one.ll] + list(one.details[0])):
                if not torch.equal(a, b):
                    raise AssertionError(f"level {level + 1}: crop differs")
            lv[f"level {level + 1} {tuple(x.shape)}"] = {
                "sharded_level": host_ms(lambda x=x: SHD._fwd_level_local(x, SCHEME, MODE, comm),
                                         dev, args.reps),
                "one_level_call": host_ms(
                    lambda x=x: K.dwt_fwd_2d_multi(x, levels=1, mode=MODE, scheme=SCHEME), dev,
                    args.reps)}
            x = sh[0]
        rec["level"] = lv
        rec["gather_ms"] = host_ms(lambda: [b.full_tensor() for b in _leaves(got)], dev,
                                   args.reps)
        enc_plain = container.encode_batch(want, scheme=SCHEME, mode=MODE)
        if container.encode_batch(gathered, scheme=SCHEME, mode=MODE) != enc_plain:
            raise AssertionError("containers differ")
        rec["encode"] = {
            "meshless_pyramid": host_ms(
                lambda: container.encode_batch(want, scheme=SCHEME, mode=MODE), dev, args.reps),
            "gathered_pyramid": host_ms(
                lambda: container.encode_batch(gathered, scheme=SCHEME, mode=MODE), dev,
                args.reps),
        }
        images = [h.numpy() for h in host]
        steps = {}
        for label, m in (("mesh", mesh), ("meshless", None), ("meshless ", None),
                         ("mesh ", mesh)):
            eng = WaveletServeEngine(buckets=[SHAPE[1:]], batch_slots=SHAPE[0], levels=LEVELS,
                                     scheme=SCHEME, mode=MODE, device=str(dev),
                                     encode_response=True, mesh=m)
            eng.warmup()

            def step(eng=eng):
                for i, img in enumerate(images):
                    eng.submit(TransformRequest(uid=i, image=img))
                eng.step()

            steps.setdefault(label.strip(), []).append(host_ms(step, dev, args.reps))
        rec["encoded_step_ms"] = steps
    finally:
        dist.destroy_process_group()
    for key, val in rec.items():
        print(f"{key}: {val}" + ("" if key in ("card", "reps") else f" ({card})"))
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
