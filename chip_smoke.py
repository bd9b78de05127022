"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N] [--requests N] [--json-out PATH]

Phases (any failure raises and the script exits nonzero):

1. Print the card's name and power limit, its INT32 rate (SMs x 64
   INT32 lanes x the SM clock's maximum) and the torch version; build
   every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   in parallel) and print the build time.
2. Hold each of the four 2-D kernels (whole-image forward / inverse,
   halo-tiled forward / inverse) against its plain PyTorch version on the
   card with ``torch.equal``: 4 schemes x 2 rounding modes, odd sizes,
   multi-tile grids, int32 extremes, and lines too long for shared memory;
   the tiled kernels at forced (4, 6) and (64, 64) tiles and at the
   default tile, on shapes of at least 3 x 3 default tiles ((2, 600, 520),
   (2, 517, 389): interior tiles that reflect nothing) and on the full
   8 x 2048^2 batch; the whole-image kernels also over runs of 1-3 levels
   in one launch (``fused2d._chain_plan``), at the plan's cluster size and
   forced to every size from 1 to 16 that the chain admits (and to the
   two passes for one level).
   Then hold the Rice encode and decode kernels against theirs: payload
   bytes with ``==``, ``k`` and byte-length tables with ``np.array_equal``,
   decoded bands with ``torch.equal``, on adversarial bands (constant,
   all-escape int32 extremes, one value, empty, cost ties, partial tails,
   multi-thousand-block bands), each alone and all in one launch, and on
   the 16 bands of one 1024^2 x 8 batch in one launch; then malformed
   blocks whose tables pass the host checks (all escapes, under 5 bytes,
   65,535 bytes of garbage, codes running past the bytes, random bytes at
   every k) decoded in one launch beside a well-formed band, each equal to
   ``codec.rice.decode_block_serial``.
3. Serve: ``WaveletServeEngine`` with 1024^2 and 2048^2 buckets, 8 slots,
   5 levels of the reversible 5/3 lift (cdf53, jpeg2000 rounding — JPEG
   2000 Part 1's lossless path) on 8-bit samples with the DC level shift,
   a quarter of the requests undersized.  Every response is
   reconstructed on the card with ``dwt_inv_2d_multi`` and must equal its
   request after the crop; each bucket's first response must equal the
   plain oracle.  The launch counters are reset just before this phase
   and read just after it: every 2-D kernel must have launched, and each
   run of whole-image levels (one a bucket) once each way: ``whole2d_fwd``
   once per batch, ``whole2d_inv`` once per reconstruction.
4. Encoded serve, the same engine with ``encode_response=True`` on half
   random and half smooth 8-bit images: every batch container is decoded
   once on the card (``codec.decode_batch``), inverse-transformed and
   cropped, and every request must equal its image; one batch per bucket
   must be byte-equal to the container built from the plain Rice encode of
   the same bands; ``ProgressiveServeRoute`` thumbnails and full tiers are
   checked; no encode may degrade or quarantine.  The counters are reset
   just before and read just after: all six kernels must have launched,
   ``rice_encode`` once per encoded batch, ``rice_decode`` once per
   decoded container, ``whole2d_fwd`` once per batch and ``whole2d_inv``
   once per client inverse.  One 2048^2 x 8 encoded step is then timed phase by
   phase.
5. 1-D parity: the windowed 1-D kernels (``lift1d.cu``) and the row pass
   (``whole2d.cu``, the 1-D fallback) against their plain versions with
   ``torch.equal``: 4 schemes x 2 modes, n in {2, 3, 5, 15, 16, 17, 31,
   1001, 65536, 65537}, rows in {1, 3, 64}, int32 extremes, leading dims
   (2, 3, n), int8/int16/uint8/uint16/int32 inputs through the library
   entry points; forward, and inverse of the forward's bands.  The run
   kernels (one launch a run of levels) against their plain versions for
   the 4 schemes and a custom scheme of six terms a step (the generic
   term loop), windowed runs and policy runs (cdf22, haar with an odd
   level), runs of 1-6 levels from n in both length sets, at the plan's
   tile, at forced tiles, at int32 extremes and on tensors 4 bytes past
   a 16-byte boundary.
6. The 1-D library path: the repo's ``LARGE``, ``LARGE_HAAR`` and
   ``LARGE_97M`` configs (64 x 65,536 int32, 4 levels; 16-bit samples
   from ``--seed``) through ``kernels.dwt_fwd`` / ``dwt_inv`` with and
   without ``checked=True``; over-range 97m inputs must raise
   ``IntegerOverflowError``; the ``LARGE`` pyramid is coded into a WZRC
   container and decoded and inverted on the card, and four 1-D chunks go
   through a WZRS stream.  The counters are reset just before and read
   just after: both 1-D kernels, the row pass and the Rice kernels must
   have launched (``rice_decode`` once for the container and once per
   stream frame; ``lift1d_fwd`` / ``lift1d_inv`` once each per unchecked
   4-level pyramid, 30 / 13 times in all), and no plain version may have
   been called on a CUDA tensor.  Two unchecked 4-level cdf22 pyramids,
   (a) 64 x 65,536 and (c) one line of 11,534,336 samples, must each be
   one ``lift1d`` launch each way (a policy run) and no ``rows1d``
   launch.  Then the results are held against the plain versions: the
   pyramids and the container and stream bytes must be equal, every
   reconstruction the input.
7. 3-D parity: the whole-volume kernels (``whole3d.cu``: one cluster of
   1-16 blocks per volume, or three passes through device memory where no
   cluster holds it) and the depth-slab kernels (``slab3d.cu``) against
   their plain versions with ``torch.equal``: 4 schemes x 2 modes, shapes
   (2, 2, 2) to (33, 130, 129) and (17, 256, 256), int32 extremes, the
   whole-volume kernels at the geometry's cluster size, forced to the
   three passes and to every other cluster size the shape admits (shapes
   whose geometry picks each size), slabs of depth 2, 4 and the picked
   depth, lines too long for shared memory; shapes that force each
   branch of the slab level's plane pass (H of 2, 3 and 5, odd H and W,
   W % 8 == 0, several strips of rows, haar at odd H and rows too wide
   for a block taking the row and column passes); the 4 x (64, 512, 512)
   cdf53 and 97m batches; the library entry with lead dims (2, 3) and
   with ``REPRO_DWT_SLAB`` = 2 and 4.
8. The 3-D path, with the counters reset just before and read just after
   and a guard counting plain-version calls on CUDA tensors: one
   (64, 512, 512) CT-like 12-bit volume (the repo's ``SHAPE_3D_LARGE``)
   through ``kernels.dwt_fwd_nd`` / ``dwt_inv_nd``, 4 levels, cdf53 /
   jpeg2000 (slabs, then one cluster a volume) and cdf22 / paper (three
   passes, then clusters),
   checked and not; over-range 97m inputs must raise; a 3-D serve engine
   with buckets (16, 256, 256) and (64, 512, 512), 4 slots, 4 levels,
   serving 8 volumes (a quarter undersized) plain and with
   ``encode_response=True``, every container decoded and inverted on the
   card; a thumbnail tier; a WZRS volume stream (slab 8, 3 levels).  All
   four 3-D kernels and the Rice kernels must have launched, no plain
   version may have run on a CUDA tensor.  Then every pyramid must equal
   the plain oracle, every response its request, and the container and
   stream bytes the plain encode; every band of every stream frame
   decoded on the card must equal the plain decode; one encoded 4 x (64,
   512, 512) step is timed phase by phase.
9. Time each kernel with CUDA events at the shapes its path gives it
   (one 2048^2 batch of 8 slots: every level for the 2-D kernels, all 16
   bands for the Rice kernels, whose encode first codes them 20 times in
   a row, each payload byte-equal to the first and to the plain encode,
   and whose decode, one launch for all 16, is also timed as a whole
   ``decode_bands`` call and on the 29 bands of one 4 x (64, 512, 512)
   batch, every band equal to the plain decode; 4-level runs for the 1-D
   run kernels, cdf53 (windowed) and cdf22 (policy) at (a) 64 x 65,536,
   (b) 1024 x 65,536 and (c) one line of 11,534,336 samples, haar
   (policy) at their odd neighbours (one launch each way: events, device
   ms from the profiler, host us a call and launches a call, beside the
   card's name and power limit), the row pass on lines under 8 pairs
   ((3, 13), the 1-D path's, and (4096, 15)); the 4 levels of one 4 x (64, 512, 512)
   batch for the 3-D kernels, and the whole-volume kernels also at every
   other level the 3-D path gives them ((16, 256, 256) bucket levels 3-4,
   a WZRS slab's level 3), at cdf22's level 3 and at the three-pass
   level 1 in cdf22), beside its plain version and its bound, comparing
   outputs once more; for each 2-D level its tile and the kernel's device
   ms (a whole-image level also its host us a call and cluster size, and
   each run of whole levels of the serve path, one bucket's batch and one
   request, its events, device and host time as one launch), for each slab level which plane path ran and the device ms of each
   kernel it launched (``torch.profiler``), for each whole-volume level
   its device ms, the host's us per wrapper call and the cluster size.
10. Checkpoints: stablelm-2-1.6b at full width (``repro_torch.configs``:
   d_model 2048, 32 heads of 64, d_ff 5632, vocab 100,352, LayerNorm
   scale and bias, swiglu, untied head; the parameter tree of
   ``repro_torch.models.transformer.model_defs``), depth cut from 24 to
   4 layers, bfloat16, normal(0, 0.02) from ``--seed`` (scales ones,
   biases zeros).  With the counters reset just before and read just after,
   and the plain-version guard (1-D, 2-D and 3-D plain versions, the Rice
   coder's): the tree saved once with each codec (raw, z, wz, wz2d,
   wz3d, wz-rice; cdf53, 2 levels; and wz with cdf22) through
   ``repro_torch.ckpt.CheckpointManager`` and restored on the card (raw
   and z bit-exact; the wavelet codecs within 0.51 x each leaf's scale
   plus one bfloat16 rounding), each save and restore timed stage by
   stage (the stage functions of ``ckpt/checkpoint.py`` wrapped while it
   runs: a device sync at each stage's ends, CUDA events around each);
   one band of a wz-rice leaf damaged (restore warns
   ``DegradedRestoreWarning`` and returns the undamaged values) and a z
   leaf damaged (``CheckpointIntegrityError``); a ``TrainLoopRunner``
   crashed at step 13 resumes to equal an uninterrupted run; the gradient
   sync's analytic and measured bytes with the spatial codecs off and
   on.  Every kernel the planner names for a leaf must have launched and
   no plain version may have run on a CUDA tensor.  Then, the guard
   paused and the files still on disk, each wavelet leaf's quantized
   int32 must equal the host numpy rule (``torch.equal``), its payload
   the plain versions' chain on the card (``==``), and its restored
   values that rule's int32 times the scale in float32, cast to the
   leaf's dtype (``torch.equal``: the integer transform is lossless); and
   a CUDA divide by a Python float is counted against that rule.
11. The paper's evaluation: the float (5,3) filter-bank kernel
   (``csrc/filterbank.cu``, the card's counterpart of the reference's
   jitted float baseline) against its plain version with ``torch.equal``
   (n in {3, 4, 5, 64, 255, 256, 65,536}, rows in {1, 7, 1024}, 8-bit
   values and int32 extremes, tensors 4 bytes past a 16-byte boundary,
   the wrapper on every accepted dtype); then, with the counters reset
   just before and read just after and the plain-version guard (1-D,
   2-D and the float filter bank's plain versions), the port's paper
   benchmarks: Table 2 (``benchmarks/torch_table2_opcounts.py``: make_fx
   traces and the PE model's ledger; every scheme 0 multipliers, the
   lifting pair 4 / 2 / 0, each scheme's row its ``pair_op_counts()``),
   Fig. 5 (``torch_fig5_lossless.py``: every ``lossless*`` row 1 through
   the ``lift1d`` kernel and the row pass, ``max_abs_error`` 0) and
   Table 3 (``torch_table3_timing.py``: the lifting kernel, the float
   kernel, the plain float chain and one ``conv1d`` call at 1 x 256, (a)
   64 x 65,536 and (b) 1024 x 65,536, each by events, device and host
   time beside its byte bound; the plain chain and ``conv1d`` are
   comparisons, the guard paused there).  The float, lifting and row-pass
   kernels must have launched, no plain version on a CUDA tensor.
12. The sharded paths (``torch.distributed``, the kernels built above
   before any rank starts): (a) phase 3's serve configuration (2048^2 and
   1024^2 buckets, 8 slots, 5 levels, cdf53 / jpeg2000, the same
   requests) on a one-rank NCCL mesh, plain and with
   ``encode_response=True``, every response and container equal to the
   mesh-less engine's, with the counters reset just before and read just
   after (``whole2d_fwd``, ``tiled2d_fwd`` and ``rice_encode`` must have
   launched); (b) 4 gloo ranks on the one card (NCCL refuses two ranks
   on one GPU; halo rows staged through pinned host buffers) running
   ``dwt_fwd_2d_sharded`` / ``dwt_inv_2d_sharded`` on 8 x 2048^2 at 5
   levels for cdf53 / jpeg2000, 97m / paper and haar / paper, each
   rank's bands ``torch.equal`` to its rows of ``dwt_fwd_2d_multi`` on
   the card and each round trip exact, one collective-watchdog trip
   (a delay fault), per-rank host ms of one forward and one inverse and
   ``collectives.exchange_ms``; (c) 2 gloo ranks running
   ``pod_sync_tree`` on float32 gradients shaped like phase 10's tree
   (stablelm-2-1.6b at full width, 4 layers), the 3-D, 2-D and raw
   routes with the spatial codecs on and the 1-D route on three leaves
   with them off: ring bytes per hop equal to ``pod_collective_bytes``'
   payload, the smallest leaf of each route equal to the same sync on
   the CPU, ms per route.
13. LM serving, with the counters reset just before and read just after:
   (a) ``serve.ServeEngine`` on stablelm-2-1.6b at full width and full
   depth (24 layers, bfloat16, ``models.layers.init_params`` from
   ``--seed`` on the card), 4 slots, ``prefill_len`` 128, 8 greedy
   requests with prompts of 16-128 tokens and ``max_new`` 8: every
   request finishes with in-vocabulary tokens; a decode step after a
   prefill of 127 tokens must match a prefill of 128 at the last
   position (relative Frobenius distance of the logits at most 0.1);
   prefill and decode-step ms (CUDA events), tokens/s and
   ``max_memory_allocated``.  (b) One config per family at full width,
   depth cut (``LM_FAMILIES``: stablelm-1.6b 2 layers, phi3.5-moe 1,
   rwkv6-7b 2, recurrentgemma-2b 4 = one super layer and a trailing rec
   layer, musicgen-medium 2 with ``embeds`` input) in float32: forward on
   one (1, 32) prompt, prefill and 2 decode steps on the card against the
   same functions on the CPU from the same parameters (max |diff| within
   2e-3, hybrid 3e-2, of the logits' scale).  (c) ``data.pipeline.
   WaveletBandSplit`` (cdf53 / paper, 2 levels, 8 x 65,536 16-bit
   samples) on the card under the plain-version guard: one ``lift1d_fwd``
   launch, bands equal to the plain version's run on the card.
14. Training, with the counters reset just before and read just after
   and the plain-version guard on (the 1-D, 2-D and 3-D plain versions):
   (a) ``train.train_step.make_train_step`` on stablelm-2-1.6b at full
   width and full depth (24 layers, bfloat16, ``remat=True`` as the
   config has it, ``launch.train.init_train_state`` from ``--seed`` on
   the card), 6 steps on one repeated ``SyntheticLM`` batch of 8 x 256,
   ``AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=6)``: every loss
   finite and the last below the first; step ms (CUDA events), the
   card's busy ms (profiler), tokens/s and ``max_memory_allocated`` with
   remat on and off (one step each).  (b) Determinism: stablelm-2-1.6b
   at full width, depth cut to 2, under deterministic algorithms (and
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before CUDA starts): two
   runs of 2 steps from the same seed end ``torch.equal``, and a remat
   step equals a no-remat step (or the op that has no deterministic
   version is printed).  (c) ``make_wavelet_train_step`` on 2 gloo ranks
   sharing the card (phase 12's route): phase 10's tree (4 layers),
   ``WaveletSyncConfig(levels=2, codec="bands", n_pods=2,
   min_size=256)``, 3 steps, then 1 step with ``spatial_2d`` and
   ``spatial_3d`` on: the replicas bit-identical across the ranks, each
   loss within 5% of the plain step's on the same batches, ring bytes a
   hop equal to ``pod_collective_bytes``' payload, the smallest leaf of
   each route synced on the card equal to the same sync on the CPU,
   ``lift1d_fwd`` / ``lift1d_inv`` launched (and the 2-D and 3-D kernels
   in the spatial step), ms of a step and of its ``pod_sync_tree`` a
   rank.  (d) One config per family (phase 13 (b)'s) at full width,
   depth cut, float32, parameters by phase 10's fill rule:
   ``loss_fn``'s gradients on the card against the CPU from the same
   parameters and batch, within 2e-3 of each leaf's largest magnitude
   (hybrid 3e-2); then stablelm under the reference's init rule, whose
   float32 gradients are ill-conditioned at full width: card against
   CPU and the CPU on one thread against itself, printed.
15. The dry run and the roofline (``repro_torch.launch.dryrun``,
   ``dryrun_wavelet``, ``roofline``): (a) phase 14 (a)'s step as a dry-run
   cell (stablelm-2-1.6b uncut, bfloat16, 8 x 256, remat on and off)
   traced on ``meta`` tensors, then one real step on the card under the
   same FLOP and byte counters: the counts equal, the peak estimate
   (arguments + the peak of the storages the step creates) within 10% of
   ``max_memory_allocated``, and max(compute_s, memory_s) at most 1.05 x
   the card's busy time (profiler, which must measure it); the probes'
   extrapolation equal to the full-depth trace.  (b) ``run_cell`` for stablelm-1.6b over ``SHAPE_SUITE``
   and phi3.5-moe's ``decode_32k``: status, FLOPs, bytes, peak, fits,
   dominant term.  (c) ``dryrun_wavelet`` on phase 14 (c)'s tree and
   codecs: the schedule's ring bytes a hop equal to what phase 14 (c)
   counted.  (d) The four ported examples (``examples/torch_*.py``:
   quickstart, wavelet_pipeline, codec_roundtrip, observe_serve) in
   process on the card, the counters reset before each: every flag they
   print True (quickstart's "kernel == plain?" too), their launches per
   kernel.
16. Print the ``{"kernels": [...]}`` line (each kernel with its launches
   on the checkpoint path, on the sharded paths, on the LM path, on the
   training path and in the examples too; the float kernel's from phase
   11, its times at (a)), the card line, and last the ``{"ok": true,
   ...}`` line.
   ``--json-out PATH`` also writes the whole record (every batch
   latency, every level's, band's and shape's time) to PATH.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import pathlib
import shutil
import statistics
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the timing helpers (also the anatomy tools' and the paper benchmarks');
# the HBM rate and the card's INT32 rate price every kernel's bound
from repro_torch.timing import (  # noqa: E402  (the checkout's src is on the path now)
    INT32_LANES_PER_SM,
    PEAK_BYTES_PER_S,
    PEAK_FP32_FLOPS,
    bound,
    card_line,
    int32_ops_per_s,
)
from repro_torch.timing import device_ms as _device_ms  # noqa: E402
from repro_torch.timing import fmt_ms as _fmt_ms  # noqa: E402
from repro_torch.timing import host_us as _host_us  # noqa: E402
from repro_torch.timing import median_ms as _median_ms  # noqa: E402
from repro_torch.timing import pass_ms as _pass_ms  # noqa: E402
from repro_torch.timing import smi as _smi  # noqa: E402

SCHEMES = ("cdf53", "haar", "cdf22", "97m")
MODES = ("paper", "jpeg2000")
I32 = np.iinfo(np.int32)

KERNELS = {
    "whole2d_fwd": ("src/repro_torch/csrc/whole2d.cu", "src/repro/kernels/fused2d.py:107"),
    "whole2d_inv": ("src/repro_torch/csrc/whole2d.cu", "src/repro/kernels/fused2d.py:133"),
    "tiled2d_fwd": ("src/repro_torch/csrc/tiled2d.cu", "src/repro/kernels/tiled2d.py:141"),
    "tiled2d_inv": ("src/repro_torch/csrc/tiled2d.cu", "src/repro/kernels/tiled2d.py:183"),
    "rice_encode": ("src/repro_torch/csrc/rice.cu", "src/repro/codec/rice.py:102"),
    # no TPU kernel: the reference decodes with a jnp lax.scan
    "rice_decode": ("src/repro_torch/csrc/rice.cu", "src/repro/codec/rice.py:223"),
}
KERNELS_2D = ("whole2d_fwd", "whole2d_inv", "tiled2d_fwd", "tiled2d_inv")
KERNELS_1D = {
    "lift1d_fwd": ("src/repro_torch/csrc/lift1d.cu", "src/repro/kernels/dwt53.py:57"),
    "lift1d_inv": ("src/repro_torch/csrc/lift1d.cu", "src/repro/kernels/dwt53.py:92"),
    # no TPU kernel: the reference's in-graph band-policy fallback of
    # ops._fwd_level / _inv_level, for lines under 8 pairs (its
    # unwindowable levels, cdf22 and haar on odd lengths, are policy runs
    # of lift1d here)
    "rows1d_fwd": ("src/repro_torch/csrc/whole2d.cu", "src/repro/kernels/ops.py:93"),
    "rows1d_inv": ("src/repro_torch/csrc/whole2d.cu", "src/repro/kernels/ops.py:133"),
}

# integer operations per coefficient either Rice direction needs at
# least: encode — zigzag, bit length and next two bits into a per-block
# histogram (from which all 25 k costs follow at a fixed cost per block:
# csrc/rice.cu's bit-length form), code assembly and placement; decode —
# run count, shifts, or, unzigzag
RICE_OPS = 10


def _equal_or_raise(label, got, want) -> int:
    """Raise unless every pair is bit-equal; returns the max |got - want|."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{label}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            diff = (g.double() - w.double()) if g.is_floating_point() else (g.long() - w.long())
            err = max(err, diff.abs().max().item())
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: kernel != plain version (max |err| {err})")
    return err


# ---------------------------------------------------------------------------
# Phase 2: parity sweep.
# ---------------------------------------------------------------------------


def _tiled_check(label, xt, want, mode, th, tw, sch) -> None:
    from repro_torch.kernels import tiled2d as T

    lab = f"{label}/tile{th}x{tw}"
    _equal_or_raise("tiled2d_fwd " + lab, T.fwd2d_tiled_cuda(xt, mode, th, tw, sch),
                    T.fwd2d_tiled_plain(xt, mode, th, tw, sch))
    _equal_or_raise("tiled2d_inv " + lab, [T.inv2d_tiled_cuda(*want, mode, th, tw, sch)],
                    [T.inv2d_tiled_plain(*want, mode, th, tw, sch)])


def _chain_check(label, xt, mode, sch, dev, counts) -> None:
    """The whole-image chain kernels over runs of 1-3 levels of ``xt``, at
    the plan's launches and forced to every cluster size from 1 to 16 the
    chain admits (and the two passes for one level), against the plain
    chain."""
    from repro_torch.kernels import fused2d as F

    b, h, w = xt.shape
    levels, hh, ww = 0, h, w
    while hh >= 2 and ww >= 2 and levels < 3:
        levels, hh, ww = levels + 1, (hh + 1) // 2, (ww + 1) // 2
    for n in range(1, levels + 1):
        ll, details = F.fwd2d_chain_plain(xt, n, mode, sch)
        want = [ll] + [t for lvl in details for t in lvl]
        back = [xt]
        sizes = [None] + [c for c in range(0 if n == 1 else 1, F.CLUSTER_MAX + 1)
                          if c == 0 or F.chain_fits(h, w, n, c, dev)]
        for c in sizes:
            lab = f"{label}/chain{n}/c={'plan' if c is None else c}"
            fplan, iplan = (F._chain_plan(b, h, w, n, sch, mode, inv, xt.device, c)
                            for inv in (False, True))
            got_ll, got = F._run_fwd(xt, fplan)
            _equal_or_raise("whole2d_fwd " + lab, [got_ll] + [t for lvl in got for t in lvl],
                            want)
            _equal_or_raise("whole2d_inv " + lab, [F._run_inv(ll, details[::-1], iplan)], back)
            counts["whole2d_chains"] += 1
            key = "plan" if c is None else str(c)
            counts["whole2d_by_cluster"][key] = counts["whole2d_by_cluster"].get(key, 0) + 1


def parity_sweep(rng, dev) -> dict:
    from repro_torch.core import schemes as S
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import fused2d as F

    shapes = [(2, 2), (3, 3), (7, 9), (33, 17), (257, 383), (512, 512)]
    counts = {k: 0 for k in KERNELS_2D}
    counts.update(tiled2d_default_tile=0, tiled2d_interior_tiles=0, whole2d_chains=0,
                  whole2d_by_cluster={})
    for sch in SCHEMES:
        sc = S.get_scheme(sch)
        for mode in MODES:
            cases = [(2, h, w, kind) for h, w in shapes for kind in ("rand", "min", "max")]
            if mode == "paper":  # lines longer than shared memory: global staging
                cases += [(1, 60001, 3, "rand"), (1, 3, 60001, "rand")]
            for b, h, w, kind in cases:
                if kind == "rand":
                    x = rng.integers(-(1 << 20), 1 << 20, (b, h, w), dtype=np.int32)
                else:
                    x = np.full((b, h, w), I32.min if kind == "min" else I32.max, np.int32)
                xt = torch.from_numpy(x).to(dev)
                label = f"{sch}/{mode}/{b}x{h}x{w}/{kind}"
                want = F._fwd2d_math(xt, mode, sch)
                _equal_or_raise("whole2d_fwd " + label, F.fwd2d_whole_cuda(xt, mode, sch), want)
                _equal_or_raise("whole2d_inv " + label, [F.inv2d_whole_cuda(*want, mode, sch)],
                                [F._inv2d_math(*want, mode, sch)])
                counts["whole2d_fwd"] += 1
                counts["whole2d_inv"] += 1
                if max(h, w) <= 1000:
                    _chain_check(label, xt, mode, sc, dev, counts)
                if not (sc.can_window(h) and sc.can_window(w)) or max(h, w) > 1000:
                    continue
                default = B.pick_tile(h, w, sc.halo, dev)
                for th, tw in sorted({(4, 6), (64, 64), default}):
                    _tiled_check(label, xt, want, mode, th, tw, sch)
                    counts["tiled2d_fwd"] += 1
                    counts["tiled2d_inv"] += 1
                    counts["tiled2d_default_tile"] += (th, tw) == default
            # the tiled kernels alone at the default tile (and forced tiny
            # tiles) on shapes of at least 3 x 3 tiles, whose interior tiles
            # take no reflection, and on the serve path's full batch
            big = [(2, 600, 520, "rand"), (2, 600, 520, "max"), (2, 517, 389, "rand"),
                   (2, 517, 389, "min"), (SLOTS, 2048, 2048, "rand")]
            for b, h, w, kind in big:
                if not (sc.can_window(h) and sc.can_window(w)):
                    continue
                if kind == "rand":
                    xt = torch.randint(-(1 << 20), 1 << 20, (b, h, w), dtype=torch.int32,
                                       device=dev)
                else:
                    xt = torch.full((b, h, w), int(I32.min if kind == "min" else I32.max),
                                    dtype=torch.int32, device=dev)
                label = f"{sch}/{mode}/{b}x{h}x{w}/{kind}"
                want = F._fwd2d_math(xt, mode, sch)
                default = B.pick_tile(h, w, sc.halo, dev)
                tiles = [default] + ([(4, 6)] if h < 2048 else [])
                for th, tw in tiles:
                    _tiled_check(label, xt, want, mode, th, tw, sch)
                    counts["tiled2d_fwd"] += 1
                    counts["tiled2d_inv"] += 1
                    counts["tiled2d_default_tile"] += (th, tw) == default
                counts["tiled2d_interior_tiles"] += 1
                del xt, want
    torch.cuda.synchronize(dev)
    return counts


def _plain_rows(flat, chunk=8192):
    """The plain Rice encode of a flat band on its device: (rows, nbits, k)."""
    from repro_torch.codec import rice as R

    blocks = R._blocks(flat)
    parts = [R._encode_chunk(blocks[i : i + chunk]) for i in range(0, blocks.shape[0], chunk)]
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


def _plain_decode(payload, ks, lens, count, dev):
    from repro_torch.codec import rice as R

    return R.decode_band_plain(payload, ks.astype(np.int64), lens.astype(np.int64), count,
                               device=dev, chunk_blocks=4096)[:count]


def _coded_equal(got, want) -> bool:
    return got[0] == want[0] and np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])


def rice_check(label, bands, dev) -> int:
    """Hold both Rice kernels against their plain versions on flat CUDA
    bands coded in one launch: payload bytes, ``k`` and byte-length
    tables; then decode each band with the kernel and the plain version,
    both of which must give back the band.  Returns the max |decoded -
    band| (0 or it raises)."""
    from repro_torch.codec import rice as R

    err = 0
    for i, (flat, got) in enumerate(zip(bands, R.encode_bands(bands))):
        if not _coded_equal(got, R.encode_band_plain(flat, chunk_blocks=8192)):
            raise AssertionError(f"rice_encode {label} band {i}: payload or tables differ from "
                                 "the plain version")
        back = R.decode_band(*got, flat.numel(), device=dev)
        if flat.numel():
            _equal_or_raise(f"rice_decode {label} band {i}", [back],
                            [_plain_decode(*got, flat.numel(), dev)])
        err = max(err, _equal_or_raise(f"rice roundtrip {label} band {i}", [back], [flat]))
    return err


def rice_sweep(rng, dev) -> dict:
    """Phase 2, Rice half: adversarial bands, each alone and all in one
    launch, and the 16 bands of one 1024^2 x 8 batch in one launch."""
    from repro_torch import kernels as K

    tie = np.concatenate([np.full(128, -1), np.full(128, 1)])  # u = 1, 2: k = 0, 1, 2 tie
    bands = {
        "zeros": np.zeros(1000), "const7": np.full(513, 7), "one": np.array([5]),
        "empty": np.zeros(0), "min": np.full(300, I32.min), "max": np.full(300, I32.max),
        "minmax": np.tile([I32.min, I32.max], 700), "ties": np.tile(tie, 5),
        "tail": rng.integers(-3000, 3000, 3 * 256 + 77),
        "full_range": rng.integers(I32.min, I32.max, 20000, dtype=np.int64),
        "blocks_5000": rng.integers(-40, 40, 5000 * 256 + 3),
        "blocks_20000": rng.integers(-1 << 12, 1 << 12, 20000 * 256),
    }
    flats = {name: torch.from_numpy(np.asarray(v).astype(np.int32)).to(dev)
             for name, v in bands.items()}
    cases = 0
    for name, flat in flats.items():
        rice_check(name, [flat], dev)
        cases += 1
    rice_check("all adversarial bands at once", list(flats.values()), dev)
    cases += 1
    cases += rice_malformed(rng, dev)
    x = torch.from_numpy(rng.integers(-128, 128, (SLOTS, 1024, 1024), dtype=np.int32)).to(dev)
    pyr = K.dwt_fwd_2d_multi(x, levels=LEVELS, mode=MODE, scheme=SCHEME)
    rice_check("1024^2x8 bands", [b.reshape(-1) for b in [pyr.ll] + [b for lvl in pyr.details
                                                                     for b in lvl]], dev)
    cases += 1
    torch.cuda.synchronize(dev)
    return {"rice": cases}


def malformed_blocks(rng):
    """Rice blocks that no encoder writes but whose tables pass the host
    checks, as (name, bytes, k): all escapes, fewer than 5 bytes, 65,535
    bytes of garbage, codes running past the block's bytes, random bytes
    at every k."""
    from repro_torch.codec import rice as R

    ff = b"\xff"
    blocks = [("all_escapes", ff * 1280, 3), ("all_escapes_200", ff * 200, 0)]
    blocks += [(f"ones_{n}", ff * n, 5) for n in range(5)]
    blocks += [(f"random_{n}", rng.bytes(n), int(rng.integers(R.K_MAX + 1))) for n in range(1, 5)]
    garbage = rng.bytes(65535)
    blocks += [("garbage_65535", garbage, 0), ("garbage_65535_k7", garbage, 7)]
    blocks += [("past_its_bytes", rng.bytes(40), R.K_MAX),
               ("escape_past_its_bytes", ff * 6 + bytes(3), 0)]
    blocks += [(f"random_k{k}", rng.bytes(int(rng.integers(1, 1400))), k)
               for k in range(R.K_MAX + 1)]
    return blocks


def rice_malformed(rng, dev) -> int:
    """The decode kernel on malformed blocks, one band each and all in one
    band, beside well-formed bands in the same launch: equal to
    ``codec.rice.decode_block_serial`` (bytes past a block's length read
    as zero).  Returns the cases."""
    from repro_torch.codec import rice as R

    blocks = malformed_blocks(rng)
    groups = [[b] for b in blocks] + [blocks]
    items = [(b"".join(b for _, b, _ in g), np.array([k for *_, k in g], np.uint8),
              np.array([len(b) for _, b, _ in g], np.uint16), 256 * len(g) - 17 * (len(g) > 1))
             for g in groups]
    x = torch.from_numpy(rng.integers(-3000, 3000, 5 * 256 + 9).astype(np.int32)).to(dev)
    got = R.decode_bands([(*R.encode_band(x), x.numel())] + items, device=dev)
    _equal_or_raise("rice_decode well-formed band beside malformed ones", [got[0]], [x])
    for g, it, v in zip(groups, items, got[1:]):
        want = np.concatenate([R.decode_block_serial(b, k) for _, b, k in g])[: it[3]]
        _equal_or_raise(f"rice_decode malformed {g[0][0] if len(g) == 1 else 'all'}", [v],
                        [torch.from_numpy(want).to(dev)])
    return len(groups)


# ---------------------------------------------------------------------------
# Phase 3: the serve route.
# ---------------------------------------------------------------------------

BUCKETS = ((1024, 1024), (2048, 2048))
SLOTS, LEVELS, SCHEME, MODE = 8, 5, "cdf53", "jpeg2000"
STRESS_RUNS = 20  # encodes of the 2048^2 x 8 batch's 16 bands that must all agree


def make_requests(rng, n):
    from repro_torch.serve import TransformRequest

    reqs = []
    for uid in range(n):
        bh, bw = BUCKETS[uid % 2]
        if uid % 4 == 3:  # undersized: rides the smallest bucket holding it
            h, w = int(rng.integers(bh // 2 + 1, bh)), int(rng.integers(bw // 2 + 1, bw))
        else:
            h, w = bh, bw
        # 8-bit samples with the DC level shift applied: -128 .. 127
        img = rng.integers(-128, 128, (h, w), dtype=np.int32)
        reqs.append(TransformRequest(uid=uid, image=img))
    return reqs


def serve(rng, dev, n_requests) -> dict:
    from repro_torch import kernels as K
    from repro_torch.core import lifting as L
    from repro_torch.serve import WaveletServeEngine, crop_result

    eng = WaveletServeEngine(buckets=BUCKETS, batch_slots=SLOTS, levels=LEVELS,
                             scheme=SCHEME, mode=MODE, device=str(dev))
    t = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t
    reqs = make_requests(rng, n_requests)
    for r in reqs:
        eng.submit(r)

    K.launches.reset()
    lat_ms, served = [], []
    t_all = time.perf_counter()
    while eng.scheduler.pending():
        t = time.perf_counter()
        done = eng.step()
        torch.cuda.synchronize(dev)
        lat_ms.append((time.perf_counter() - t) * 1e3)
        served.extend(done)
    serve_s = time.perf_counter() - t_all
    fwd_counts = K.launches.snapshot()

    checked_oracle = set()
    for r in served:
        if r.error is not None or not r.done:
            raise AssertionError(f"request {r.uid} failed: {r.error}")
        ll_shape, det = L.band_shapes_2d(*r.bucket, LEVELS)
        if tuple(r.pyramid.ll.shape) != ll_shape or [
            tuple(tuple(b.shape) for b in lvl) for lvl in r.pyramid.details
        ] != [tuple(s) for s in det]:
            raise AssertionError(f"request {r.uid}: pyramid shapes differ from band_shapes_2d")
        xr = crop_result(K.dwt_inv_2d_multi(r.pyramid, mode=MODE, scheme=SCHEME), r)
        if not torch.equal(xr, torch.from_numpy(r.image).to(dev)):
            raise AssertionError(f"request {r.uid}: reconstruction is not bit-exact")
        if r.bucket not in checked_oracle:  # the plain oracle on the same padded input
            padded = torch.zeros(r.bucket, dtype=torch.int32, device=dev)
            padded[: r.image.shape[0], : r.image.shape[1]] = torch.from_numpy(r.image).to(dev)
            want = L.dwt_fwd_2d_multi(padded, levels=LEVELS, mode=MODE, scheme=SCHEME)
            got_leaves = [r.pyramid.ll] + [b for lvl in r.pyramid.details for b in lvl]
            want_leaves = [want.ll] + [b for lvl in want.details for b in lvl]
            _equal_or_raise(f"serve oracle {r.bucket}", got_leaves, want_leaves)
            checked_oracle.add(r.bucket)
    torch.cuda.synchronize(dev)
    counts = K.launches.snapshot()
    if len(served) != n_requests:
        raise AssertionError(f"served {len(served)} of {n_requests} requests")
    for k in KERNELS_2D:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the serve path: {counts}")
    _check_whole_runs("serve", fwd_counts, counts, len(lat_ms), served)
    plans = {
        f"{h}x{w}": [K.plan_2d(h >> lv, w >> lv, dev, SCHEME) for lv in range(LEVELS)]
        for h, w in BUCKETS
    }
    # where one 2048^2 batch's time goes: the phases of engine.step()
    # (host assembly, host-to-device copy, transform) and one client
    # reconstruction, each timed alone with a device sync
    big = [r for r in served if r.bucket == BUCKETS[-1]][:SLOTS]
    t = time.perf_counter()
    batch = np.zeros((SLOTS,) + BUCKETS[-1], np.int32)
    for i, r in enumerate(big):
        batch[(i,) + tuple(slice(0, s) for s in r.image.shape)] = r.image
    host_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    xb = torch.from_numpy(batch).to(dev)
    torch.cuda.synchronize(dev)
    h2d_ms = (time.perf_counter() - t) * 1e3
    fwd_ms = _median_ms(lambda: K.dwt_fwd_2d_multi(xb, levels=LEVELS, mode=MODE, scheme=SCHEME), 10)
    inv_ms = _median_ms(lambda: K.dwt_inv_2d_multi(big[0].pyramid, mode=MODE, scheme=SCHEME), 10)
    lat = sorted(lat_ms)
    return {
        "warmup_s": warm_s,
        "requests": len(served),
        "undersized": sum(r.padded for r in served),
        "batches": len(lat_ms),
        "serve_s": serve_s,
        "requests_per_s": len(served) / serve_s,
        "batch_ms_p50": statistics.median(lat),
        "batch_ms_p99": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))],
        "batch_ms": lat_ms,
        "launches_forward": fwd_counts,
        "launches": counts,
        "plans": plans,
        "breakdown_2048_ms": {"host_assembly": host_ms, "host_to_device": h2d_ms,
                              "forward_all_levels": fwd_ms, "inverse_one_request": inv_ms},
    }


# ---------------------------------------------------------------------------
# Phase 4: the encoded-response serve route.
# ---------------------------------------------------------------------------


def _whole_runs(bucket) -> int:
    """The runs of whole-image levels in a bucket's pyramid: each is one
    launch each way."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused2d as F

    dims = F._level_dims(*bucket, LEVELS)
    return sum(not tiled for tiled, _ in F.level_runs(dims, S.get_scheme(SCHEME)))


def _check_whole_runs(label, fwd_counts, counts, batches, served) -> None:
    """One ``whole2d_fwd`` launch per batch and one ``whole2d_inv`` per
    client inverse, for each run of whole levels its bucket has."""
    want_inv = sum(_whole_runs(r.bucket) for r in served)
    got_fwd = fwd_counts.get("whole2d_fwd", 0)
    got_inv = counts.get("whole2d_inv", 0) - fwd_counts.get("whole2d_inv", 0)
    if any(_whole_runs(b) != 1 for b in BUCKETS) or got_fwd != batches or got_inv != want_inv:
        raise AssertionError(f"{label}: whole2d_fwd {got_fwd} launches for {batches} batches, "
                             f"whole2d_inv {got_inv} for {want_inv} whole runs of the client's "
                             f"inverses: want one launch per run")


def smooth_image(rng, h, w):
    """A few low-frequency sinusoids quantised to 8 bits (DC-shifted,
    -128..127) plus +-2 noise: small detail coefficients, so the Rice
    parameters span small k as well."""
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32) / h, np.arange(w, dtype=np.float32) / w,
                         indexing="ij")
    img = np.zeros((h, w), np.float32)
    for _ in range(3):
        fy, fx, ph = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0, 2 * np.pi)
        img += np.sin(2 * np.pi * (fy * yy + fx * xx) + ph).astype(np.float32)
    img = np.round(img * 40) + rng.integers(-2, 3, (h, w))
    return np.clip(img, -128, 127).astype(np.int32)


def make_encoded_requests(rng, n):
    """As make_requests, but every other request (uid % 4 in 1, 2) a
    smooth image instead of random 8-bit samples."""
    reqs = make_requests(rng, n)
    for r in reqs:
        if r.uid % 4 in (1, 2):
            r.image = smooth_image(rng, *r.image.shape)
    return reqs


def plain_container(bands, n, bucket):
    """The container ``encode_batch`` must give, its bands coded by the
    plain Rice encode on the card."""
    from repro_torch.codec import container as C
    from repro_torch.codec import rice as R

    coded = [R.encode_band_plain(b.reshape(-1), chunk_blocks=8192) for b in bands]
    return C.assemble(coded, C.KIND_2D, SCHEME, MODE, np.dtype(np.int32), LEVELS, 2, (n,), bucket)


def _timed(fn, dev):
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t) * 1e3


def encoded_breakdown(big, dev) -> dict:
    """One 2048^2 x 8 encoded serve step, phase by phase, each phase
    timed alone on the host clock with a device sync after it."""
    from repro_torch import kernels as K
    from repro_torch.codec import container as C

    def assemble_batch():
        batch = np.zeros((SLOTS,) + BUCKETS[-1], np.int32)
        for i, r in enumerate(big):
            batch[(i,) + tuple(slice(0, s) for s in r.image.shape)] = r.image
        return batch

    ms = {}
    batch, ms["host_assembly"] = _timed(assemble_batch, dev)
    xb, ms["host_to_device"] = _timed(lambda: torch.from_numpy(batch).to(dev), dev)
    pyr, ms["forward_all_levels"] = _timed(
        lambda: K.dwt_fwd_2d_multi(xb, levels=LEVELS, mode=MODE, scheme=SCHEME), dev)
    bands = [b.reshape(-1) for b in [pyr.ll] + [b for lvl in pyr.details for b in lvl]]
    coded, enc_ms = encode_stages(bands, dev)
    ms.update(enc_ms)
    blob, ms["host_crc32_and_header"] = _timed(lambda: C.assemble(
        coded, C.KIND_2D, SCHEME, MODE, np.dtype(np.int32), LEVELS, 2, (SLOTS,), BUCKETS[-1]),
        dev)
    ms["step_sum"] = sum(ms.values())
    if blob != C.encode_batch(pyr, scheme=SCHEME, mode=MODE):
        raise AssertionError("2-D step stages differ from encode_batch")
    return {"ms": ms, "container_bytes": len(blob), "payload_bytes": sum(len(c[0]) for c in coded),
            "coefficients": sum(b.numel() for b in bands)}


def encode_stages(bands, dev):
    """The stages of ``codec.rice.encode_bands_cuda`` on one step's flat
    bands, each timed alone on the host clock with a device sync after
    it: the launch, the tables' copy to the host, the payload's copy (and
    its cut into the bands).  Returns (the bands' codings, ms by stage)."""
    from repro_torch.codec import rice as R

    ms = {}
    (payload, tables), ms["rice_encode_kernel"] = _timed(lambda: R.rice_encode_cuda(bands), dev)
    (offs, ks, lens), ms["tables_to_host"] = _timed(
        lambda: R.tables_to_host(tables, len(bands)), dev)
    coded, ms["device_to_host_payload"] = _timed(lambda: R.split_bands(
        R.payload_to_host(payload, int(offs[-1])), offs, ks, lens, [b.numel() for b in bands]),
        dev)
    return coded, ms


def serve_encoded(rng, dev, n_requests) -> dict:
    from repro_torch import codec, obs
    from repro_torch import kernels as K
    from repro_torch.serve import ProgressiveServeRoute, WaveletServeEngine, crop_result

    eng = WaveletServeEngine(buckets=BUCKETS, batch_slots=SLOTS, levels=LEVELS, scheme=SCHEME,
                             mode=MODE, device=str(dev), encode_response=True)
    t = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t
    reqs = make_encoded_requests(rng, n_requests)
    for r in reqs:
        eng.submit(r)
    obs.reset()
    K.launches.reset()
    lat_ms, served = [], []
    t_all = time.perf_counter()
    while eng.scheduler.pending():
        t = time.perf_counter()
        done = eng.step()
        torch.cuda.synchronize(dev)
        lat_ms.append((time.perf_counter() - t) * 1e3)
        served.extend(done)
    serve_s = time.perf_counter() - t_all
    encode_counts = K.launches.snapshot()
    metrics = obs.snapshot()["metrics"]

    # the client: decode each batch container once on the card, invert,
    # crop; every request must equal its image
    batches = {}
    for r in served:
        if r.error is not None or not r.done or r.encoded is None or r.batch_index is None:
            raise AssertionError(f"request {r.uid}: served without its batch bytes ({r.error})")
        batches.setdefault(id(r.encoded), []).append(r)
    rows_ll = {}
    for group in batches.values():
        rows = codec.decode_batch(group[0].encoded, device=dev)
        if len(rows) != len(group):
            raise AssertionError(f"container holds {len(rows)} rows for {len(group)} requests")
        for r in group:
            row = rows[r.batch_index]
            rows_ll[r.uid] = row.ll
            xr = crop_result(K.dwt_inv_2d_multi(row, mode=MODE, scheme=SCHEME), r)
            if not torch.equal(xr, torch.from_numpy(r.image).to(dev)):
                raise AssertionError(f"request {r.uid}: encoded response is not bit-exact")
    torch.cuda.synchronize(dev)
    counts = K.launches.snapshot()
    degrades = metrics.get("serve.encode_degrades", 0)
    quarantines = metrics.get("serve.encode_quarantines", 0)
    if degrades or quarantines:
        raise AssertionError(f"encode degraded {degrades} / quarantined {quarantines} times")
    if len(served) != n_requests:
        raise AssertionError(f"served {len(served)} of {n_requests} requests")
    for k in KERNELS:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the encoded serve path: {counts}")
    _check_whole_runs("encoded serve", encode_counts, counts, len(lat_ms), served)
    if encode_counts.get("rice_encode") != len(lat_ms):
        raise AssertionError(f"{encode_counts.get('rice_encode')} rice_encode launches for "
                             f"{len(lat_ms)} encoded batches: want one per batch")
    if counts.get("rice_decode", 0) - encode_counts.get("rice_decode", 0) != len(batches):
        raise AssertionError(f"{counts.get('rice_decode')} rice_decode launches for "
                             f"{len(batches)} decoded containers: want one per container")

    # one batch per bucket: byte-equal to the plain Rice encode of its bands
    plain_checked = []
    for bucket in BUCKETS:
        group = next(g for g in batches.values() if g[0].bucket == bucket)
        group = sorted(group, key=lambda r: r.batch_index)
        leaves = [[r.pyramid.ll] + [b for lvl in r.pyramid.details for b in lvl] for r in group]
        bands = [torch.stack([lv[j] for lv in leaves]) for j in range(len(leaves[0]))]
        if plain_container(bands, len(group), bucket) != group[0].encoded:
            raise AssertionError(f"bucket {bucket}: container differs from the plain encode")
        plain_checked.append("x".join(map(str, bucket)))

    # progressive tiers of one request, decoded on the card
    route = ProgressiveServeRoute(device=dev)
    r = next(r for r in served if r.padded)
    route.store(r)
    tiers = route.tiers(r.uid)
    thumb = route.thumbnail(r.uid)
    want = rows_ll[r.uid][tuple(slice(0, s) for s in tiers[0])]
    if not torch.equal(thumb, want) or not torch.equal(
            route.full(r.uid), torch.from_numpy(r.image).to(dev)):
        raise AssertionError(f"request {r.uid}: progressive tiers differ")

    big = [r for r in served if r.bucket == BUCKETS[-1]][:SLOTS]
    lat = sorted(lat_ms)
    return {
        "warmup_s": warm_s, "requests": len(served), "undersized": sum(r.padded for r in served),
        "batches": len(lat_ms), "serve_s": serve_s, "requests_per_s": len(served) / serve_s,
        "batch_ms_p50": statistics.median(lat),
        "batch_ms_p99": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))],
        "batch_ms": lat_ms, "launches_serve": encode_counts, "launches": counts,
        "container_bytes": {str(r.uid): len(r.encoded) for r in served},
        "encode_degrades": degrades, "encode_quarantines": quarantines,
        "plain_container_checked": plain_checked, "tiers_checked_uid": r.uid,
        "breakdown_2048_ms": encoded_breakdown(big, dev),
    }


# ---------------------------------------------------------------------------
# Phase 9: kernel times at the serve path's shapes.
# ---------------------------------------------------------------------------


def time_kernels(rng, dev) -> list:
    from repro_torch.core import schemes as S
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import fused2d as F
    from repro_torch.kernels import tiled2d as T

    sch = S.get_scheme(SCHEME)
    h0, w0 = BUCKETS[-1]
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "err": 0, "levels": []}
           for k in KERNELS_2D}
    # a level lifts every row pair, then every column pair: H*W pairs in all
    ops_per_sample = sum(sch.pair_op_counts()[k] for k in ("adders", "shifters"))
    for lv in range(LEVELS):
        h, w = h0 >> lv, w0 >> lv
        tiled = F.plan_2d(h, w, dev, SCHEME).startswith("tiled")
        x = torch.from_numpy(rng.integers(-128, 128, (SLOTS, h, w), dtype=np.int32)).to(dev)
        bands = F._fwd2d_math(x, MODE, SCHEME)
        if tiled:
            th, tw = B.pick_tile(h, w, sch.halo, dev)
            runs = {
                "tiled2d_fwd": (lambda: T.fwd2d_tiled_cuda(x, MODE, th, tw, SCHEME),
                                lambda: T.fwd2d_tiled_plain(x, MODE, th, tw, SCHEME)),
                "tiled2d_inv": (lambda: [T.inv2d_tiled_cuda(*bands, MODE, th, tw, SCHEME)],
                                lambda: [T.inv2d_tiled_plain(*bands, MODE, th, tw, SCHEME)]),
            }
        else:
            runs = {
                "whole2d_fwd": (lambda: F.fwd2d_whole_cuda(x, MODE, SCHEME),
                                lambda: F._fwd2d_math(x, MODE, SCHEME)),
                "whole2d_inv": (lambda: [F.inv2d_whole_cuda(*bands, MODE, SCHEME)],
                                lambda: [F._inv2d_math(*bands, MODE, SCHEME)]),
            }
        for name, (kern, plain) in runs.items():
            e = per[name]
            err = _equal_or_raise(f"{name} {SLOTS}x{h}x{w}", kern(), plain())
            ms = _median_ms(kern, 30)
            pms = _median_ms(plain, 5)
            nbytes = 2 * SLOTS * h * w * 4  # read every sample once, write every band once
            e["ms"] += ms
            e["plain_ms"] += pms
            e["bytes"] += nbytes
            e["ops"] += int(ops_per_sample * SLOTS * h * w)
            e["err"] = max(e["err"], err)
            lv = {"shape": [SLOTS, h, w], "ms": ms, "plain_ms": pms,
                  "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                  "tile": [th, tw] if tiled else None, "device_ms": _pass_ms(kern)}
            if not tiled:
                lv["host_us"] = _host_us(kern, dev)
                lv["cluster"] = F.chain_launches(SLOTS, h, w, 1, dev)[0][1]
            e["levels"].append(lv)
    for name, chains in time_chains(rng, dev).items():
        per[name]["chains"] = chains
    out = []
    for name in KERNELS_2D:
        source, replaces = KERNELS[name]
        e = per[name]
        bound_ms, bound_by = bound(e["bytes"], e["ops"])
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "levels": e["levels"],
            **({"chains": e["chains"]} if "chains" in e else {}),
        })
    return out


# the runs of whole-image levels of the serve path: each bucket's batch
# and the client's one-request inverse
WHOLE2D_CHAINS = (
    ("2048^2 batch, level 5", SLOTS, 2048),
    ("1024^2 batch, levels 4-5", SLOTS, 1024),
    ("2048^2 request, level 5", 1, 2048),
    ("1024^2 request, levels 4-5", 1, 1024),
)


def time_chains(rng, dev) -> dict:
    """The whole-image kernels over each run of whole levels of the serve
    path's pyramids (one launch each way), checked once more against the
    plain chain: events ms, device ms, host us a call, the cluster size,
    the plain chain's ms and the bound (the first level's samples read
    once and every band written once)."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import fused2d as F

    sch = S.get_scheme(SCHEME)
    out = {"whole2d_fwd": [], "whole2d_inv": []}
    for label, b, side in WHOLE2D_CHAINS:
        dims = F._level_dims(side, side, LEVELS)
        whole = [hw for hw in dims if F.plan_2d(*hw, dev, SCHEME) == "whole-cuda"]
        levels = len(whole)
        x = torch.from_numpy(rng.integers(-128, 128, (b,) + whole[0], dtype=np.int32)).to(dev)
        ll, details = F.fwd2d_chain_plain(x, levels, MODE, sch)
        want = [ll] + [t for lvl in details for t in lvl]
        runs = F.chain_launches(b, *whole[0], levels, dev)
        # x read once, every band written once: the bands of a run partition
        # its first level's samples
        nbytes = 2 * b * whole[0][0] * whole[0][1] * 4
        for name, kern, plain, ref in (
            ("whole2d_fwd", lambda: F.fwd2d_chain_cuda(x, levels, MODE, sch),
             lambda: F.fwd2d_chain_plain(x, levels, MODE, sch), want),
            ("whole2d_inv", lambda: F.inv2d_chain_cuda(ll, details[::-1], MODE, sch),
             lambda: F.inv2d_chain_plain(ll, details[::-1], MODE, sch), [x]),
        ):
            got = kern()
            if name == "whole2d_fwd":
                got = [got[0]] + [t for lvl in got[1] for t in lvl]
            err = _equal_or_raise(f"{name} {label}", [got] if name == "whole2d_inv" else got,
                                  ref)
            out[name].append({
                "label": label, "shape": [b, *whole[0]], "levels": levels,
                "launches": [list(r) for r in runs], "ms": _median_ms(kern, 20),
                "device_ms": _device_ms(kern, len(runs)), "host_us": _host_us(kern, dev),
                "plain_ms": _median_ms(plain, 5), "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                "err": err})
    return out


def time_rice(rng, dev) -> list:
    """Both Rice kernels over all 16 bands of one 2048^2 x 8 batch (half
    random, half smooth images, 5 levels), beside their plain versions
    and their bounds.  ``rice_encode`` codes the 16 bands in one launch
    and is timed as that launch (its workspace memset, the bands' table
    copied to the card, the kernel).  Before the timing it codes them
    STRESS_RUNS times in a row, the tiles' order on the card differing
    from run to run: every run's payload and tables must equal the plain
    encode's, so every run equals the first."""
    from repro_torch import kernels as K
    from repro_torch.codec import rice as R

    h, w = BUCKETS[-1]
    imgs = [rng.integers(-128, 128, (h, w), dtype=np.int32) if i % 2 else smooth_image(rng, h, w)
            for i in range(SLOTS)]
    x = torch.from_numpy(np.stack(imgs)).to(dev)
    pyr = K.dwt_fwd_2d_multi(x, levels=LEVELS, mode=MODE, scheme=SCHEME)
    bands = [b.reshape(-1) for b in [pyr.ll] + [b for lvl in pyr.details for b in lvl]]
    count = sum(b.numel() for b in bands)
    coded = [R.encode_band_plain(b, chunk_blocks=8192) for b in bands]
    for run in range(STRESS_RUNS):
        if not all(_coded_equal(g, c) for g, c in zip(R.encode_bands(bands), coded)):
            raise AssertionError(f"rice_encode look-back stress run {run}: the 16 bands differ "
                                 "from the plain encode")
    payload = sum(len(c[0]) for c in coded)
    nblocks = sum(len(c[1]) for c in coded)

    def encode_on_card():
        return R.rice_encode_cuda(bands)

    def encode_plain():
        out = []
        for b in bands:
            rows, nbits, _ = _plain_rows(b)
            lens = (nbits.to(torch.int64) + 7) // 8
            out.append(rows[torch.arange(rows.shape[1], device=dev)[None, :] < lens[:, None]])
        return out

    pay, tables = encode_on_card()
    _, ks, lens = R.tables_to_host(tables, len(bands))
    enc_err = _equal_or_raise("rice_encode payload and tables", [
        pay[:payload], torch.from_numpy(ks.copy()), torch.from_numpy(lens.astype(np.int32))], [
        torch.cat(encode_plain()), torch.from_numpy(np.concatenate([c[1] for c in coded])),
        torch.from_numpy(np.concatenate([c[2] for c in coded]).astype(np.int32))])
    items = [(c[0], c[1], c[2], b.numel()) for b, c in zip(bands, coded)]
    dec = decode_timing("16 bands of one 2048^2 x 8 batch", bands, items, dev)
    dec_err = max(_equal_or_raise(f"rice_decode band {i}", [v], [_plain_decode(*c, b.numel(), dev)])
                  for i, (b, c, v) in enumerate(zip(bands, coded, dec.pop("values"))))
    vol = decode_timing("29 bands of one 4 x (64, 512, 512) KIND_ND batch", *volume_bands(rng, dev),
                        dev)
    vol_err = max(_equal_or_raise(f"rice_decode volume band {i}", [v],
                                  [_plain_decode(*it[:3], it[3], dev)])
                  for i, (v, it) in enumerate(zip(vol.pop("values"), vol.pop("items"))))
    dec.pop("items")
    dec_err = max(dec_err, vol_err)

    runs = {  # bytes: the bands read once; payload, tables and band offsets written once
        "rice_encode": (encode_on_card, encode_plain,
                        4 * count + payload + 3 * nblocks + 8 * (len(bands) + 1),
                        RICE_OPS * count, enc_err),
        "rice_decode": (dec.pop("launch"),
                        lambda: [_plain_decode(c[0], c[1], c[2], b.numel(), dev)
                                 for b, c in zip(bands, coded)],
                        payload + 4 * count, RICE_OPS * count, dec_err),
    }
    vol.pop("launch")
    out = []
    for name, (kern, plain, nbytes, ops, err) in runs.items():
        source, replaces = KERNELS[name]
        bound_ms, bound_by = bound(nbytes, ops)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": _median_ms(kern, 10),
            "plain_ms": _median_ms(plain, 1), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "levels": [{"shape": [len(bands), count], "payload_bytes": payload,
                        "bits_per_coefficient": 8 * payload / count,
                        "device_ms": _pass_ms(kern),
                        "stress_runs": STRESS_RUNS if name == "rice_encode" else 0}]
            + ([dec, vol] if name == "rice_decode" else []),
        })
    return out


def volume_bands(rng, dev):
    """The 29 bands of one 4 x (64, 512, 512) batch as the 3-D encoded
    path codes them (4 levels, cdf53 / jpeg2000; two CT-like phantoms,
    two volumes of 12-bit noise): (bands, their codings as
    ``decode_bands`` items)."""
    from repro_torch import kernels as K
    from repro_torch.codec import rice as R

    vols = [phantom(rng, VOLUME, dev, noise=2) if i % 2 else
            torch.from_numpy(rng.integers(*CT12, VOLUME, dtype=np.int32)).to(dev)
            for i in range(VOL_SLOTS)]
    pyr = K.dwt_fwd_nd(torch.stack(vols), levels=VOL_LEVELS, mode=VOL_MODE, scheme=VOL_SCHEME)
    bands = [b.reshape(-1) for b in _leaves3(pyr)]
    return bands, [(*c, b.numel()) for b, c in zip(bands, R.encode_bands(bands))]


def decode_timing(label, bands, items, dev) -> dict:
    """The Rice decode of ``items`` (one container's bands): the launcher
    over all of them with their bytes staged on the card (CUDA events,
    device ms), and the whole ``decode_bands`` call (events, host us a
    call); each band's values equal to the band.  Returns the record with
    the launcher (``launch``), the decoded bands (``values``) and the
    items."""
    from repro_torch.codec import rice as R

    host, table, nb = R.stage_bands([R.check_band(*it) for it in items])
    staged = host.to(dev)
    firsts = table[R.TABLE_HEAD:]

    def launch():
        return R.rice_decode_cuda(staged, table, nb)

    out = launch()
    values = [out[256 * int(f): 256 * int(f) + b.numel()] for f, b in zip(firsts, bands)]
    got = R.decode_bands(items, device=dev)
    for i, (v, g, b) in enumerate(zip(values, got, bands)):
        _equal_or_raise(f"rice_decode {label} band {i}", [v, g], [b, b])
    payload = sum(len(it[0]) for it in items)
    count = sum(b.numel() for b in bands)
    return {"set": label, "shape": [len(bands), count], "payload_bytes": payload,
            "bound_ms": (payload + 4 * count) / PEAK_BYTES_PER_S * 1e3,
            "ms": _median_ms(launch, 10), "device_ms": _pass_ms(launch, per_call=1),
            "decode_bands_ms": _median_ms(lambda: R.decode_bands(items, device=dev), 5),
            "decode_bands_host_us": _host_us(lambda: R.decode_bands(items, device=dev), dev, 10),
            "launch": launch, "values": values, "items": items}


# ---------------------------------------------------------------------------
# Phases 5, 6 and 9: the 1-D library transform.
# ---------------------------------------------------------------------------

LENGTHS_1D = (2, 3, 5, 15, 16, 17, 31, 1001, 65536, 65537)
PCM16 = (-32768, 32768)  # 16-bit samples: the LARGE configs' input range


def parity_sweep_1d(rng, dev) -> dict:
    """Phase 5: every 1-D kernel against its plain version, ``torch.equal``."""
    from repro_torch import kernels as K
    from repro_torch.core import lifting as L
    from repro_torch.core import schemes as S
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import dwt53 as D

    K.launches.reset()
    cases = 0
    for name in SCHEMES:
        sch = S.get_scheme(name)
        for mode in MODES:
            for n in LENGTHS_1D:
                for rows in (1, 3, 64):
                    kinds = ("rand", "min", "max") if rows == 3 and n <= 1001 else ("rand",)
                    for kind in kinds:
                        if kind == "rand":
                            x = rng.integers(-(1 << 20), 1 << 20, (rows, n), dtype=np.int32)
                        else:
                            x = np.full((rows, n), I32.min if kind == "min" else I32.max, np.int32)
                        xt = torch.from_numpy(x).to(dev)
                        label = f"{name}/{mode}/{rows}x{n}/{kind}"
                        s0, d0 = S.lift_fwd_axis(xt, sch, axis=-1, mode=mode)
                        _equal_or_raise("rows1d_fwd " + label, D.rows_fwd_cuda(xt, mode, sch),
                                        [s0, d0])
                        _equal_or_raise("rows1d_inv " + label, [D.rows_inv_cuda(s0, d0, mode, sch)],
                                        [S.lift_inv_axis(s0, d0, sch, axis=-1, mode=mode)])
                        if sch.can_window(n):
                            rb, bp = B.pick_blocks(rows, n - n // 2, sch.halo, dev)
                            for rb_, bp_ in {(rb, bp), (2, 3)}:
                                lab = f"{label}/blocks{rb_}x{bp_}"
                                _equal_or_raise("lift1d_fwd " + lab,
                                                D.lift_fwd_windows_cuda(xt, mode, rb_, bp_, sch),
                                                D.lift_fwd_windows_plain(xt, mode, bp_, sch))
                                _equal_or_raise("lift1d_inv " + lab,
                                                [D.lift_inv_windows_cuda(s0, d0, mode, rb_, bp_, sch)],
                                                [D.lift_inv_windows_plain(s0, d0, mode, bp_, sch)])
                        cases += 1
            # the library entry points: leading dims, every accepted dtype
            x = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (2, 3, 1001),
                                              dtype=np.int32)).to(dev)
            got, want = K.dwt_fwd_1d(x, mode=mode, scheme=name), L.dwt_fwd_1d(x, mode, name)
            _equal_or_raise(f"dwt_fwd_1d {name}/{mode}/2x3x1001", got, want)
            _equal_or_raise(f"dwt_inv_1d {name}/{mode}/2x3x1001",
                            [K.dwt_inv_1d(*got, mode=mode, scheme=name)], [x])
            cases += 1
            for dt in (np.int8, np.int16, np.uint8, np.uint16, np.int32):
                info = np.iinfo(dt)
                xn = rng.integers(info.min, info.max, (3, 4099), endpoint=True).astype(dt)
                xn[0, :64], xn[1, :64] = info.min, info.max
                xt = torch.from_numpy(xn).to(dev)
                pyr, want = K.dwt_fwd(xt, levels=4, mode=mode, scheme=name), L.dwt_fwd(
                    xt, levels=4, mode=mode, scheme=name)
                label = f"dwt_fwd {name}/{mode}/{np.dtype(dt).name}"
                _equal_or_raise(label, (pyr.approx,) + pyr.details, (want.approx,) + want.details)
                _equal_or_raise(label + " inverse", [K.dwt_inv(pyr, mode=mode, scheme=name)],
                                [L.dwt_inv(want, mode=mode, scheme=name)])
                cases += 1
    cases += run_sweep_1d(rng, dev)
    torch.cuda.synchronize(dev)
    return {"cases_1d": cases, "launches": K.launches.snapshot()}


RUN_LENGTHS_1D = (16, 17, 23, 31, 40, 1001, 4099, 65537)


def _misaligned(t):
    """A copy of ``t`` whose storage starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    off = (-(flat.data_ptr() // 4) % 4 + 1) % 4
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def run_sweep_1d(rng, dev) -> int:
    """Phase 5, runs: the run kernels of ``lift1d.cu`` (one launch a run of
    levels) against their plain versions with ``torch.equal``: every
    scheme of ``SCHEMES``, both modes, runs of 1-6 levels from n in
    ``LENGTHS_1D`` and ``RUN_LENGTHS_1D`` — windowed runs, and policy runs
    (cdf22; haar with an odd level: band-policy rewrites after every
    step) — at the plan's tile (also on tensors 4 bytes past a 16-byte
    boundary) and at forced tiles of 2^L and 3 x 2^L level-0 samples (64
    x 2^L past 4099) with 1-3 rows a block, int32 extremes; and a scheme
    of six terms a step (the generic term loop)."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import dwt53 as D

    # a symmetric scheme of six terms a step: its runs take the kernels'
    # generic term loop, the registered schemes the unrolled one
    wide = S.scheme_from_spec("wide", [("predict", ((-1, 1), (0, 3), (1, 3), (2, 1)), 3, -1),
                                       ("update", ((-2, 1), (-1, 3), (0, 3), (1, 1)), 4, 1)])
    cases = 0
    for name in SCHEMES + ("wide",):
        sch = wide if name == "wide" else S.get_scheme(name)
        for mode in MODES:
            for n in sorted(set(LENGTHS_1D + RUN_LENGTHS_1D)):
                for levels in range(1, 7):
                    lens = D.run_lengths(n, levels)
                    if lens[-1] < 2:
                        continue
                    unit = 1 << levels
                    forced = ((None, None), (unit, 1), (3 * unit, 3)) if n <= 4099 else (
                        (None, None), (64 * unit, 2))
                    policy = D.run_policy(sch, n, levels)
                    kinds = ("rand", "min", "max") if n <= 1001 and levels in (1, 4) else ("rand",)
                    for kind in kinds:
                        if kind == "rand":
                            x = rng.integers(-(1 << 20), 1 << 20, (3, n), dtype=np.int32)
                        else:
                            x = np.full((3, n), I32.min if kind == "min" else I32.max, np.int32)
                        xt = torch.from_numpy(x).to(dev)
                        s0, d0 = D.lift_fwd_run_plain(xt, levels, mode, sch)
                        s0, d0 = s0.contiguous(), [d.contiguous() for d in d0]
                        for tile, rb in forced:
                            for mis in ((False, True) if tile is None else (False,)):
                                label = (f"{name}/{mode}/3x{n}/{levels} levels/{kind}/tile {tile}"
                                         f"/rows {rb}{'/misaligned' if mis else ''}"
                                         f"{'/policy' if policy else ''}")
                                xin = _misaligned(xt) if mis else xt
                                s1, d1 = D.lift_fwd_run_cuda(xin, levels, mode, sch, tile=tile,
                                                             block_rows=rb)
                                _equal_or_raise("lift1d_fwd run " + label, [s1, *d1], [s0, *d0])
                                sin = _misaligned(s0) if mis else s0
                                din = [_misaligned(d) for d in d0] if mis else d0
                                _equal_or_raise("lift1d_inv run " + label, [D.lift_inv_run_cuda(
                                    sin, din, mode, sch, tile=tile, block_rows=rb)], [xt])
                                cases += 1
    return cases


class PlainGuard:
    """Counts calls of the plain versions with a CUDA tensor (or a CUDA
    ``device``) while active: on the main path there must be none.
    ``paused()`` stops counting for comparisons that call them on purpose."""

    TARGETS = (
        ("repro_torch.kernels.dwt53", ("lift_fwd_windows_plain", "lift_inv_windows_plain")),
        ("repro_torch.kernels.fused3d", ("fwd3d_whole_plain", "inv3d_whole_plain",
                                         "fwd3d_slab_plain", "inv3d_slab_plain")),
        ("repro_torch.core.schemes", ("lift_fwd_axis", "lift_inv_axis")),
        ("repro_torch.codec.rice", ("encode_band_plain", "decode_band_plain")),
    )
    # the 2-D levels' and the 1-D runs' plain versions (the checkpoint path)
    TARGETS_2D = (
        ("repro_torch.kernels.dwt53", ("lift_fwd_run_plain", "lift_inv_run_plain")),
        ("repro_torch.kernels.fused2d", ("fwd2d_chain_plain", "inv2d_chain_plain",
                                         "_fwd2d_math", "_inv2d_math")),
        ("repro_torch.kernels.tiled2d", ("fwd2d_tiled_plain", "inv2d_tiled_plain")),
    )

    def __init__(self, targets=TARGETS):
        self.targets = targets

    def __enter__(self):
        import importlib

        self.calls, self.saved, self.active = {}, [], True
        for mod_name, fns in self.targets:
            mod = importlib.import_module(mod_name)
            for fn in fns:
                orig = getattr(mod, fn)
                self.saved.append((mod, fn, orig))
                setattr(mod, fn, self._wrap(f"{mod_name}.{fn}", orig))
        return self

    def _wrap(self, label, orig):
        def wrapped(*args, **kwargs):
            vals = list(args) + list(kwargs.values())
            if self.active and any(
                    (isinstance(v, torch.Tensor) and v.is_cuda)
                    or (isinstance(v, (str, torch.device)) and str(v).startswith("cuda"))
                    for v in vals):
                self.calls[label] = self.calls.get(label, 0) + 1
            return orig(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def paused(self):
        self.active = False
        try:
            yield
        finally:
            self.active = True

    def __exit__(self, *exc):
        for mod, fn, orig in self.saved:
            setattr(mod, fn, orig)
        return False


# lift1d launches on the 1-D path: per unchecked LARGE* pyramid one each
# way; the checked forward certifies level by level (3 one-level steps)
# and its checks step again; the container and the stream's 4 frames;
# the two cdf22 policy pyramids, one each way.  The per-level kernels
# before the runs launched 57 / 43.
LIFT1D_PATH_LAUNCHES = {"lift1d_fwd": 30, "lift1d_inv": 13}
# 4-level cdf22 pyramids (policy runs) on the 1-D path: (a) the LARGE
# shape, (c) one stablelm-1.6b MLP matrix flattened as the wz codec does
POLICY_1D = (("a", (64, 65536)), ("c", (1, 2048 * 5632)))


def library_path_1d(rng, dev) -> dict:
    """Phase 6: the repo's 1-D configs, checked mode and the 1-D codec on
    the card; the counters and the plain-version guard cover exactly the
    driven path, the comparisons with the plain versions come after."""
    from repro_torch import kernels as K
    from repro_torch.codec import container as C
    from repro_torch.codec import stream as ST
    from repro_torch.configs import dwt53 as CFG
    from repro_torch.core import lifting as L
    from repro_torch.core import ranges as RG
    from repro_torch.resilience.errors import IntegerOverflowError

    configs = (CFG.LARGE, CFG.LARGE_HAAR, CFG.LARGE_97M)
    inputs = {c.name: torch.from_numpy(rng.integers(*PCM16, (c.batch, c.signal_len), dtype=np.int32))
              .to(dev) for c in configs}
    # over range for 97m: full-range int32 samples, and 16-bit noise with
    # two samples one past the one-level certificate
    cert1 = RG.range_certificate("97m", 1, "int32", mode=CFG.LARGE_97M.mode)
    over = {"full_range": rng.integers(I32.min, I32.max, (64, 65536), dtype=np.int32,
                                       endpoint=True)}
    edge = rng.integers(*PCM16, (64, 65536), dtype=np.int32)
    edge[5, 100], edge[60, 7] = cert1.lo - 1, cert1.hi + 1
    over["one_past_level1_certificate"] = edge
    big = CFG.LARGE
    chunks = [rng.integers(*PCM16, shape, dtype=np.int32)
              for shape in ((64, 16384), (64, 16384), (64, 16384), (3, 100))]
    policy_in = {key: torch.from_numpy(rng.integers(*PCM16, shape, dtype=np.int32)).to(dev)
                 for key, shape in POLICY_1D}
    torch.cuda.synchronize(dev)

    K.launches.reset()
    ms, out, raised, per_call = {}, {}, {}, {}
    with PlainGuard() as guard:
        for cfg in configs:
            x = inputs[cfg.name]
            for checked in (False, True):
                kw = dict(mode=cfg.mode, scheme=cfg.scheme, checked=checked)
                before = K.launches.snapshot()
                pyr, t_f = _timed(lambda: K.dwt_fwd(x, levels=cfg.levels, **kw), dev)
                mid = K.launches.snapshot()
                y, t_i = _timed(lambda: K.dwt_inv(pyr, **kw), dev)
                after = K.launches.snapshot()
                per_call[f"{cfg.name} checked={checked}"] = {
                    "forward": mid.get("lift1d_fwd", 0) - before.get("lift1d_fwd", 0),
                    "inverse": after.get("lift1d_inv", 0) - mid.get("lift1d_inv", 0)}
                out[(cfg.name, checked)] = (pyr, y)
                ms[f"{cfg.name} checked={checked}"] = {"forward": t_f, "inverse": t_i}
        for key, x in policy_in.items():  # cdf22: one policy run each way, no row pass
            kw = dict(mode="paper", scheme="cdf22", checked=False)
            before = K.launches.snapshot()
            pyr, t_f = _timed(lambda: K.dwt_fwd(x, levels=4, **kw), dev)
            mid = K.launches.snapshot()
            y, t_i = _timed(lambda: K.dwt_inv(pyr, **kw), dev)
            after = K.launches.snapshot()
            per_call[f"cdf22 ({key}) checked=False"] = {
                d: {k: b.get(k, 0) - a.get(k, 0) for k in ("lift1d_" + d, "rows1d_" + d)}
                for d, a, b in (("fwd", before, mid), ("inv", mid, after))}
            out[("cdf22", key)] = (pyr, y)
            ms[f"cdf22 ({key}) checked=False"] = {"forward": t_f, "inverse": t_i}
        for label, xo in over.items():
            try:
                K.dwt_fwd(torch.from_numpy(xo).to(dev), levels=4, scheme="97m",
                          mode=CFG.LARGE_97M.mode, checked=True)
            except IntegerOverflowError as e:
                raised[label] = str(e)[:160]
            else:
                raise AssertionError(f"97m x4 checked forward of {label} did not raise")
        pyr_big = out[(big.name, False)][0]
        blob, ms["container_encode"] = _timed(
            lambda: C.encode_pyramid(pyr_big, scheme=big.scheme, mode=big.mode), dev)
        dec, ms["container_decode"] = _timed(lambda: C.decode_pyramid(blob, device=dev), dev)
        x_dec, ms["inverse_transform"] = _timed(lambda: C.inverse_transform(dec), dev)
        enc = ST.StreamEncoder(levels=4, scheme=big.scheme, mode=big.mode, ndim=1, device=dev)
        data, ms["stream_encode"] = _timed(lambda: b"".join(enc.encode(chunks)), dev)
        back, ms["stream_decode"] = _timed(lambda: list(ST.decode_stream(data, device=dev)), dev)
    counts = K.launches.snapshot()
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors on the 1-D path: {guard.calls}")
    need = list(KERNELS_1D) + ["rice_encode", "rice_decode"]
    missing = [k for k in need if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the 1-D path: {counts}")
    if counts["rice_decode"] != 1 + len(chunks):
        raise AssertionError(f"{counts['rice_decode']} rice_decode launches for one container and "
                             f"a stream of {len(chunks)} frames: want one per container")
    for cfg in configs:  # an unchecked 4-level pyramid is one run: one launch each way
        got = per_call[f"{cfg.name} checked=False"]
        if got != {"forward": 1, "inverse": 1}:
            raise AssertionError(f"{cfg.name}: unchecked dwt_fwd / dwt_inv launched lift1d "
                                 f"{got}, want once each")
    for key, _ in POLICY_1D:
        got = per_call.pop(f"cdf22 ({key}) checked=False")
        want = {"fwd": {"lift1d_fwd": 1, "rows1d_fwd": 0}, "inv": {"lift1d_inv": 1, "rows1d_inv": 0}}
        if got != want:
            raise AssertionError(f"cdf22 ({key}): an unchecked 4-level pyramid launched {got}, "
                                 f"want one lift1d launch each way and no row pass")
        per_call[f"cdf22 ({key}) checked=False"] = {"forward": 1, "inverse": 1}
    lift = {k: counts[k] for k in LIFT1D_PATH_LAUNCHES}
    if lift != LIFT1D_PATH_LAUNCHES:
        raise AssertionError(f"lift1d launches on the 1-D path {lift}, want {LIFT1D_PATH_LAUNCHES}")

    for cfg in configs:
        x = inputs[cfg.name]
        want = L.dwt_fwd(x, levels=cfg.levels, mode=cfg.mode, scheme=cfg.scheme)
        for checked in (False, True):
            pyr, y = out[(cfg.name, checked)]
            _equal_or_raise(f"{cfg.name} checked={checked} pyramid",
                            (pyr.approx,) + pyr.details, (want.approx,) + want.details)
            _equal_or_raise(f"{cfg.name} checked={checked} round trip", [y], [x])
    for key, x in policy_in.items():
        want = L.dwt_fwd(x, levels=4, mode="paper", scheme="cdf22")
        pyr, y = out[("cdf22", key)]
        _equal_or_raise(f"cdf22 ({key}) pyramid", (pyr.approx,) + pyr.details,
                        (want.approx,) + want.details)
        _equal_or_raise(f"cdf22 ({key}) round trip", [y], [x])
    x = inputs[big.name]
    cpu_pyr = L.WaveletPyramid(approx=pyr_big.approx.cpu(),
                               details=tuple(d.cpu() for d in pyr_big.details))
    if C.encode_pyramid(cpu_pyr, scheme=big.scheme, mode=big.mode) != blob:
        raise AssertionError("1-D container coded on the card differs from the plain encode")
    _equal_or_raise("1-D container decode", (dec.pyramid.approx,) + dec.pyramid.details,
                    (pyr_big.approx,) + pyr_big.details)
    _equal_or_raise("1-D container inverse_transform", [x_dec], [x])
    cpu_enc = ST.StreamEncoder(levels=4, scheme=big.scheme, mode=big.mode, ndim=1, device="cpu")
    if b"".join(cpu_enc.encode(chunks)) != data:
        raise AssertionError("1-D stream coded on the card differs from the plain encode")
    _equal_or_raise("1-D stream round trip", [b.cpu() for b in back],
                    [torch.from_numpy(c) for c in chunks])
    torch.cuda.synchronize(dev)
    return {"launches": counts, "lift1d_per_call": per_call, "plain_calls_on_cuda": guard.calls,
            "ms": ms,
            "raised": raised, "container_bytes": len(blob), "stream_bytes": len(data),
            "plans": {cfg.name: [K.plan_1d(cfg.signal_len >> lv, dev, cfg.scheme)
                                 for lv in range(cfg.levels)] for cfg in configs}}


def _ops_per_sample(sch) -> float:
    """Adds and shifts per sample of one 1-D level: the scheme's count per
    (s, d) pair (``pair_op_counts``, the Table-2 ledger), halved."""
    return sum(sch.pair_op_counts()[k] for k in ("adders", "shifters")) / 2


SHAPES_1D = {
    "a": (64, 65536),  # LARGE: 16 MiB, L2-resident
    "b": (1024, 65536),  # 256 MiB, beyond the 50 MB L2
    "c": (1, 2048 * 5632),  # one stablelm-1.6b MLP matrix, flattened as the wz codec does
}
# the runs phase 9 times: cdf53 (windowed) at the three shapes; cdf22
# (policy runs) at the same shapes; haar at their odd neighbours, where
# every level is odd (policy runs)
RUNS_1D = (tuple((k, "cdf53", shape) for k, shape in SHAPES_1D.items())
           + tuple((f"{k} cdf22", "cdf22", shape) for k, shape in SHAPES_1D.items())
           + tuple((f"{k}' haar", "haar", (r, n + 1)) for k, (r, n) in SHAPES_1D.items()))
# the row pass: lines under 8 pairs; (3, 13) is level 3 of the 1-D path's
# (3, 100) stream frame, (4096, 15) a batch of short lines
ROWS_1D = {"path": (3, 13), "short": (4096, 15)}


def time_1d(rng, dev) -> list:
    """Phase 9, 1-D half: 4-level runs through the run kernels (one
    launch each way: events, device ms from the profiler, host us a call,
    launches a call), beside the run's plain version and its bound (the
    level-0 signal read once, every band written once): cdf53 (windowed)
    at (a), (b), (c), cdf22 (policy) at the same shapes, haar (policy) at
    their odd neighbours; the row pass on lines under 8 pairs, one level,
    beside its plain version and its bound."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import dwt53 as D

    levels = 4
    mode = "paper"
    entries = {k: {"per_shape": {}} for k in KERNELS_1D}
    for key, name, (rows, n0) in RUNS_1D:
        sch = S.get_scheme(name)
        x0 = torch.from_numpy(rng.integers(*PCM16, (rows, n0), dtype=np.int32)).to(dev)
        lens = D.run_lengths(n0, levels)
        ops = sum(rows * n * _ops_per_sample(sch) for n in lens)
        s, ds = D.lift_fwd_run_cuda(x0, levels, mode, sch)
        per_call = len(D.run_launches(rows, n0, levels, sch, dev))
        runs = {
            "lift1d_fwd": (lambda: (lambda o: [o[0], *o[1]])(D.lift_fwd_run_cuda(x0, levels, mode, sch)),
                           lambda: (lambda o: [o[0], *o[1]])(D.lift_fwd_run_plain(x0, levels, mode, sch))),
            "lift1d_inv": (lambda: [D.lift_inv_run_cuda(s, ds, mode, sch)],
                           lambda: [D.lift_inv_run_plain(s, ds, mode, sch)]),
        }
        for kname, (kern, plain) in runs.items():
            err = _equal_or_raise(f"{kname} {name} {rows}x{n0} x{levels}", kern(), plain())
            t_bytes, by = bound(2 * rows * n0 * 4, ops)
            entries[kname]["per_shape"][key] = {
                "scheme": name, "shape": [rows, n0], "policy": D.run_policy(sch, n0, levels),
                "err": err, "ms": _median_ms(kern, 20), "plain_ms": _median_ms(plain, 3),
                "device_ms": _device_ms(kern, per_call), "host_us": _host_us(kern, dev),
                "launches_a_call": per_call, "bound_ms": t_bytes, "bound_by": by}
        del x0, s, ds
        torch.cuda.empty_cache()
    rows_sch = S.get_scheme("cdf22")
    for key, (rows, n) in ROWS_1D.items():
        x = torch.from_numpy(rng.integers(*PCM16, (rows, n), dtype=np.int32)).to(dev)
        rs, rd = D.rows_fwd_cuda(x, mode, rows_sch)
        pair = {
            "rows1d_fwd": (lambda: D.rows_fwd_cuda(x, mode, rows_sch),
                           lambda: S.lift_fwd_axis(x, rows_sch, axis=-1, mode=mode)),
            "rows1d_inv": (lambda: [D.rows_inv_cuda(rs, rd, mode, rows_sch)],
                           lambda: [S.lift_inv_axis(rs, rd, rows_sch, axis=-1, mode=mode)]),
        }
        for kname, (kern, plain) in pair.items():
            err = _equal_or_raise(f"{kname} cdf22 {rows}x{n}", kern(), plain())
            t_bytes, by = bound(2 * rows * n * 4, rows * n * _ops_per_sample(rows_sch))
            entries[kname]["per_shape"][key] = {
                "scheme": "cdf22", "shape": [rows, n], "err": err, "ms": _median_ms(kern, 20),
                "plain_ms": _median_ms(plain, 3), "device_ms": _device_ms(kern, 1),
                "host_us": _host_us(kern, dev), "launches_a_call": 1, "bound_ms": t_bytes,
                "bound_by": by}
        del x, rs, rd
    out = []
    for name, ent in entries.items():
        source, replaces = KERNELS_1D[name]
        head = ent["per_shape"]["a" if name.startswith("lift1d") else "path"]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max(e["err"] for e in ent["per_shape"].values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "shapes": {k: {f: v[f] for f in ("scheme", "shape", "policy", "ms", "plain_ms",
                                             "bound_ms", "device_ms", "host_us",
                                             "launches_a_call") if f in v}
                       for k, v in ent["per_shape"].items()},
        })
    return out


# ---------------------------------------------------------------------------
# Phases 7, 8 and 9: the 3-D volume engine.
# ---------------------------------------------------------------------------

KERNELS_3D = {
    "whole3d_fwd": ("src/repro_torch/csrc/whole3d.cu", "src/repro/kernels/fused3d.py:116"),
    "whole3d_inv": ("src/repro_torch/csrc/whole3d.cu", "src/repro/kernels/fused3d.py:133"),
    "slab3d_fwd": ("src/repro_torch/csrc/slab3d.cu", "src/repro/kernels/fused3d.py:216"),
    "slab3d_inv": ("src/repro_torch/csrc/slab3d.cu", "src/repro/kernels/fused3d.py:257"),
}
# the repo's large 3-D shape (benchmarks/kernels_bench.py SHAPE_3D_LARGE):
# 64 CT-like slices of 512 x 512
VOLUME = (64, 512, 512)
VOL_LEVELS, VOL_SCHEME, VOL_MODE = 4, "cdf53", "jpeg2000"
VOL_BUCKETS = ((16, 256, 256), (64, 512, 512))
VOL_SLOTS, VOL_REQUESTS = 4, 8
CT12 = (-2048, 2048)  # 12-bit samples with the DC level shift: -2048 .. 2047


def phantom(rng, shape, dev, noise):
    """A CT-like 12-bit volume on ``dev``: air around an ellipsoidal body
    of soft tissue holding five denser or lighter ellipsoids, plus
    integer noise in [-noise, noise], clipped to [-2048, 2047]."""
    d, h, w = shape
    z = torch.linspace(-1, 1, d, device=dev).view(d, 1, 1)
    y = torch.linspace(-1, 1, h, device=dev).view(1, h, 1)
    x = torch.linspace(-1, 1, w, device=dev).view(1, 1, w)
    vol = torch.full(shape, -1024.0, device=dev)
    for k in range(6):
        c = rng.uniform(-0.4, 0.4, 3) if k else np.zeros(3)
        r = rng.uniform(0.12, 0.4, 3) if k else np.array([0.95, 0.8, 0.85])
        val = float(rng.uniform(-600, 1800)) if k else 40.0
        inside = (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
                  + ((x - c[2]) / r[2]) ** 2) <= 1
        vol = torch.where(inside, torch.full_like(vol, val), vol)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    vol += torch.randint(-noise, noise + 1, shape, generator=gen, device=dev).float()
    return vol.round().clamp(CT12[0], CT12[1] - 1).to(torch.int32)


def _shrink(shape, levels):
    """The (d, h, w) of each level's input."""
    out = [tuple(shape)]
    for _ in range(levels - 1):
        out.append(tuple(n - n // 2 for n in out[-1]))
    return out


def _leaves3(pyr):
    return [pyr.approx] + [b for lvl in pyr.details for b in lvl]


def parity_sweep_3d(rng, dev) -> dict:
    """Phase 7: both 3-D kernels against their plain versions,
    ``torch.equal``: the one-block whole-volume path, the three-pass path,
    depth slabs at the picked and forced depths, lines in global scratch,
    int32 extremes, and the library entry with lead dims and forced
    ``REPRO_DWT_SLAB``."""
    import os

    from repro_torch import kernels as K
    from repro_torch.core import lifting as L
    from repro_torch.core import schemes as S
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import fused3d as F3

    cases = {"whole3d": 0, "whole3d_multipass": 0, "whole3d_by_cluster": {}, "slab3d": 0,
             "slab3d_plane_pass": 0, "slab3d_row_col_passes": 0, "library": 0}
    by_cluster = cases["whole3d_by_cluster"]

    def check(label, xt, mode, name, tds):
        """The whole-volume kernels at the geometry's cluster size, then
        forced to the three passes and to every other cluster size the
        shape admits; then the slab kernels."""
        want = F3.fwd3d_whole_plain(xt, mode, name)
        back = F3.inv3d_whole_plain(want, mode, name)
        bsz, d, h, w = xt.shape
        picked = F3.volume_geometry(bsz, d, h, w, dev)["cluster"]
        _equal_or_raise(f"whole3d_fwd {label}/c={picked}", F3.fwd3d_whole_cuda(xt, mode, name),
                        want)
        _equal_or_raise(f"whole3d_inv {label}/c={picked}",
                        [F3.inv3d_whole_cuda(want, mode, name)], [back])
        by_cluster[picked] = by_cluster.get(picked, 0) + 1
        plans = [F3._whole_plan(bsz, d, h, w, S.get_scheme(name), mode, inverse, xt.device)
                 for inverse in (False, True)]
        for c in (0,) + F3.CLUSTER_SIZES:
            if c == picked or (c and not F3.cluster_fits(d, h, w, c, dev)):
                continue
            fwd, inv = (F3._at_cluster(p, c) for p in plans)
            _equal_or_raise(f"whole3d_fwd {label}/c={c}", F3._whole_fwd(xt, fwd), want)
            _equal_or_raise(f"whole3d_inv {label}/c={c}", [F3._whole_inv(want, inv)], [back])
            by_cluster[c] = by_cluster.get(c, 0) + 1
        cases["whole3d" if picked else "whole3d_multipass"] += 1
        check_slab(label, xt, mode, name, tds, want)

    def check_slab(label, xt, mode, name, tds, want):
        for td in tds:
            lab = f"{label}/td{td}"
            _equal_or_raise("slab3d_fwd " + lab, F3.fwd3d_slab_cuda(xt, mode, td, name),
                            F3.fwd3d_slab_plain(xt, mode, td, name))
            _equal_or_raise("slab3d_inv " + lab, [F3.inv3d_slab_cuda(want, mode, td, name)],
                            [F3.inv3d_slab_plain(want, mode, td, name)])
            cases["slab3d"] += 1
            plane = F3.slab_geometry(*xt.shape, td, name, False, dev)["plane_rows"]
            cases["slab3d_plane_pass" if plane else "slab3d_row_col_passes"] += 1

    # the plane pass's branches: H of 2, 3 and 5 (windows taller than the
    # slice), odd H and W (4-byte copies), W % 8 == 0 (16-byte copies),
    # several strips of rows with a ragged last one (130, 101, 77 rows),
    # haar at odd H (row and column passes); the whole-volume geometry's
    # cluster sizes 2, 4, 8 and 16 ((16, 4, 64), (16, 8, 64), (8, 16, 64),
    # (8, 64, 64)) and a volume no cluster holds (17, 256, 256)
    shapes = [(2, 2, 2), (3, 5, 7), (5, 9, 7), (8, 16, 16), (17, 33, 31), (9, 64, 64),
              (12, 6, 5), (16, 64, 64), (33, 130, 129), (4, 2, 16), (6, 3, 8), (5, 5, 24),
              (7, 13, 40), (4, 20, 9), (8, 9, 16), (3, 101, 1000), (3, 77, 1001),
              (4, 130, 512), (16, 4, 64), (16, 8, 64), (8, 16, 64), (8, 64, 64),
              (17, 256, 256)]
    for name in SCHEMES:
        sch = S.get_scheme(name)
        for mode in MODES:
            for shp in shapes:
                kinds = ("rand", "min", "max") if max(shp) <= 33 else ("rand",)
                for kind in kinds:
                    if kind == "rand":
                        x = rng.integers(-(1 << 20), 1 << 20, (2,) + shp, dtype=np.int32)
                    else:
                        x = np.full((2,) + shp, I32.min if kind == "min" else I32.max, np.int32)
                    tds = ({2, 4, B.pick_slab(*shp, sch.halo, dev)} if sch.can_window(shp[0])
                           else set())
                    check(f"{name}/{mode}/2x{shp}/{kind}", torch.from_numpy(x).to(dev), mode,
                          name, sorted(tds))
            # the library entry: lead dims, and forced slabs through the
            # level dispatch (REPRO_DWT_SLAB keeps its reference meaning)
            x = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (2, 3, 6, 10, 12),
                                              dtype=np.int32)).to(dev)
            pyr = K.dwt_fwd_nd(x, levels=2, mode=mode, scheme=name)
            _equal_or_raise(f"dwt_fwd_nd {name}/{mode}/(2,3)x(6,10,12)", _leaves3(pyr),
                            _leaves3(L.dwt_fwd_nd(x, levels=2, mode=mode, scheme=name)))
            _equal_or_raise(f"dwt_inv_nd {name}/{mode}/(2,3)x(6,10,12)",
                            [K.dwt_inv_nd(pyr, mode=mode, scheme=name)], [x])
            cases["library"] += 1
            for td in ("2", "4"):
                os.environ["REPRO_DWT_SLAB"] = td
                try:
                    for shp in ((9, 64, 64), (12, 6, 5)):
                        x = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (1,) + shp,
                                                          dtype=np.int32)).to(dev)
                        want_plan = "slab-cuda" if sch.can_window(shp[0]) else "whole-cuda"
                        if K.plan_3d(*shp, dev, name) != want_plan:
                            raise AssertionError(f"REPRO_DWT_SLAB={td} {shp} {name}: plan "
                                                 f"{K.plan_3d(*shp, dev, name)}")
                        pyr = K.dwt_fwd_nd(x, levels=2, mode=mode, scheme=name)
                        label = f"{name}/{mode}/{shp}/REPRO_DWT_SLAB={td}"
                        _equal_or_raise("dwt_fwd_nd " + label, _leaves3(pyr),
                                        _leaves3(L.dwt_fwd_nd(x, levels=2, mode=mode,
                                                              scheme=name)))
                        _equal_or_raise("dwt_inv_nd " + label,
                                        [K.dwt_inv_nd(pyr, mode=mode, scheme=name)], [x])
                        cases["library"] += 1
                finally:
                    del os.environ["REPRO_DWT_SLAB"]
    # lines longer than one block's shared memory: global staging
    for shp in ((3, 5, 60001), (60001, 3, 2)):
        x = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (1,) + shp, dtype=np.int32)).to(dev)
        check(f"cdf53/paper/{shp}", x, "paper", "cdf53",
              [B.pick_slab(*shp, S.get_scheme("cdf53").halo, dev)])
    # the main path's full-size batches, both windowed schemes of the sweep
    for name in ("cdf53", "97m"):
        x = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (VOL_SLOTS,) + VOLUME,
                                          dtype=np.int32)).to(dev)
        td = B.pick_slab(*VOLUME, S.get_scheme(name).halo, dev)
        want = [b.contiguous() for b in F3.fwd3d_slab_plain(x, "jpeg2000", td, name)]
        check_slab(f"{name}/jpeg2000/{VOL_SLOTS}x{VOLUME}", x, "jpeg2000", name, [td], want)
        del x, want
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    return cases


def volume_images(rng, dev):
    """VOL_REQUESTS volumes, alternating buckets, a quarter undersized, half
    12-bit noise and half smooth phantoms (ellipsoids, +-2 noise), so the
    Rice parameters span small and large k."""
    imgs = []
    for uid in range(VOL_REQUESTS):
        bd, bh, bw = VOL_BUCKETS[uid % 2]
        undersized = uid in (2, 7)  # one in each bucket
        shape = (bd - bd // 16, bh - bh // 64 - 1, bw - bw // 16) if undersized else (bd, bh, bw)
        if uid % 4 in (1, 2):
            imgs.append(phantom(rng, shape, dev, noise=2).cpu().numpy())
        else:
            imgs.append(rng.integers(*CT12, shape, dtype=np.int32))
    return imgs


def plain_volume_container(bands, kind_lead, shape, levels):
    """The container ``encode_batch`` / ``encode_pyramid`` must give for
    N-D bands, each coded by the plain Rice encode where it lives."""
    from repro_torch.codec import container as C
    from repro_torch.codec import rice as R

    coded = [R.encode_band_plain(b.reshape(-1), chunk_blocks=8192) for b in bands]
    return C.assemble(coded, C.KIND_ND, VOL_SCHEME, VOL_MODE, np.dtype(np.int32), levels, 3,
                      kind_lead, shape)


def volume_breakdown(reqs, dev) -> dict:
    """One encoded 3-D serve step of the largest bucket, phase by phase,
    each timed alone on the host clock with a device sync after it."""
    from repro_torch import kernels as K
    from repro_torch.codec import container as C

    bucket = VOL_BUCKETS[-1]

    def assemble_batch():
        batch = np.zeros((VOL_SLOTS,) + bucket, np.int32)
        for i, r in enumerate(reqs):
            batch[(i,) + tuple(slice(0, s) for s in r.image.shape)] = r.image
        return batch

    ms = {}
    batch, ms["host_assembly"] = _timed(assemble_batch, dev)
    xb, ms["host_to_device"] = _timed(lambda: torch.from_numpy(batch).to(dev), dev)
    pyr, ms["forward_all_levels"] = _timed(
        lambda: K.dwt_fwd_nd(xb, levels=VOL_LEVELS, mode=VOL_MODE, scheme=VOL_SCHEME), dev)
    bands = [b.reshape(-1) for b in _leaves3(pyr)]
    coded, enc_ms = encode_stages(bands, dev)
    ms.update(enc_ms)
    blob, ms["host_crc32_and_header"] = _timed(lambda: C.assemble(
        coded, C.KIND_ND, VOL_SCHEME, VOL_MODE, np.dtype(np.int32), VOL_LEVELS, 3, (VOL_SLOTS,),
        bucket), dev)
    ms["step_sum"] = sum(ms.values())
    want = C.encode_batch(pyr, scheme=VOL_SCHEME, mode=VOL_MODE, ndim=3)
    if blob != want:
        raise AssertionError("3-D step stages differ from encode_batch")
    return {"ms": ms, "container_bytes": len(blob), "payload_bytes": sum(len(c[0]) for c in coded),
            "coefficients": sum(b.numel() for b in bands)}


def volume_paths(rng, dev) -> dict:
    """Phase 8: the 3-D library at full width, the 3-D serve route
    (plain and encoded, decoded and inverted on the card) and a WZRS
    volume stream.  The launch counters are reset just before and read
    just after driving them, under a guard that counts plain-version
    calls on CUDA tensors; the comparisons with the plain versions come
    after."""
    from repro_torch import codec, obs
    from repro_torch import kernels as K
    from repro_torch.codec import container as C
    from repro_torch.codec import stream as ST
    from repro_torch.core import lifting as L
    from repro_torch.core import ranges as RG
    from repro_torch.resilience.errors import IntegerOverflowError
    from repro_torch.serve import (ProgressiveServeRoute, TransformRequest, WaveletServeEngine,
                                   crop_result)

    vol = phantom(rng, VOLUME, dev, noise=20)
    x1 = vol[None]
    cert1 = RG.range_certificate("97m", 1, "int32", mode="paper", ndim=3)
    over = {"full_range": torch.from_numpy(rng.integers(I32.min, I32.max, VOLUME, dtype=np.int32,
                                                        endpoint=True)).to(dev)}
    edge = vol.clone()
    edge[1, 3, 7], edge[-2, 7, -9] = cert1.lo - 1, cert1.hi + 1
    over["one_past_level1_certificate"] = edge
    imgs = volume_images(rng, dev)
    reqs_plain, reqs_enc = ([TransformRequest(uid=i, image=img) for i, img in enumerate(imgs)]
                            for _ in range(2))
    vol_np = vol.cpu().numpy()
    engines = [WaveletServeEngine(buckets=VOL_BUCKETS, batch_slots=VOL_SLOTS, levels=VOL_LEVELS,
                                  scheme=VOL_SCHEME, mode=VOL_MODE, device=str(dev),
                                  encode_response=enc) for enc in (False, True)]
    warm_s = []
    for eng in engines:
        t = time.perf_counter()
        eng.warmup()
        warm_s.append(time.perf_counter() - t)
    torch.cuda.synchronize(dev)

    K.launches.reset()
    obs.reset()
    ms, lib, raised, served = {}, {}, {}, {}
    with PlainGuard() as guard:
        # the library: cdf53/jpeg2000 (slabs, then one cluster) and
        # cdf22/paper (three passes at every level), checked and not
        for name, mode in ((VOL_SCHEME, VOL_MODE), ("cdf22", "paper")):
            for checked in (False, True):
                kw = dict(mode=mode, scheme=name, checked=checked)
                t_f, t_i = [], []  # three calls each: the first pays allocator growth
                for _ in range(3):
                    pyr, t = _timed(lambda: K.dwt_fwd_nd(x1, levels=VOL_LEVELS, **kw), dev)
                    t_f.append(t)
                    y, t = _timed(lambda: K.dwt_inv_nd(pyr, **kw), dev)
                    t_i.append(t)
                lib[(name, checked)] = (pyr, y)
                ms[f"{name} checked={checked}"] = {
                    "forward": statistics.median(t_f), "inverse": statistics.median(t_i),
                    "forward_first": t_f[0], "inverse_first": t_i[0]}
        for label, xo in over.items():
            try:
                K.dwt_fwd_nd(xo, levels=VOL_LEVELS, scheme="97m", mode="paper", checked=True)
            except IntegerOverflowError as e:
                raised[label] = str(e)[:160]
            else:
                raise AssertionError(f"97m checked forward of {label} did not raise")
        # serve, plain and encoded; the client decodes and inverts on the card
        for eng, reqs, key in ((engines[0], reqs_plain, "plain"), (engines[1], reqs_enc, "encoded")):
            for r in reqs:
                eng.submit(r)
            lat = []
            t_all = time.perf_counter()
            out = []
            while eng.scheduler.pending():
                t = time.perf_counter()
                out.extend(eng.step())
                torch.cuda.synchronize(dev)
                lat.append((time.perf_counter() - t) * 1e3)
            served[key] = {"reqs": out, "batch_ms": lat, "serve_s": time.perf_counter() - t_all}
        recon = {}
        for r in served["plain"]["reqs"]:
            recon[r.uid] = crop_result(K.dwt_inv_nd(r.pyramid, mode=VOL_MODE, scheme=VOL_SCHEME),
                                       r)
        rows_approx, recon_enc = {}, {}
        groups = {}
        for r in served["encoded"]["reqs"]:
            if r.error is not None or r.encoded is None or r.batch_index is None:
                raise AssertionError(f"volume request {r.uid}: served without bytes ({r.error})")
            groups.setdefault(id(r.encoded), []).append(r)
        for group in groups.values():
            rows = codec.decode_batch(group[0].encoded, device=dev)
            for r in group:
                row = rows[r.batch_index]
                rows_approx[r.uid] = row.approx
                recon_enc[r.uid] = crop_result(K.dwt_inv_nd(row, mode=VOL_MODE,
                                                            scheme=VOL_SCHEME), r)
        route = ProgressiveServeRoute(device=dev)
        thumb_req = next(r for r in served["encoded"]["reqs"] if r.padded)
        route.store(thumb_req)
        thumb = route.thumbnail(thumb_req.uid)
        # a WZRS volume stream: depth slabs of 8, 3 levels each
        data, ms["stream_encode"] = _timed(
            lambda: b"".join(ST.encode_volume(vol_np, slab=8, levels=3, scheme=VOL_SCHEME,
                                              mode=VOL_MODE, device=dev)), dev)
        back, ms["stream_decode"] = _timed(lambda: ST.decode_volume(data, device=dev), dev)
    counts = K.launches.snapshot()
    metrics = obs.snapshot()["metrics"]
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors on the 3-D path: {guard.calls}")
    need = list(KERNELS_3D) + ["rice_encode", "rice_decode"]
    missing = [k for k in need if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the 3-D path: {counts}")
    if metrics.get("serve.encode_degrades", 0) or metrics.get("serve.encode_quarantines", 0):
        raise AssertionError("the 3-D encoded route degraded or quarantined an encode")

    # the comparisons: the plain oracle, bit-exact round trips, plain bytes
    plans = {}
    for name, mode in ((VOL_SCHEME, VOL_MODE), ("cdf22", "paper")):
        want = L.dwt_fwd_nd(x1, levels=VOL_LEVELS, mode=mode, scheme=name)
        for checked in (False, True):
            pyr, y = lib[(name, checked)]
            _equal_or_raise(f"{name} {VOLUME} checked={checked} pyramid", _leaves3(pyr),
                            _leaves3(want))
            _equal_or_raise(f"{name} {VOLUME} checked={checked} round trip", [y], [x1])
        plans[name] = [K.plan_3d(*dhw, dev, name) for dhw in _shrink(VOLUME, VOL_LEVELS)]
        del want
    if plans[VOL_SCHEME] != ["slab-cuda"] * (VOL_LEVELS - 1) + ["whole-cuda"]:
        raise AssertionError(f"plan_3d {VOL_SCHEME}: {plans[VOL_SCHEME]}")
    if plans["cdf22"] != ["whole-cuda"] * VOL_LEVELS:
        raise AssertionError(f"plan_3d cdf22: {plans['cdf22']}")
    lib.clear()
    for key, reqs in (("plain", reqs_plain), ("encoded", reqs_enc)):
        got = served[key]["reqs"]
        if len(got) != VOL_REQUESTS or any(r.error is not None or not r.done for r in got):
            raise AssertionError(f"3-D {key} serve: {len(got)} of {VOL_REQUESTS} served")
    for r in served["plain"]["reqs"]:
        if not torch.equal(recon[r.uid], torch.from_numpy(r.image).to(dev)):
            raise AssertionError(f"volume request {r.uid}: reconstruction is not bit-exact")
    for r in served["encoded"]["reqs"]:
        if not torch.equal(recon_enc[r.uid], torch.from_numpy(r.image).to(dev)):
            raise AssertionError(f"volume request {r.uid}: encoded response is not bit-exact")
    checked_oracle = set()
    for r in served["plain"]["reqs"]:
        if r.bucket in checked_oracle:
            continue
        padded = torch.zeros(r.bucket, dtype=torch.int32, device=dev)
        padded[tuple(slice(0, s) for s in r.image.shape)] = torch.from_numpy(r.image).to(dev)
        _equal_or_raise(f"3-D serve oracle {r.bucket}", _leaves3(r.pyramid), _leaves3(
            L.dwt_fwd_nd(padded, levels=VOL_LEVELS, mode=VOL_MODE, scheme=VOL_SCHEME)))
        checked_oracle.add(r.bucket)
    want_thumb = rows_approx[thumb_req.uid][tuple(slice(0, s) for s in thumb.shape)]
    if not torch.equal(thumb, want_thumb):
        raise AssertionError(f"volume request {thumb_req.uid}: thumbnail != approx band")
    plain_checked = []
    by_bucket = {}
    for r in served["encoded"]["reqs"]:
        by_bucket.setdefault(r.bucket, []).append(r)
    for bucket, group in by_bucket.items():
        group = sorted(group, key=lambda r: r.batch_index)
        if any(r.encoded is not group[0].encoded for r in group):
            raise AssertionError(f"bucket {bucket}: more than one batch container")
        bands = [torch.stack([_leaves3(r.pyramid)[j] for r in group])
                 for j in range(1 + 7 * VOL_LEVELS)]
        if plain_volume_container(bands, (len(group),), bucket, VOL_LEVELS) != group[0].encoded:
            raise AssertionError(f"bucket {bucket}: container differs from the plain encode")
        plain_checked.append("x".join(map(str, bucket)))
    _equal_or_raise("volume stream round trip", [back], [vol])
    from repro_torch.codec import stream as ST2

    frames = [ST2.stream_header()]
    for i in range(0, VOLUME[0], 8):
        slab_pyr = L.dwt_fwd_nd(vol[i:i + 8], levels=3, mode=VOL_MODE, scheme=VOL_SCHEME)
        frames.append(ST2.frame(plain_volume_container(_leaves3(slab_pyr), (), (8,) + VOLUME[1:],
                                                       3)))
    frames.append(ST2.terminator())
    if b"".join(frames) != data:
        raise AssertionError("3-D stream coded on the card differs from the plain encode")
    stream_bands = stream_decode_check(data, dev)
    big = sorted((r for r in served["encoded"]["reqs"] if r.bucket == VOL_BUCKETS[-1]),
                 key=lambda r: r.batch_index)
    breakdown = volume_breakdown(big, dev)
    torch.cuda.synchronize(dev)
    summary = {}
    for key in ("plain", "encoded"):
        lat = sorted(served[key]["batch_ms"])
        summary[key] = {"requests": len(served[key]["reqs"]),
                        "undersized": sum(r.padded for r in served[key]["reqs"]),
                        "batches": len(lat), "requests_per_s":
                        len(served[key]["reqs"]) / served[key]["serve_s"],
                        "batch_ms_p50": statistics.median(lat), "batch_ms": lat}
    return {"launches": counts, "plain_calls_on_cuda": guard.calls, "ms": ms, "raised": raised,
            "plans": plans, "serve": summary, "warmup_s": warm_s,
            "container_bytes": {str(r.uid): len(r.encoded) for r in served["encoded"]["reqs"]},
            "plain_container_checked": plain_checked, "thumbnail_uid": thumb_req.uid,
            "stream_bytes": len(data), "stream_bands_checked": stream_bands,
            "breakdown_ms": breakdown}


def stream_decode_check(data, dev) -> int:
    """Every band of every frame of a WZRS stream decoded on the card in
    one launch a frame, each equal to the plain decode.  Returns the
    bands checked."""
    from repro_torch.codec import container as C
    from repro_torch.codec import rice as R
    from repro_torch.codec import stream as ST

    n = 0
    for f, blob in enumerate(ST.iter_frames(data)):
        h = C._parse_header(blob)
        blobs, _ = C._band_blobs(blob, h)
        shapes = C._expected_band_shapes(h.kind, h.shape, h.levels)
        coded = [C._band_coding(b, C._band_count(h, shp)) for b, shp in zip(blobs, shapes)]
        for i, (c, got) in enumerate(zip(coded, R.decode_checked(coded, dev))):
            _equal_or_raise(f"rice_decode stream frame {f} band {i}", [got],
                            [_plain_decode(c.payload, c.ks, c.lens, c.count, dev)])
            n += 1
    return n


# the whole-volume kernel's levels beside the volume's level 4: the
# (16, 256, 256) bucket's levels 3-4, level 3 of a WZRS depth slab of 8,
# and cdf22's level 3, which a cluster now holds
WHOLE3D_LEVELS = (
    ("bucket level 3", (VOL_SLOTS, 4, 64, 64), VOL_SCHEME, VOL_MODE),
    ("bucket level 4", (VOL_SLOTS, 2, 32, 32), VOL_SCHEME, VOL_MODE),
    ("stream level 3", (1, 2, 128, 128), VOL_SCHEME, VOL_MODE),
    ("cdf22 level 3", (VOL_SLOTS, 16, 128, 128), "cdf22", "paper"),
)


def _whole3d_level(x, bands, scheme, mode, dev) -> dict:
    """Both whole-volume wrappers at one level, each checked once more
    against its plain version: events ms, device ms (``torch.profiler``),
    host us per call, the plain version's ms and the cluster size."""
    from repro_torch.kernels import fused3d as F3

    out = {"shape": list(x.shape), "scheme": scheme,
           "cluster": F3.volume_geometry(*x.shape, dev)["cluster"],
           "bound_ms": 2 * x.numel() * 4 / PEAK_BYTES_PER_S * 1e3, "err": 0}
    per_call = 1 if out["cluster"] else 3  # one cluster launch, or the three passes
    for name, kern, plain in (
        ("whole3d_fwd", lambda: F3.fwd3d_whole_cuda(x, mode, scheme),
         lambda: F3.fwd3d_whole_plain(x, mode, scheme)),
        ("whole3d_inv", lambda: [F3.inv3d_whole_cuda(bands, mode, scheme)],
         lambda: [F3.inv3d_whole_plain(bands, mode, scheme)]),
    ):
        out["err"] = max(out["err"], _equal_or_raise(
            f"{name} {scheme} {tuple(x.shape)}", kern(), plain()))
        out[name] = {"ms": _median_ms(kern, 20), "device_ms": _device_ms(kern, per_call),
                     "host_us": _host_us(kern, dev), "plain_ms": _median_ms(plain, 3)}
    return out


def time_3d(rng, dev) -> list:
    """Phase 9, 3-D half: CUDA-event medians of each 3-D kernel over the 4 levels of
    one 4 x (64, 512, 512) batch (cdf53 / jpeg2000: slabs at levels 1-3,
    one cluster per volume at level 4), beside its plain version and
    bound; then the whole-volume kernels at every other level the 3-D path
    gives them, at cdf22's level 3 and at the three-pass level 1 (cdf22),
    recorded apart, each with its device ms, host us per call and cluster
    size."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import backend as B
    from repro_torch.kernels import fused3d as F3

    sch = S.get_scheme(VOL_SCHEME)
    # three axes, each lifting every sample: pair_op_counts per pair, x 1.5
    ops_per_sample = 1.5 * sum(sch.pair_op_counts()[k] for k in ("adders", "shifters"))
    x0 = torch.cat([phantom(rng, VOLUME, dev, noise=20)[None] for _ in range(VOL_SLOTS)])
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "err": 0, "levels": []}
           for k in KERNELS_3D}
    x = x0
    for lv, (d, h, w) in enumerate(_shrink(VOLUME, VOL_LEVELS)):
        plan = F3.plan_3d(d, h, w, dev, VOL_SCHEME)
        bands = F3.fwd3d_whole_plain(x, VOL_MODE, VOL_SCHEME)
        n = x.numel()
        nbytes = 2 * n * 4  # read every sample once, write every band once
        if plan == "slab-cuda":
            td = B.pick_slab(d, h, w, sch.halo, dev)
            runs = {
                "slab3d_fwd": (lambda: F3.fwd3d_slab_cuda(x, VOL_MODE, td, VOL_SCHEME),
                               lambda: F3.fwd3d_slab_plain(x, VOL_MODE, td, VOL_SCHEME)),
                "slab3d_inv": (lambda: [F3.inv3d_slab_cuda(bands, VOL_MODE, td, VOL_SCHEME)],
                               lambda: [F3.inv3d_slab_plain(bands, VOL_MODE, td, VOL_SCHEME)]),
            }
            for name, (kern, plain) in runs.items():
                e = per[name]
                err = _equal_or_raise(f"{name} {VOL_SLOTS}x{(d, h, w)}", kern(), plain())
                ms = _median_ms(kern, 20)
                pms = _median_ms(plain, 3)
                g = F3.slab_geometry(VOL_SLOTS, d, h, w, td, VOL_SCHEME, name.endswith("inv"),
                                     dev)
                e["levels"].append({"shape": [VOL_SLOTS, d, h, w], "ms": ms, "plain_ms": pms,
                                    "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "td": td,
                                    "passes": g["passes"], "plane_rows": g["plane_rows"],
                                    "pass_ms": _pass_ms(kern, per_call=g["passes"])})
                e["ms"] += ms
                e["plain_ms"] += pms
                e["bytes"] += nbytes
                e["ops"] += int(ops_per_sample * n)
                e["err"] = max(e["err"], err)
        else:
            lvl = _whole3d_level(x, [b.contiguous() for b in bands], VOL_SCHEME, VOL_MODE, dev)
            for name in ("whole3d_fwd", "whole3d_inv"):
                e, t = per[name], lvl[name]
                e["levels"].append({"shape": lvl["shape"], "cluster": lvl["cluster"],
                                    "bound_ms": lvl["bound_ms"], **t})
                e["ms"] += t["ms"]
                e["plain_ms"] += t["plain_ms"]
                e["bytes"] += nbytes
                e["ops"] += int(ops_per_sample * n)
                e["err"] = max(e["err"], lvl["err"])
        x = bands[0]
        del bands
    del x0, x
    # the whole-volume kernels' other levels, and the three-pass level 1
    # at full width (cdf22 cannot slab)
    others = {}
    for label, shape, scheme, mode in WHOLE3D_LEVELS + (
            ("three-pass level 1", (VOL_SLOTS,) + VOLUME, "cdf22", "paper"),):
        x = torch.from_numpy(rng.integers(CT12[0], CT12[1], shape, dtype=np.int32)).to(dev)
        bands = [b.contiguous() for b in F3.fwd3d_whole_plain(x, mode, scheme)]
        others[label] = _whole3d_level(x, bands, scheme, mode, dev)
        for name in ("whole3d_fwd", "whole3d_inv"):
            per[name]["err"] = max(per[name]["err"], others[label]["err"])
        del x, bands
    torch.cuda.empty_cache()
    out = []
    for name, (source, replaces) in KERNELS_3D.items():
        e = per[name]
        bound_ms, bound_by = bound(e["bytes"], e["ops"])
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "levels": e["levels"], "other_levels": None,
        }
        if name.startswith("whole3d"):
            row["other_levels"] = {
                label: {"shape": lv["shape"], "scheme": lv["scheme"], "cluster": lv["cluster"],
                        "bound_ms": lv["bound_ms"], **lv[name]}
                for label, lv in others.items()}
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Phase 10: checkpoints of a full-width stablelm-2-1.6b.
# ---------------------------------------------------------------------------

# stablelm-2-1.6b (repro_torch.configs) at full width; depth cut from 24 to
# 4 layers, the least at which the stacked leaves take the 3-D route (each
# of the three trailing dims >= 4)
CKPT_LAYERS = 4
# (codec, scheme), each on the whole tree
CKPT_CODECS = (("raw", "cdf53"), ("z", "cdf53"), ("wz", "cdf53"), ("wz2d", "cdf53"),
               ("wz3d", "cdf53"), ("wz-rice", "cdf53"), ("wz", "cdf22"))
# the prefix of each plan name's kernel counters, by the pyramid's rank
PLAN_KERNELS = {("1d", "windowed-cuda"): "lift1d", ("1d", "policy-cuda"): "lift1d",
                ("1d", "rows-cuda"): "rows1d", ("2d", "whole-cuda"): "whole2d",
                ("2d", "tiled-cuda"): "tiled2d", ("3d", "whole-cuda"): "whole3d",
                ("3d", "slab-cuda"): "slab3d"}


def stablelm_defs(layers: int = CKPT_LAYERS) -> dict:
    """The ``ParamDef`` tree of stablelm-2-1.6b at full width and
    ``layers`` layers (``repro_torch.models.transformer.model_defs``:
    stacked layers, LayerNorm scale and bias, swiglu, untied head)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF

    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=layers)
    return TF.model_defs(cfg)


def fill_kind(defn) -> str:
    """How phase 10 fills a leaf: normal(0, 0.02) for matrices and the
    embedding, ones for scales, zeros for biases."""
    return "normal" if defn.init in ("normal", "embed") else defn.init


def stablelm_params(rng, dev, layers: int = CKPT_LAYERS) -> dict:
    """bfloat16 parameters on the card: normal(0, 0.02) matrices from
    ``rng`` (numpy), ones for scales, zeros for biases, in the tree's leaf
    order."""
    from repro_torch import tree as T

    def make(defn):
        kind = fill_kind(defn)
        if kind == "normal":
            host = rng.standard_normal(defn.shape, dtype=np.float32)
            return torch.from_numpy(host).to(dev).mul_(0.02).to(torch.bfloat16)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(defn.shape, dtype=torch.bfloat16, device=dev)

    return T.map_leaves(make, stablelm_defs(layers))


class StageTimer:
    """While active, host ms per stage of a checkpoint save or restore (a
    device sync before and after each) and the stage's CUDA-event ms: it
    wraps the stage functions of ``ckpt/checkpoint.py`` and the zlib,
    sha256 and Rice-container calls it makes, as PlainGuard wraps the
    plain versions.  What no stage covers (file reads, the manifest,
    renames) is the total less the stages."""

    STAGES = (("ck", "_snapshot", "snapshot"), ("ck", "_quantize_for_wz", "quantize"),
              ("ck", "_pyramid", "transform"), ("ck", "_band_pack", "transform"),
              ("ck", "_unpyramid", "transform"), ("container", "inverse_transform", "transform"),
              ("ck", "_host_bytes", "d2h"), ("ck", "_h2d", "h2d"),
              ("ck", "_dequantized", "dequantize"), ("ck", "_write_file_synced", "write"),
              ("ck", "_fsync_dir", "write"), ("container", "encode_pyramid", "rice_encode"),
              ("container", "decode_pyramid", "rice_decode"), ("zlib", "compress", "zlib"),
              ("zlib", "decompress", "zlib"), ("hashlib", "sha256", "sha256"))

    def __init__(self, dev):
        self.dev, self.ms, self.event_ms, self._inside, self._saved = dev, {}, {}, False, []

    def _wrap(self, fn, stage):
        def timed(*args, **kwargs):
            if self._inside:  # a stage within a stage counts once
                return fn(*args, **kwargs)
            self._inside = True
            try:
                torch.cuda.synchronize(self.dev)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                a.record()
                out = fn(*args, **kwargs)
                b.record()
                torch.cuda.synchronize(self.dev)
            finally:
                self._inside = False
            self.ms[stage] = self.ms.get(stage, 0.0) + (time.perf_counter() - t) * 1e3
            self.event_ms[stage] = self.event_ms.get(stage, 0.0) + a.elapsed_time(b)
            return out
        return timed

    def __enter__(self):
        import hashlib
        import types

        from repro_torch.ckpt import checkpoint as CK
        from repro_torch.codec import container

        owners = {"ck": CK, "container": container,
                  "zlib": types.SimpleNamespace(compress=zlib.compress, decompress=zlib.decompress),
                  "hashlib": types.SimpleNamespace(sha256=hashlib.sha256)}
        self._saved = [(CK, "zlib", CK.zlib), (CK, "hashlib", CK.hashlib)]
        CK.zlib, CK.hashlib = owners["zlib"], owners["hashlib"]
        for owner, attr, stage in self.STAGES:
            obj = owners[owner]
            self._saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, self._wrap(getattr(obj, attr), stage))
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)
        return False

    def with_rest(self, total_ms: float) -> dict:
        """The stages' host ms and, under "rest", what they leave of the total."""
        return dict(self.ms, rest=total_ms - sum(self.ms.values()))


def wz_leaf_plan(codec: str, scheme: str, shape, levels: int):
    """(route, levels, quantization limit) a wavelet codec takes for a leaf
    (``ckpt/checkpoint.py``'s own rules)."""
    from repro_torch.ckpt import checkpoint as CK

    if codec == "wz-rice":
        route, lv = CK._wzrice_plan(tuple(shape), levels, scheme)
        return route, lv, 32767.0
    route = "1d" if codec == "wz" else CK._wavelet_route(tuple(shape), want_3d=codec == "wz3d")
    if route == "3d":
        lv = CK._wz3d_levels(*shape[-3:], levels)
    elif route == "2d":
        lv = CK._wz2d_levels(shape[-2], shape[-1], levels)
    else:
        lv = levels
    nd = int(route[0])
    return route, lv, CK._wz_quant_limit(float(32767 >> (nd * lv + 1)), scheme, lv, nd)


def _level_dims(route: str, shape, lv: int) -> list:
    """The trailing dims each level of a leaf's pyramid transforms."""
    if route == "1d":
        n = -(-int(np.prod(shape)) // (1 << lv)) * (1 << lv)  # padded to 2**lv
        dims = [(n,)]
    else:
        dims = [tuple(shape[-int(route[0]):])]
    for _ in range(lv - 1):
        dims.append(tuple(x - x // 2 for x in dims[-1]))
    return dims


def leaf_plans(route: str, shape, lv: int, scheme: str, dev) -> list:
    """The planner's answer for every level of a leaf's pyramid."""
    from repro_torch import kernels as K

    plan = {"1d": K.plan_1d, "2d": K.plan_2d, "3d": K.plan_3d}[route]
    return [plan(*dims, device=dev, scheme=scheme) for dims in _level_dims(route, shape, lv)]


def numpy_quantize(arr32: np.ndarray, lim: float):
    """The reference's host rule (``repro.ckpt.checkpoint._quantize_for_wz``)."""
    scale = float(np.max(np.abs(arr32)) or 1.0) / lim
    scale = max(scale, 1e-12)
    return np.clip(np.round(arr32 / scale), -lim, lim).astype(np.int32), scale


def plain_chain(route: str, lv: int, q, scheme: str, codec: str):
    """The payload a wavelet codec writes, from the plain versions on the
    card: the int16 band pack (zlib codecs) or the WZRC container
    (wz-rice, plain Rice encode of every band)."""
    from repro_torch.codec import container as C
    from repro_torch.codec import rice as R
    from repro_torch.core import lifting as L

    if route == "1d":
        flat = q.reshape(-1)
        pad = (-flat.numel()) % (1 << lv)
        flat = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
        pyr = L.dwt_fwd(flat[None], levels=lv, scheme=scheme)
        packed, ndim = L.pack(pyr)[0], None
    elif route == "2d":
        pyr = L.dwt_fwd_2d_multi(q.reshape((-1,) + tuple(q.shape[-2:])), levels=lv, scheme=scheme)
        packed, ndim = L.pack2d(pyr), None
    else:
        pyr = L.dwt_fwd_nd(q.reshape((-1,) + tuple(q.shape[-3:])), levels=lv, scheme=scheme,
                           ndim=3)
        packed, ndim = L.pack_nd(pyr), 3
    if codec != "wz-rice":
        return packed.to(torch.int16).cpu().numpy().tobytes()
    kind = C._pyramid_kind(pyr)
    nd, lead, shape = C._infer_geometry(pyr, kind, ndim)
    coded = [R.encode_band_plain(b.reshape(-1), chunk_blocks=8192)
             for b in C._flatten_bands(pyr, kind)]
    return C.assemble(coded, kind, scheme, "paper", np.dtype(np.int32), lv, nd, lead, shape,
                      parity=True)


def _damage_one_band(path: pathlib.Path) -> None:
    """Flip one byte in the middle of a container's largest band."""
    from repro_torch.codec import container as C
    from repro_torch.resilience import inject

    data = path.read_bytes()
    h = C._parse_header(data)
    i = int(np.argmax(h.blob_lens))
    path.write_bytes(inject.flip_byte(data, h.body_off + sum(h.blob_lens[:i]) + h.blob_lens[i] // 2))


def _restore_error(tree, out, man) -> dict:
    """Per leaf: max |restored - saved| and its bound (0.51 x the leaf's
    scale, plus one bfloat16 rounding of its largest value)."""
    from repro_torch import tree as T

    got = dict(T.leaf_paths(out))
    errs = {}
    for name, x in T.leaf_paths(tree):
        y = got[name]
        if y.dtype != x.dtype or y.shape != x.shape or y.device != x.device:
            raise AssertionError(f"restored {name}: {y.dtype} {tuple(y.shape)} {y.device}")
        err = float((y.float() - x.float()).abs().max())
        bound = 0.51 * man[name]["meta"]["scale"] + float(x.float().abs().max()) * 2.0**-8
        if not err <= bound:
            raise AssertionError(f"restored {name}: max |err| {err} > bound {bound}")
        errs[name] = (err, bound)
    return errs


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in sorted(after) if after[k] != before.get(k, 0)}


def require_launched(label: str, counts: dict, want, plain_calls: dict) -> None:
    """Every kernel in ``want`` launched on the path; no plain version ran
    on a CUDA tensor."""
    missing = sorted(k for k in want if not counts.get(k))
    if missing:
        raise AssertionError(f"{label}: kernels the plans name never launched: {missing}")
    if plain_calls:
        raise AssertionError(f"{label}: plain versions ran on CUDA tensors: {plain_calls}")


def checkpoint_path(rng, dev, card: str) -> dict:
    """Phase 10: save and restore a full-width stablelm-2-1.6b (4 layers,
    bfloat16) with every codec on the card, heal a damaged wz-rice leaf,
    refuse a damaged z leaf, resume a train loop, account a gradient sync;
    the counters and the plain-version guard cover exactly that path; each
    codec's payload bytes are then held against the plain versions' (the
    guard paused, the files still on disk)."""
    from repro_torch import kernels as K
    from repro_torch import tree as T
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.resilience.errors import CheckpointIntegrityError, DegradedRestoreWarning
    from repro_torch.train import grad_compress as G

    t0 = time.perf_counter()
    tree = stablelm_params(rng, dev)
    torch.cuda.synchronize(dev)
    n_params = sum(x.numel() for x in T.leaves(tree))
    made_s = time.perf_counter() - t0
    host32 = {}  # float32 host copies, for the numpy rule
    quant_cache = {}
    root = pathlib.Path(tempfile.mkdtemp(prefix="ckpt_smoke_", dir=ROOT / "build"))
    ckdir = root / "ckpt"
    per_codec, plans = {}, {}
    try:
        K.launches.reset()
        with PlainGuard(PlainGuard.TARGETS + PlainGuard.TARGETS_2D) as guard:
            for codec, scheme in CKPT_CODECS:
                key = f"{codec}/{scheme}"
                shutil.rmtree(ckdir, ignore_errors=True)
                mgr = CheckpointManager(ckdir, keep=1, codec=codec, wavelet_scheme=scheme,
                                        device=dev)
                rec = {}
                c0 = K.launches.snapshot()
                with StageTimer(dev) as save_t:
                    _, rec["save_ms"] = _timed(lambda: mgr.save(1, tree), dev)
                c1 = K.launches.snapshot()
                with StageTimer(dev) as rest_t:
                    (_, out), rec["restore_ms"] = _timed(lambda: mgr.restore(template=tree), dev)
                c2 = K.launches.snapshot()
                rec.update(leaves=len(T.leaves(tree)), params=n_params,
                           save_stages=save_t.with_rest(rec["save_ms"]), save_events=save_t.event_ms,
                           restore_stages=rest_t.with_rest(rec["restore_ms"]),
                           restore_events=rest_t.event_ms,
                           launches_save=_diff(c1, c0), launches_restore=_diff(c2, c1),
                           report=mgr.compression_report(1))
                man = json.loads((ckdir / "step_0000000001" / "manifest.json").read_text())["leaves"]
                if codec in ("raw", "z"):
                    got = dict(T.leaf_paths(out))
                    for name, x in T.leaf_paths(tree):
                        if not torch.equal(got[name], x):
                            raise AssertionError(f"{key} restore of {name} is not bit-exact")
                else:
                    errs = _restore_error(tree, out, man)
                    rec["worst"] = max(errs.items(), key=lambda kv: kv[1][0] / kv[1][1])
                    plans[key] = {}
                    for name, x in T.leaf_paths(tree):
                        route, lv, _ = wz_leaf_plan(codec, scheme, tuple(x.shape),
                                                    mgr.wavelet_levels)
                        if (lv, route) != (man[name]["meta"]["levels"],
                                           man[name]["meta"].get("enc", "1d")):
                            raise AssertionError(f"{key} {name}: plan {route}/{lv} != manifest")
                        plans[key][name] = (route, lv, leaf_plans(route, x.shape, lv, scheme, dev))
                if codec == "wz-rice":  # one band of one leaf damaged: healed, warned
                    f = ckdir / "step_0000000001" / man["head/w_out"]["file"]
                    data = f.read_bytes()
                    _damage_one_band(f)
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        _, healed = mgr.restore(template=tree)
                    if not any(issubclass(w.category, DegradedRestoreWarning) for w in caught):
                        raise AssertionError("damaged wz-rice leaf restored without a warning")
                    if not torch.equal(healed["head"]["w_out"], out["head"]["w_out"]):
                        raise AssertionError("healed wz-rice leaf != the undamaged decode")
                    rec["healed"] = "head/w_out"
                    f.write_bytes(data)
                    del healed
                    # the card's share of a save and a restore, by kernel
                    rec["device_ms_save"] = device_ms_by_kernel(lambda: mgr.save(1, tree))
                    rec["device_ms_restore"] = device_ms_by_kernel(
                        lambda: mgr.restore(1, template=tree))
                if codec == "z":  # the first leaf a restore reads, damaged: refused
                    first = next(iter(man))
                    f = ckdir / "step_0000000001" / man[first]["file"]
                    data = f.read_bytes()
                    f.write_bytes(data[:7] + bytes([data[7] ^ 0xFF]) + data[8:])
                    try:
                        mgr.restore(template=tree)
                    except CheckpointIntegrityError:
                        rec["refused"] = first
                    else:
                        raise AssertionError("damaged z leaf restored without an error")
                    f.write_bytes(data)
                c3 = K.launches.snapshot()
                with guard.paused():  # the plain versions, on purpose
                    if codec.startswith("wz"):
                        rec["plain_bytes_equal"] = _plain_bytes_check(
                            tree, out, man, ckdir, codec, scheme, mgr.wavelet_levels, host32,
                            quant_cache, dev)
                del out
                if K.launches.snapshot() != c3:
                    raise AssertionError(f"{key}: the plain comparison launched a kernel")
                per_codec[key] = rec
                print(f"  ckpt {key}: save {rec['save_ms']:.1f} ms, restore "
                      f"{rec['restore_ms']:.1f} ms; {rec['report']['stored_bytes']} of "
                      f"{rec['report']['raw_bytes']} bytes stored; launches save "
                      f"{rec['launches_save']}, restore {rec['launches_restore']} ({card})",
                      flush=True)
            with guard.paused():
                per_codec["division"] = division_finding(tree, host32, dev)
            # resume: a crash at step 13 of 20, saves every 5 (async, z),
            # resumed from step 10, equal to an uninterrupted run
            res, ms = _timed(lambda: resume_check(root / "resume", dev), dev)
            per_codec["resume"] = dict(res, ms=ms)
            # gradient accounting over the same tree, spatial codecs off and on
            acct = per_codec["grad_accounting"] = {}
            for label, cfg in (("spatial off", G.WaveletSyncConfig()),
                               ("spatial_2d + spatial_3d", G.WaveletSyncConfig(
                                   spatial_2d=True, spatial_3d=True))):
                (enc, ms) = _timed(lambda: G.pod_encoded_bytes(tree, cfg), dev)
                acct[label] = {"collective_bytes": G.pod_collective_bytes(tree, cfg),
                               "encoded_bytes": enc, "encoded_ms": ms,
                               "routes": dict(collections.Counter(
                                   G.leaf_route(x, cfg) for x in T.leaves(tree)))}
        counts = K.launches.snapshot()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = set()
    for key, leaves in plans.items():
        for name, (route, lv, pl) in leaves.items():
            for p in pl:
                want.update(f"{PLAN_KERNELS[(route, p)]}_{d}" for d in ("fwd", "inv"))
    want.update(("rice_encode", "rice_decode"))
    require_launched("checkpoint path", counts, want, guard.calls)
    return {"params": n_params, "made_s": made_s, "codecs": per_codec, "launches": counts,
            "plans": plans, "plain_calls_on_cuda": guard.calls}


def _plain_bytes_check(tree, out, man, ckdir, codec, scheme, levels, host32, cache,
                       dev) -> int:
    """Every leaf of a wavelet checkpoint: the quantized int32 on the card
    equals the host numpy rule (``torch.equal``), the file's payload
    (zlib'd int16 band pack, or the container) equals the plain versions'
    chain on the card (``==``), and the restored leaf ``out`` equals that
    int32 times the scale (float32, numpy's rule) cast to the leaf's
    dtype (``torch.equal``: the integer DWT is lossless, so a restore
    has one right answer).  Returns the leaves checked."""
    from repro_torch import tree as T
    from repro_torch.ckpt import checkpoint as CK

    restored = dict(T.leaf_paths(out))
    for name, x in T.leaf_paths(tree):
        route, lv, lim = wz_leaf_plan(codec, scheme, tuple(x.shape), levels)
        q, scale = CK._quantize_for_wz(x, lim)
        if (name, lim) not in cache:
            if name not in host32:
                host32[name] = x.float().cpu().numpy()
            cache[(name, lim)] = numpy_quantize(host32[name], lim)
        q_np, scale_np = cache[(name, lim)]
        if scale != scale_np or scale != man[name]["meta"]["scale"]:
            raise AssertionError(f"{codec}/{scheme} {name}: scale {scale} != {scale_np}")
        if not torch.equal(q, torch.from_numpy(q_np).to(dev)):
            raise AssertionError(f"{codec}/{scheme} {name}: quantized int32 != the numpy rule")
        stored = (ckdir / "step_0000000001" / man[name]["file"]).read_bytes()
        payload = stored if codec == "wz-rice" else zlib.decompress(stored)
        if payload != plain_chain(route, lv, q, scheme, codec):
            raise AssertionError(f"{codec}/{scheme} {name}: payload != the plain versions' chain")
        del q
        want = torch.from_numpy(q_np.astype(np.float32) * scale).to(x.dtype).to(dev)
        if not torch.equal(restored[name], want):
            raise AssertionError(f"{codec}/{scheme} {name}: restore != the dequantized numpy rule")
        del want
    return len(man)


def device_ms_by_kernel(fn) -> dict:
    """Device ms of every kernel ``fn`` runs, summed by name (one
    ``torch.profiler`` trace; PyTorch's own kernels under "torch ops")."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        name = ev.name.removeprefix("void ")
        if name.startswith(("Memcpy", "Memset")):
            key = name.split(" (")[0]
        elif "at::" in name or "cub::" in name:
            key = "torch ops"
        else:
            key = name.split("(")[0][:48]
        out[key] = out.get(key, 0.0) + ev.time_range.elapsed_us() / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# the quantization limits the checkpoint codecs use at 2 levels: wz3d's
# 3-D leaves, wz2d's matrices, wz's lines, wz-rice
DIVISION_LIMITS = (255.0, 1023.0, 4095.0, 32767.0)


def division_finding(tree, host32, dev) -> dict:
    """How a CUDA divide by a Python float rounds (PyTorch multiplies by
    the reciprocal) against the numpy rule the port keeps (a 0-dim CUDA
    tensor divisor): at each limit, the values of the embedding's
    quantization where either form differs from the rule."""
    from repro_torch.core.compression import divide_f32

    x = tree["embed"]["embedding"].float()
    if "embed/embedding" not in host32:
        host32["embed/embedding"] = x.cpu().numpy()
    out = {"values": x.numel()}
    for lim in DIVISION_LIMITS:
        q_np, scale = numpy_quantize(host32["embed/embedding"], lim)
        want = torch.from_numpy(q_np).to(dev)
        recip = torch.clamp(torch.round(x / scale), -lim, lim).to(torch.int32)
        exact = torch.clamp(torch.round(divide_f32(x, scale)), -lim, lim).to(torch.int32)
        out[int(lim)] = (int((recip != want).sum()), int((exact != want).sum()))
        del want, recip, exact
    return out


def resume_check(path: pathlib.Path, dev) -> dict:
    """``TrainLoopRunner`` on the card: crash at step 13 of 20 (saves every
    5 steps, async, codec z), resume from the latest step, end equal to an
    uninterrupted run."""
    from repro_torch.ckpt import CheckpointManager, TrainLoopRunner

    def step_fn(state, batch):
        return {"x": state["x"] + batch["v"], "w": state["w"] * 0.5 + batch["v"][0]}, {}

    def batch_fn(step):
        return {"v": torch.full((3,), float(step), device=dev)}

    state0 = {"x": torch.zeros(3, device=dev), "w": torch.ones(64, 64, device=dev)}
    ref = state0
    for s in range(20):
        ref, _ = step_fn(ref, batch_fn(s))
    runner = TrainLoopRunner(ckpt=CheckpointManager(path, keep=3, codec="z", device=dev),
                             save_every=5, async_save=True)
    try:
        runner.run(state0, step_fn, batch_fn, n_steps=20, fail_at=13)
    except RuntimeError as e:
        if "simulated node failure" not in str(e):
            raise
    else:
        raise AssertionError("the train loop did not fail at step 13")
    runner.ckpt.wait()
    runner2 = TrainLoopRunner(ckpt=CheckpointManager(path, keep=3, codec="z", device=dev),
                              save_every=5, async_save=True)
    state, start = runner2.resume_or_init(state0)
    final, end = runner2.run(state, step_fn, batch_fn, n_steps=20, start_step=start)
    if start != 10 or end != 20 or not all(torch.equal(final[k], ref[k]) for k in ref):
        raise AssertionError(f"resume from {start} to {end} differs from the uninterrupted run")
    return {"resumed_from": start, "ended_at": end}


def _fmt_stages(ms: dict, ev: dict) -> str:
    return ", ".join(f"{k} {v:.1f}" + (f" (events {ev[k]:.1f})" if k in DEVICE_STAGES else "")
                     for k, v in ms.items())


# the stages whose work runs on the card alone (their CUDA-event ms are
# printed too; a stage with host work reads the host's time on events)
DEVICE_STAGES = ("quantize", "transform", "dequantize")


def print_checkpoint(ck: dict, card: str, secs: float) -> None:
    codecs = ck["codecs"]
    print(f"checkpoint path: stablelm-2-1.6b at full width, {CKPT_LAYERS} of 24 layers, "
          f"{ck['params']} bfloat16 parameters (made in {ck['made_s']:.1f} s); every codec saved "
          f"and restored on the card: raw and z bit-exact, wz* within 0.51 x scale + one bfloat16 "
          f"rounding and equal to the numpy rule's int32 x scale, payload bytes equal to the plain "
          f"versions' chain; damaged wz-rice leaf "
          f"{codecs['wz-rice/cdf53']['healed']} healed with DegradedRestoreWarning; damaged z leaf "
          f"{codecs['z/cdf53']['refused']} refused; train loop resumed from step "
          f"{codecs['resume']['resumed_from']} to {codecs['resume']['ended_at']} equal to an "
          f"uninterrupted run ({secs:.1f} s)", flush=True)
    for codec, scheme in CKPT_CODECS:
        r = codecs[f"{codec}/{scheme}"]
        rep = r["report"]
        worst = (f"; worst leaf {r['worst'][0]} max |err| {r['worst'][1][0]:.3g} of bound "
                 f"{r['worst'][1][1]:.3g}" if "worst" in r else "")
        print(f"  {codec}/{scheme}: {r['leaves']} leaves, {r['params']} parameters, "
              f"{rep['raw_bytes']} raw bytes, {rep['stored_bytes']} stored (ratio "
              f"{rep['ratio']:.4f}){worst}")
        for what in ("save", "restore"):
            if f"device_ms_{what}" in r:
                print(f"    device ms of a {what} by kernel (profiler): " + ", ".join(
                    f"{k} {v:.3f}" for k, v in r[f"device_ms_{what}"].items()))
        print(f"    save {r['save_ms']:.1f} ms host: {_fmt_stages(r['save_stages'], r['save_events'])}"
              f"; launches {r['launches_save']}")
        print(f"    restore {r['restore_ms']:.1f} ms host: "
              f"{_fmt_stages(r['restore_stages'], r['restore_events'])}; launches "
              f"{r['launches_restore']} ({card})")
    for key, leaves in ck["plans"].items():
        groups = {}
        for name, (route, lv, pl) in leaves.items():
            groups.setdefault(f"{route} x {lv}: {pl}", []).append(name)
        print(f"  plans {key}: " + "; ".join(f"{g} <- {names}" for g, names in groups.items()))
    print(f"launches on the checkpoint path: {ck['launches']}; plain versions called on CUDA "
          f"tensors: {sum(ck['plain_calls_on_cuda'].values())}")
    dv = codecs["division"]
    print(f"quantization division on the card, embed/embedding ({dv['values']} values), "
          f"values unequal to the numpy rule with x / python_float (a reciprocal multiply) / "
          f"with the port's 0-dim tensor divisor: " + "; ".join(
              f"limit {lim} {dv[lim][0]} / {dv[lim][1]}" for lim in map(int, DIVISION_LIMITS)))
    for label, a in codecs["grad_accounting"].items():
        raw, comp = a["collective_bytes"]
        print(f"gradient sync accounting ({label}): routes {a['routes']}; fp32 {raw} bytes, "
              f"band payload {comp} (analytic), Rice-coded {a['encoded_bytes'][1]} (measured, "
              f"{a['encoded_ms']:.1f} ms host; {card})")


# ---------------------------------------------------------------------------
# Phase 11: the paper's evaluation (Table 2, Fig. 5, Table 3).
# ---------------------------------------------------------------------------

# the float filter bank replaces no Pallas kernel: it is the card's
# counterpart of the reference's jitted jnp baseline (Table 3)
FILTERBANK = ("src/repro_torch/csrc/filterbank.cu", "src/repro/core/lifting.py:763")
FILTERBANK_LENGTHS = (3, 4, 5, 64, 255, 256, 65536)
FILTERBANK_ROWS = (1, 7, 1024)


def filterbank_parity(rng, dev) -> dict:
    """Phase 11, parity: the float filter-bank kernel against its plain
    version with ``torch.equal``: n in ``FILTERBANK_LENGTHS``, rows in
    ``FILTERBANK_ROWS``, 8-bit values and int32 extremes (every third
    sample the minimum, the next the maximum, the rest random over the
    whole range), each also 4 bytes past a 16-byte boundary; then the
    wrapper on (2, 3, 257) inputs of every accepted dtype."""
    from repro_torch import kernels as K
    from repro_torch.core import lifting as L
    from repro_torch.kernels import filterbank as FB

    cases, err = 0, 0.0
    for n in FILTERBANK_LENGTHS:
        for rows in FILTERBANK_ROWS:
            for kind in ("8-bit", "int32 extremes"):
                if kind == "8-bit":
                    x = rng.integers(0, 256, (rows, n), dtype=np.int32)
                else:
                    x = rng.integers(I32.min, I32.max, (rows, n), dtype=np.int32, endpoint=True)
                    x[:, ::3], x[:, 1::3] = I32.min, I32.max
                xt = torch.from_numpy(x).to(dev)
                want = L.filterbank53_fwd_float(xt)
                for mis in (False, True):
                    label = f"filterbank53_float {rows}x{n} {kind}{' misaligned' if mis else ''}"
                    xin = _misaligned(xt) if mis else xt
                    err = max(err, _equal_or_raise(label, FB.filterbank53_fwd_float_cuda(xin),
                                                   want))
                    cases += 1
    for dt in (np.int8, np.int16, np.uint8, np.uint16, np.int32):
        info = np.iinfo(dt)
        xt = torch.from_numpy(rng.integers(info.min, info.max, (2, 3, 257), endpoint=True)
                              .astype(dt)).to(dev)
        _equal_or_raise(f"kernels.filterbank53_fwd_float {np.dtype(dt).name}",
                        K.filterbank53_fwd_float(xt), L.filterbank53_fwd_float(xt.to(torch.int32)))
        cases += 1
    torch.cuda.synchronize(dev)
    return {"cases": cases, "max_abs_err": err}


def paper_evaluation(rng, dev) -> dict:
    """Phase 11: the float kernel's parity sweep, then the port's paper
    benchmarks (``benchmarks/torch_*.py``) with the counters reset just
    before and read just after, under the plain-version guard (the 1-D
    and 2-D plain versions and the float filter bank's; Table 3's plain
    chain and library call are comparisons, the guard paused there).
    Fails unless every scheme traces 0 multipliers, the lifting pair 4 /
    2 / 0 and each scheme's row its ``pair_op_counts()``; every Fig. 5
    ``lossless*`` row is 1 and ``max_abs_error`` 0; the float kernel
    equals the plain chain at every Table 3 shape; and the lifting, row
    pass and float kernels launched."""
    from benchmarks import torch_fig5_lossless as F5
    from benchmarks import torch_table2_opcounts as T2
    from benchmarks import torch_table3_timing as T3
    from repro_torch import kernels as K
    from repro_torch.core import schemes as S

    t0 = time.perf_counter()
    parity = filterbank_parity(rng, dev)
    targets = PlainGuard.TARGETS + PlainGuard.TARGETS_2D + (
        ("repro_torch.core.lifting", ("filterbank53_fwd_float",)),)
    K.launches.reset()
    with PlainGuard(targets) as guard:
        t2 = T2.run(device=dev.type)
        f5 = F5.run(device=dev.type)
        t3 = T3.run(device=dev.type, compare=guard.paused)
    torch.cuda.synchronize(dev)
    launches = K.launches.snapshot()
    rows2, rows5, rows3 = ({k: v for k, v, _ in r} for r in (t2, f5, t3))
    want = {"table2.ls.adders": 4, "table2.ls.shifters": 2, "table2.ls.multipliers": 0}
    for name in S.available_schemes():
        for key, v in S.get_scheme(name).pair_op_counts().items():
            want[f"table2.scheme.{name}.{key}"] = v
    bad = {k: (rows2.get(k), v) for k, v in want.items() if rows2.get(k) != v}
    if bad:
        raise AssertionError(f"Table 2 rows (got, want): {bad}")
    bad = {k: v for k, v in rows5.items()
           if (k.startswith("fig5.lossless") and v != 1) or (k == "fig5.max_abs_error" and v)}
    if bad or "fig5.lossless_kernel_multilevel" not in rows5:
        raise AssertionError(f"Fig. 5 rows: {bad or rows5}")
    bad = {k: v for k, v in rows3.items() if k.endswith("float_kernel.max_abs_err") and v}
    if bad:
        raise AssertionError(f"the float kernel != the plain chain in Table 3: {bad}")
    require_launched("paper evaluation", launches, (
        "filterbank53_float", "lift1d_fwd", "lift1d_inv", "rows1d_fwd", "rows1d_inv"),
        guard.calls)
    return {"parity": parity, "table2": t2, "fig5": f5, "table3": t3, "launches": launches,
            "plain_calls_on_cuda": dict(guard.calls), "seconds": time.perf_counter() - t0}


def print_paper(pe: dict, card: str) -> None:
    from benchmarks import torch_table3_timing as T3

    print(f"paper evaluation: float filter-bank kernel == plain version on every case "
          f"{pe['parity']}; launches {pe['launches']}; plain versions called on CUDA tensors: "
          f"{sum(pe['plain_calls_on_cuda'].values())} ({pe['seconds']:.1f} s)", flush=True)
    print("Table 2 (make_fx traces, PE ledger): " + ", ".join(
        f"{k.removeprefix('table2.')}={v}" for k, v, _ in pe["table2"]))
    print("Fig. 5: " + ", ".join(f"{k.removeprefix('fig5.')}={v}" for k, v, _ in pe["fig5"]))
    rows3 = {k: (v, note) for k, v, note in pe["table3"]}
    for key in ("table3.int_lifting_us", "table3.float_filterbank_us", "table3.speedup",
                "table3.ordering_holds"):
        print(f"{key} = {rows3[key][0]} ({rows3[key][1]})")
    for shape, (r, n) in {"paper": T3.PAPER_SHAPE, **T3.SHAPES}.items():
        for impl in T3.IMPLS:
            m = {f: rows3[f"table3.{shape}.{impl}.{f}"][0]
                 for f in ("ms", "device_ms", "host_us", "bound_ms")}
            err = rows3.get(f"table3.{shape}.{impl}.max_abs_err", (0.0,))[0]
            print(f"  table3 {shape} {r} x {n} "
                  f"{impl}: {m['ms']:.4f} ms events, device {m['device_ms']:.4f} ms, host "
                  f"{m['host_us']:.1f} us a call, bound {m['bound_ms']:.6f} ms, max |err| vs "
                  f"plain {err:.3g} ({card})")
        print(f"  table3 {shape} float kernel / lifting, device: "
              f"{rows3[f'table3.{shape}.float_kernel_over_int_lifting'][0]}")



def filterbank_entry(pe: dict) -> dict:
    """The float kernel's entry of the ``kernels`` line, at (a) 64 x 65,536."""
    from benchmarks import torch_table3_timing as T3

    rows3 = {k: v for k, v, _ in pe["table3"]}
    source, replaces = FILTERBANK
    samples = T3.SHAPES["a"][0] * T3.SHAPES["a"][1]
    return {
        "name": "filterbank53_float", "route": "cuda", "source": source, "replaces": replaces,
        "launches": pe["launches"]["filterbank53_float"],
        "max_abs_err": pe["parity"]["max_abs_err"],
        "ms": rows3["table3.a.float_kernel.ms"], "plain_ms": rows3["table3.a.float_plain.ms"],
        "bound_ms": rows3["table3.a.float_kernel.bound_ms"],
        "bound_by": bound(T3.BYTES_PER_SAMPLE * samples, T3.FLOPS_PER_SAMPLE * samples,
                          ops_per_s=PEAK_FP32_FLOPS)[1],
        "library_ms": rows3["table3.a.float_conv1d.ms"],
    }


# ---------------------------------------------------------------------------
# Phase 12: the sharded transform and the cross-pod gradient ring.
# ---------------------------------------------------------------------------

# (b): the serve batch of phase 3's big bucket, rows over 4 ranks
SHARDED_SHAPE = (SLOTS,) + BUCKETS[-1]
SHARDED_RANKS = 4
SHARDED_SCHEMES = (("cdf53", "jpeg2000"), ("97m", "paper"), ("haar", "paper"))
WATCHDOG_DELAY_S = 2.0
# (c): phase 10's tree (stablelm-2-1.6b at full width, 4 layers) on 2 pods
POD_RANKS = 2
POD_LAYERS = CKPT_LAYERS


def _world(backend: str, rank: int, world: int, init: str, device_type: str,
           axis: str = "data"):
    """Join a ``torch.distributed`` world (``file://`` rendezvous: no
    network) and return its 1-D mesh; the card is cuda:0 for every rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat

    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return make_mesh_compat((world,), (axis,), device_type)


def _scratch(prefix: str) -> pathlib.Path:
    """A fresh directory under ``build/`` (the checkout's, gitignored)."""
    (ROOT / "build").mkdir(exist_ok=True)
    return pathlib.Path(tempfile.mkdtemp(prefix=prefix, dir=ROOT / "build"))


def _spawn(fn, world: int, args: tuple, outdir: pathlib.Path) -> list:
    """Run ``fn(rank, world, init, outdir, *args)`` on ``world`` spawned
    processes, wait for all of them, and return each rank's JSON record."""
    import torch.multiprocessing as mp

    init = f"file://{outdir / 'rendezvous'}"
    mp.spawn(fn, args=(world, init, str(outdir)) + args, nprocs=world, join=True)
    return [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(world)]


def _serve_run(images, dev, encode: bool, mesh) -> tuple:
    """One engine of phase 3's configuration serving ``images``: the
    served requests by uid, each batch's host ms, and the launches
    (counters reset just before the first step, read after the last)."""
    from repro_torch import kernels as K
    from repro_torch.serve import TransformRequest, WaveletServeEngine

    eng = WaveletServeEngine(buckets=BUCKETS, batch_slots=SLOTS, levels=LEVELS, scheme=SCHEME,
                             mode=MODE, device=str(dev), encode_response=encode, mesh=mesh)
    eng.warmup()
    for i, img in enumerate(images):
        eng.submit(TransformRequest(uid=i, image=img))
    K.launches.reset()
    lat, done = [], []
    while eng.scheduler.pending():
        t = time.perf_counter()
        done.extend(eng.step())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        lat.append((time.perf_counter() - t) * 1e3)
    return sorted(done, key=lambda r: r.uid), lat, K.launches.snapshot()


def mesh_serve(rng, dev, n_requests) -> dict:
    """Phase 12 (a): phase 3's serve configuration on a one-rank mesh
    (NCCL on the card), plain and with ``encode_response=True``, in turns
    with the mesh-less engine (mesh, mesh-less, mesh-less, mesh); every
    response and container must equal the mesh-less engine's."""
    import torch.distributed as dist

    from repro_torch.collectives import AxisComm

    tmp = _scratch("mesh_")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    mesh = _world(backend, 0, 1, f"file://{tmp / 'rendezvous'}", dev.type)
    out = {"route": AxisComm(mesh, "data").route(dev), "runs": {}}
    try:
        images = [r.image for r in make_requests(rng, n_requests)]
        for encode in (False, True):
            runs = [_serve_run(images, dev, encode, m) for m in (mesh, None, None, mesh)]
            for (a_done, _, counts), (b_done, _, _) in ((runs[0], runs[1]), (runs[3], runs[2])):
                if len(a_done) != n_requests or len(b_done) != n_requests:
                    raise AssertionError(f"mesh serve: {len(a_done)} / {len(b_done)} served")
                for a, b in zip(a_done, b_done):
                    if a.error is not None or not a.done:
                        raise AssertionError(f"mesh serve request {a.uid} failed: {a.error}")
                    _equal_or_raise(
                        f"mesh serve request {a.uid}",
                        [a.pyramid.ll] + [x for lvl in a.pyramid.details for x in lvl],
                        [b.pyramid.ll] + [x for lvl in b.pyramid.details for x in lvl])
                    if encode and (a.encoded != b.encoded or a.batch_index != b.batch_index):
                        raise AssertionError(f"mesh serve request {a.uid}: container differs")
                want = ("whole2d_fwd", "tiled2d_fwd") + (("rice_encode",) if encode else ())
                missing = [k for k in want if not counts.get(k)]
                if missing and dev.type == "cuda":  # (a CPU rehearsal runs plain versions)
                    raise AssertionError(f"mesh serve: {missing} never launched: {counts}")
            out["runs"]["encoded" if encode else "plain"] = {
                "requests": n_requests, "batches": len(runs[0][1]), "launches": runs[0][2],
                "mesh_batch_ms": runs[0][1] + runs[3][1],
                "plain_batch_ms": runs[1][1] + runs[2][1],
                "batch_ms_p50": statistics.median(runs[0][1] + runs[3][1]),
                "plain_batch_ms_p50": statistics.median(runs[1][1] + runs[2][1])}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _sharded_rank(rank, world, init, outdir, seed, shape, levels, device_type):
    """Phase 12 (b), one rank: the sharded pyramid of each scheme on this
    rank's rows, held against the single-device pyramid; one watchdog
    trip; host ms of one forward and one inverse."""
    import threading

    from repro_torch import kernels as K
    from repro_torch import obs
    from repro_torch.collectives import AxisComm
    from repro_torch.kernels import sharded as SHD
    from repro_torch.resilience import inject
    from repro_torch.resilience.errors import CollectiveTimeoutError

    mesh = _world("gloo", rank, world, init, device_type)
    dev = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    comm = AxisComm(mesh, "data")
    rows = slice(comm.index * shape[-2] // world, (comm.index + 1) * shape[-2] // world)
    x = torch.from_numpy(np.random.default_rng(seed).integers(-128, 128, shape, dtype=np.int32))
    rec = {"rank": rank, "route": comm.route(dev), "schemes": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results = {}
    for scheme, mode in SHARDED_SCHEMES:  # warm: plans, libraries, pinned pool
        SHD.dwt_inv_2d_sharded(SHD.dwt_fwd_2d_sharded(x, mesh, levels, mode, scheme=scheme),
                               mesh, mode, scheme=scheme)
    sync()
    obs.reset()
    K.launches.reset()
    x_rows = SHD._to_global(x[..., rows, :].to(dev), mesh, "data", comm)  # shards on the card
    sync()
    for scheme, mode in SHARDED_SCHEMES:
        t = time.perf_counter()
        pyr = SHD.dwt_fwd_2d_sharded(x, mesh, levels, mode, scheme=scheme, timeout_s=120.0)
        sync()
        fwd_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        back = SHD.dwt_inv_2d_sharded(pyr, mesh, mode, scheme=scheme, timeout_s=120.0)
        sync()
        inv_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        SHD.dwt_fwd_2d_sharded(x_rows, mesh, levels, mode, scheme=scheme, timeout_s=120.0)
        sync()
        dev_fwd_ms = (time.perf_counter() - t) * 1e3
        results[scheme] = (pyr, back)
        rec["schemes"][scheme] = {"mode": mode, "forward_host_ms": fwd_ms,
                                  "inverse_host_ms": inv_ms,
                                  "forward_from_card_shards_host_ms": dev_fwd_ms}
    rec["launches"] = K.launches.snapshot()
    metrics = obs.snapshot()["metrics"]
    rec["exchange_ms"] = metrics.get("collectives.exchange_ms")
    rec["wire_bytes"] = {k: v for k, v in metrics.items() if k.startswith("collectives.wire")}
    xd = x.to(dev)
    for scheme, mode in SHARDED_SCHEMES:  # comparisons, after the counts were read
        pyr, back = results[scheme]
        want = K.dwt_fwd_2d_multi(xd, levels=levels, mode=mode, scheme=scheme)
        got_leaves = [pyr.ll] + [b for lvl in pyr.details for b in lvl]
        want_leaves = [want.ll] + [b for lvl in want.details for b in lvl]
        for g, w in zip(got_leaves, want_leaves):
            n = w.shape[-2] // world
            if not torch.equal(g.to_local(), w[..., comm.index * n:(comm.index + 1) * n, :]):
                raise AssertionError(f"rank {rank} {scheme}: sharded band != dwt_fwd_2d_multi")
        if not torch.equal(back.to_local(), xd[..., rows, :]):
            raise AssertionError(f"rank {rank} {scheme}: sharded round trip is not exact")
    # a stuck neighbour, simulated: every rank waits WATCHDOG_DELAY_S in the timed region
    try:
        with inject.armed("sharded.collective", action="delay", delay_s=WATCHDOG_DELAY_S):
            SHD.dwt_fwd_2d_sharded(x, mesh, levels, "paper", scheme="cdf53", timeout_s=0.2)
        raise AssertionError("the watchdog did not trip")
    except CollectiveTimeoutError as e:
        rec["watchdog"] = str(e)
    for t in threading.enumerate():
        if t.name.startswith(SHD.WATCHDOG_THREAD):
            t.join(120.0)
    rec["watchdog_trips"] = obs.snapshot()["metrics"].get("collectives.watchdog_trips")
    import torch.distributed as dist

    dist.barrier()
    (pathlib.Path(outdir) / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def pod_tree(rank: int, seed: int, dev, layers: int) -> dict:
    """float32 gradients shaped like phase 10's tree, normal(0, 1e-3) from
    a per-rank seed, made on ``dev``."""
    from repro_torch import tree as T

    gen = torch.Generator(device=dev).manual_seed(1000 * seed + rank)
    return T.map_leaves(lambda s: torch.randn(s.shape, generator=gen, device=dev).mul_(1e-3),
                        stablelm_defs(layers))


def _ring_bytes() -> int:
    from repro_torch import obs

    return int(sum(v for k, v in obs.snapshot()["metrics"].items()
                   if k.startswith("collectives.wire_bytes") and 'op="ring"' in k))


def ring_payload(tree: dict, cfg) -> int:
    """The ring's bytes a hop for ``tree``'s leaves: ``pod_collective_bytes``'
    analytic payload of each banded leaf less its 8 bytes a slice for the
    scale and shifts, which travel by all_reduce, not by the ring."""
    import math

    from repro_torch.train import grad_compress as G

    total = 0
    for v in tree.values():
        route = G.leaf_route(v, cfg)
        if route in ("raw", "lowband"):
            continue
        slices = 1 if route == "1d" else v.numel() // math.prod(
            v.shape[-3:] if route == "3d" else v.shape[-2:])
        total += G.pod_collective_bytes({"x": v}, cfg)[1] - 8 * slices
    return total


def _pod_rank(rank, world, init, outdir, seed, layers, device_type):
    """Phase 12 (c), one rank: ``pod_sync_tree`` over 2 pods on the
    gradients of phase 10's tree, every route; ring bytes against the
    analytic figure; one leaf of each route against the same sync on the
    CPU."""
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch import obs
    from repro_torch import tree as T
    from repro_torch.collectives import AxisComm
    from repro_torch.train import grad_compress as G

    mesh = _world("gloo", rank, world, init, device_type, axis="pod")
    dev = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    grads = dict(T.leaf_paths(pod_tree(rank, seed, dev, layers)))
    spatial = G.WaveletSyncConfig(n_pods=world, spatial_2d=True, spatial_3d=True)
    flat = G.WaveletSyncConfig(n_pods=world)
    # every route: the spatial codecs give 3d / 2d / raw on this tree; the
    # 1-D route takes the ln1 stacks and one attention stack with them off
    groups = collections.defaultdict(dict)
    for name, g in grads.items():
        groups[G.leaf_route(g, spatial)][name] = g
    groups["1d"] = {k: grads[k] for k in ("layers/ln1/scale", "layers/ln1/bias",
                                          "layers/attn/wq")}
    rec = {"rank": rank, "route": AxisComm(mesh, "pod").route(dev), "routes": {}}
    synced = {}
    K.launches.reset()
    for route in ("3d", "2d", "1d", "raw"):
        cfg = flat if route == "1d" else spatial
        sub = groups[route]
        err = G.init_error_feedback(sub)
        obs.reset()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        s, e = G.pod_sync_tree(sub, err, cfg, axis_name="pod", mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t) * 1e3
        want = ring_payload({k: v for k, v in sub.items() if G.leaf_route(v, cfg) == route}, cfg)
        got = _ring_bytes()
        if got != want:
            raise AssertionError(f"rank {rank} route {route}: ring shipped {got} bytes, "
                                 f"analytic payload {want}")
        rec["routes"][route] = {"leaves": len(sub), "elements": sum(v.numel() for v in sub.values()),
                                "ms": ms, "ring_bytes_per_hop": got,
                                "analytic_bytes": G.pod_collective_bytes(sub, cfg)}
        synced[route] = (s, e)
    rec["launches"] = K.launches.snapshot()
    other = dict(T.leaf_paths(pod_tree(1 - rank, seed, dev, layers))) if world == 2 else None
    # one leaf of each route (its smallest) through the same sync on the CPU
    for route in ("3d", "2d", "1d", "raw"):
        cfg = flat if route == "1d" else spatial
        name = min(groups[route], key=lambda k: groups[route][k].numel())
        g = groups[route][name]
        s_cpu, e_cpu = G.pod_sync_tree({name: g.cpu()}, {name: torch.zeros(g.shape)}, cfg,
                                       axis_name="pod", mesh=mesh)
        s_dev, e_dev = synced[route][0][name], synced[route][1][name]
        if not (torch.equal(s_cpu[name], s_dev.cpu()) and torch.equal(e_cpu[name], e_dev.cpu())):
            raise AssertionError(f"rank {rank} route {route} leaf {name}: card != CPU sync")
        if other is not None:
            mean = (g + other[name]) / 2
            rel = float((s_dev - mean).norm() / mean.norm())
            # white-noise gradients are the codec's worst case (~4% on the
            # CPU rehearsal); a pod's payload lost on the wire is ~70%
            if rel > 0.25:
                raise AssertionError(f"route {route} leaf {name}: {rel} from the pod mean")
            rec["routes"][route].update(checked_leaf=name, rel_error_vs_mean=rel)
    dist.barrier()
    (pathlib.Path(outdir) / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def sharded_paths(rng, dev, n_requests) -> dict:
    """Phase 12: (a) the serve route on a one-rank NCCL mesh; (b) 4 gloo
    ranks on the card running the sharded pyramid; (c) 2 gloo ranks
    running the cross-pod gradient ring on phase 10's tree."""
    out = {}
    t = time.perf_counter()
    out["serve"] = mesh_serve(rng, dev, n_requests)
    out["serve"]["s"] = time.perf_counter() - t
    seed = int(rng.integers(1 << 30))
    for key, fn, world, args in (
            ("transform", _sharded_rank, SHARDED_RANKS, (seed, SHARDED_SHAPE, LEVELS, dev.type)),
            ("pod_sync", _pod_rank, POD_RANKS, (seed, POD_LAYERS, dev.type))):
        tmp = _scratch(f"{key}_")
        t = time.perf_counter()
        try:
            out[key] = {"ranks": _spawn(fn, world, args, tmp)}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out[key]["s"] = time.perf_counter() - t
    return out


def print_sharded(sp: dict, card: str) -> None:
    sv = sp["serve"]
    for key, run in sv["runs"].items():
        print(f"mesh serve ({key}, one-rank mesh, transport {sv['route']}): {run['requests']} "
              f"requests in {run['batches']} batches, twice, equal to the mesh-less engine's "
              f"(pyramids{' and WZRC bytes' if key == 'encoded' else ''}); batch p50 "
              f"{run['batch_ms_p50']:.2f} ms (mesh-less {run['plain_batch_ms_p50']:.2f} ms; "
              f"in turns mesh, mesh-less, mesh-less, mesh: "
              + ", ".join(f"{v:.2f}" for v in run["mesh_batch_ms"]) + " / "
              + ", ".join(f"{v:.2f}" for v in run["plain_batch_ms"])
              + f"); launches {run['launches']} ({card})")
    tr = sp["transform"]
    for r in tr["ranks"]:
        print(f"sharded {SHARDED_SHAPE} x {LEVELS} levels, rank {r['rank']} of {SHARDED_RANKS} "
              f"(gloo on one card, transport {r['route']}): " + "; ".join(
                  f"{k} forward {v['forward_host_ms']:.2f} ms (from shards on the card "
                  f"{v['forward_from_card_shards_host_ms']:.2f}), inverse "
                  f"{v['inverse_host_ms']:.2f} ms" for k, v in r["schemes"].items())
              + f"; exchange_ms {r['exchange_ms']}; launches {r['launches']}; "
              f"wire {r['wire_bytes']}; watchdog trips {r['watchdog_trips']} ({card})")
    print(f"sharded: every band equal to dwt_fwd_2d_multi on the card and every round trip "
          f"exact on all {SHARDED_RANKS} ranks ({tr['s']:.1f} s); watchdog: "
          f"{tr['ranks'][0]['watchdog']}")
    ps = sp["pod_sync"]
    for r in ps["ranks"]:
        print(f"pod sync rank {r['rank']} of {POD_RANKS} (stablelm-2-1.6b, {POD_LAYERS} layers, "
              f"transport {r['route']}): " + "; ".join(
                  f"{k} {v['leaves']} leaves {v['elements']} values {v['ms']:.1f} ms, ring "
                  f"{v['ring_bytes_per_hop']} bytes a hop (analytic {v['analytic_bytes']}), "
                  f"{v.get('checked_leaf')} == CPU sync, {v.get('rel_error_vs_mean', 0):.2e} "
                  f"from the mean" for k, v in r["routes"].items())
              + f"; launches {r['launches']} ({card})")
    print(f"pod sync: {ps['s']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 13: LM serving.
# ---------------------------------------------------------------------------

# (a) stablelm-2-1.6b (repro_torch.configs) at full width and full depth,
# bfloat16, init_params from --seed on the card
LM_ARCH = "stablelm-1.6b"
LM_SLOTS, LM_PREFILL, LM_MAX_NEW, LM_REQUESTS = 4, 128, 8, 8
LM_PROMPT_LENS = (16, 128)  # each request's prompt length, drawn in [16, 128]
# decode after a prefill of LM_CHECK_LEN tokens against a prefill of one
# more (the reference's test_decode_matches_forward_dense, at full width),
# 2 sequences; bound: the logits' relative Frobenius distance.  The two
# paths run bfloat16 GEMMs of other shapes (2 rows against 256), whose
# sums may round differently, and 24 layers carry it: a bfloat16 model
# of this depth with every GEMM's rounding changed moves its logits by
# ~7e-2 (a d_model 512 stand-in on the CPU), a wrong position or cache
# entry by ~1
LM_CHECK_LEN, LM_CHECK_BATCH = 127, 2
LM_DECODE_BOUND = 1e-1
# (b) one config per family at full width, depth cut (n_layers): dense
# 24 -> 2, moe 32 -> 1 (16 experts of 3 x 4096 x 6400 are 5 GB a layer in
# float32, on the card and again on the host), ssm 32 -> 2, hybrid 26 -> 4
# (one (rec, rec, attn) super layer and one trailing rec layer), audio
# 48 -> 2 (``embeds`` input).  float32 on the card against the same port
# functions on the CPU from the same parameters (TF32 off, torch's
# default): forward on one (1, 32) prompt, prefill, 2 decode steps.
LM_FAMILIES = (("stablelm-1.6b", 2), ("phi3.5-moe-42b-a6.6b", 1), ("rwkv6-7b", 2),
               ("recurrentgemma-2b", 4), ("musicgen-medium", 2))
LM_FAMILY_LEN, LM_FAMILY_DECODES = 32, 2
# bound: max |card - CPU| <= bound x max(1, max |CPU|) on each logits
# tensor; the hybrid's RG-LRU cancels in sqrt(1 - a^2), so a one-ulp
# difference in exp moves it by ~1e-4 relative (tests/test_torch_models.py)
LM_FAMILY_BOUND = {"hybrid": 3e-2}
LM_FAMILY_BOUND_DEFAULT = 2e-3
# (c) the data pipeline's band split on the card
BAND_SPLIT = {"shape": (8, 65536), "levels": 2, "scheme": "cdf53", "mode": "paper"}


def _lm_inputs(cfg, rng, batch: int, length: int) -> dict:
    """Host tokens (in the vocabulary) or, for the ``embeds`` archs,
    normal(0, 1) frame embeddings."""
    if cfg.input_mode == "tokens":
        return {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, length), dtype=np.int32))}
    return {"embeds": torch.from_numpy(
        rng.standard_normal((batch, length, cfg.d_model), dtype=np.float32))}


def lm_full_depth(rng, dev, seed: int) -> dict:
    """Phase 13 (a): the ServeEngine on stablelm-2-1.6b at full size."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as TF
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(LM_ARCH)
    torch.zeros(1, device=dev)  # the allocator must exist before its stats are reset
    torch.cuda.reset_peak_memory_stats(dev)
    params, init_ms = _timed(
        lambda: ML.init_params(TF.model_defs(cfg), seed, torch.bfloat16, device=dev), dev)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n, dtype=np.int32),
                    max_new=LM_MAX_NEW) for i, n in enumerate(lens)]
    # warm-up (cuBLAS handles and workspaces), then the measured run
    ServeEngine(cfg, params, LM_SLOTS, LM_PREFILL, device=dev).run(
        [Request(uid=-1, prompt=reqs[0].prompt, max_new=2)])
    eng = ServeEngine(cfg, params, LM_SLOTS, LM_PREFILL, device=dev)
    done, run_ms = _timed(lambda: eng.run(reqs), dev)
    if sorted(r.uid for r in done) != list(range(LM_REQUESTS)):
        raise AssertionError(f"served {sorted(r.uid for r in done)} of {LM_REQUESTS} requests")
    for r in done:
        if not r.done or len(r.out_tokens) != LM_MAX_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"request {r.uid}: {r.out_tokens} (max_new {LM_MAX_NEW}, "
                                 f"vocabulary {cfg.vocab_size})")
    tokens = sum(len(r.out_tokens) for r in done)

    one = {"tokens": _lm_inputs(cfg, rng, 1, LM_PREFILL)["tokens"].to(dev)}
    prefill_ms = _median_ms(lambda: TF.prefill(params, cfg, **one), 5)
    caches = TF.init_caches(cfg, LM_SLOTS, LM_PREFILL, device=dev)
    caches["len"] = torch.tensor(LM_PREFILL, dtype=torch.int32, device=dev)
    step_in = torch.ones((LM_SLOTS, 1), dtype=torch.int32, device=dev)
    decode_ms = _median_ms(lambda: TF.decode_step(params, cfg, caches, tokens=step_in), 10)
    # the card's busy time a call (every kernel the profiler records)
    prefill_dev = _device_ms(lambda: TF.prefill(params, cfg, **one), None, every_kernel=True)
    decode_dev = _device_ms(lambda: TF.decode_step(params, cfg, caches, tokens=step_in), None,
                            every_kernel=True)

    toks = _lm_inputs(cfg, rng, LM_CHECK_BATCH, LM_CHECK_LEN + 1)["tokens"].to(dev)
    _, pre = TF.prefill(params, cfg, tokens=toks[:, :LM_CHECK_LEN])
    dec, _ = TF.decode_step(params, cfg, pre, tokens=toks[:, LM_CHECK_LEN:])
    full, _ = TF.prefill(params, cfg, tokens=toks)
    dec, full = dec[:, 0].float(), full[:, 0].float()
    dist = ((dec - full).norm() / full.norm()).item()
    if not torch.isfinite(dec).all() or dist > LM_DECODE_BOUND:
        raise AssertionError(f"decode after a prefill of {LM_CHECK_LEN} tokens is {dist:.3e} "
                             f"from a prefill of {LM_CHECK_LEN + 1} (bound {LM_DECODE_BOUND})")
    out = {"arch": LM_ARCH, "layers": cfg.n_layers, "params": sum(
        t.numel() for t in T.leaves(params)), "init_ms": init_ms,
        "requests": len(done), "prompt_lens": [int(n) for n in lens], "tokens": tokens,
        "run_ms": run_ms, "tokens_per_s": tokens / (run_ms / 1e3),
        "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
        "prefill_device_ms": prefill_dev, "decode_step_device_ms": decode_dev,
        "decode_tokens_per_s": LM_SLOTS / (decode_ms / 1e3),
        "decode_vs_prefill": {"rel_frobenius": dist, "bound": LM_DECODE_BOUND,
                              "max_abs": (dec - full).abs().max().item(),
                              "scale": full.abs().max().item(),
                              "top1_agree": (dec.argmax(-1) == full.argmax(-1)).float().mean().item()},
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    del params, eng, caches, pre
    torch.cuda.empty_cache()
    return out


def lm_families(rng, dev, seed: int) -> dict:
    """Phase 13 (b): one config per family at full width, the card against
    the CPU in float32 from the same parameters."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as TF

    cpu = torch.device("cpu")
    out = {}
    for arch, layers in LM_FAMILIES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers, param_dtype="float32",
                                  compute_dtype="float32")
        on_card = ML.init_params(TF.model_defs(cfg), seed, torch.float32, device=dev)
        on_cpu = T.map_leaves(lambda t: t.cpu(), on_card)
        prompt = _lm_inputs(cfg, rng, 1, LM_FAMILY_LEN)
        steps = [_lm_inputs(cfg, rng, 1, 1) for _ in range(LM_FAMILY_DECODES)]
        logits, ms = {}, {}
        for where, params, d in (("card", on_card, dev), ("cpu", on_cpu, cpu)):
            def run():
                def to(kw):
                    return {k: v.to(d) for k, v in kw.items()}
                got = [TF.forward(params, cfg, **to(prompt))[0]]
                lg, caches = TF.prefill(params, cfg, **to(prompt))
                got.append(lg)
                for x in steps:
                    lg, caches = TF.decode_step(params, cfg, caches, **to(x))
                    got.append(lg)
                return [g.float().cpu() for g in got]
            t = time.perf_counter()
            logits[where] = run()
            ms[where] = (time.perf_counter() - t) * 1e3
        bound = LM_FAMILY_BOUND.get(cfg.family, LM_FAMILY_BOUND_DEFAULT)
        errs = {}
        names = ["forward", "prefill"] + [f"decode {i + 1}" for i in range(LM_FAMILY_DECODES)]
        for name, a, b in zip(names, logits["card"], logits["cpu"]):
            scale = max(1.0, b.abs().max().item())
            errs[name] = (a - b).abs().max().item() / scale
            if a.shape != b.shape or not torch.isfinite(a).all() or errs[name] > bound:
                raise AssertionError(f"{arch} ({layers} layers) {name}: card against CPU "
                                     f"{errs[name]:.3e} x scale {scale:.3g} (bound {bound})")
        out[arch] = {"family": cfg.family, "layers": layers, "params": sum(
            t.numel() for t in T.leaves(on_card)), "rel_max_err": errs, "bound": bound,
            "card_ms": ms["card"], "cpu_ms": ms["cpu"], "s": time.perf_counter() - t0}
        del on_card, on_cpu
        torch.cuda.empty_cache()
    return out


def lm_band_split(rng, dev) -> dict:
    """Phase 13 (c): ``data.pipeline.WaveletBandSplit`` on the card, under
    the plain-version guard; then its bands against the plain version run
    on the card."""
    from repro_torch import kernels as K
    from repro_torch.core import lifting as CL
    from repro_torch.data.pipeline import WaveletBandSplit

    bs = BAND_SPLIT
    x = rng.integers(*PCM16, bs["shape"], dtype=np.int32)
    stage = WaveletBandSplit(levels=bs["levels"], mode=bs["mode"], scheme=bs["scheme"],
                             device=dev)
    before = K.launches.snapshot()
    with PlainGuard(PlainGuard.TARGETS + PlainGuard.TARGETS_2D) as guard:
        bands, ms = _timed(lambda: stage(x), dev)
    launched = {k: v - before.get(k, 0) for k, v in K.launches.snapshot().items()
                if v - before.get(k, 0)}
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors in the band split: {guard.calls}")
    if launched != {"lift1d_fwd": 1}:
        raise AssertionError(f"the band split launched {launched}, want one lift1d_fwd run")
    want = CL.dwt_fwd(torch.from_numpy(x).to(dev), levels=bs["levels"], mode=bs["mode"],
                      scheme=bs["scheme"])
    pairs = [("approx", want.approx)] + [(f"detail_{i}", d) for i, d in enumerate(want.details)]
    if sorted(bands) != sorted(k for k, _ in pairs):
        raise AssertionError(f"band split keys {sorted(bands)}")
    for k, w in pairs:
        if not np.array_equal(bands[k], w.cpu().numpy()):
            raise AssertionError(f"band split {k} != the plain version's")
    return {"ms": ms, "launches": launched, "bands": {k: list(v.shape) for k, v in bands.items()},
            **bs}


def lm_serving(rng, dev, seed: int) -> dict:
    """Phase 13: the counters reset just before and read just after."""
    from repro_torch import kernels as K

    t = time.perf_counter()
    K.launches.reset()
    out = {"full_depth": lm_full_depth(rng, dev, seed), "families": lm_families(rng, dev, seed),
           "band_split": lm_band_split(rng, dev)}
    out["launches"] = K.launches.snapshot()
    if out["launches"].get("lift1d_fwd", 0) <= 0:
        raise AssertionError(f"lift1d never launched on the LM path: {out['launches']}")
    out["s"] = time.perf_counter() - t
    return out


def print_lm(lm: dict, card: str) -> None:
    a = lm["full_depth"]
    cmp = a["decode_vs_prefill"]
    print(f"LM serving: {a['arch']} at full width and depth ({a['layers']} layers, "
          f"{a['params']} parameters, bfloat16), {LM_SLOTS} slots, prefill_len {LM_PREFILL}: "
          f"{a['requests']} requests (prompts {a['prompt_lens']}), {a['tokens']} tokens in "
          f"{a['run_ms']:.1f} ms, {a['tokens_per_s']:.1f} tokens/s end to end; prefill "
          f"(1 x {LM_PREFILL}) {a['prefill_ms']:.3f} ms, decode step ({LM_SLOTS} slots) "
          f"{a['decode_step_ms']:.3f} ms ({a['decode_tokens_per_s']:.1f} tokens/s), CUDA "
          f"events; the card busy {_fmt_ms(a['prefill_device_ms'])} / "
          f"{_fmt_ms(a['decode_step_device_ms'])} ms of them (profiler); "
          f"max_memory_allocated {a['max_memory_allocated']} bytes ({card})")
    print(f"  decode after a prefill of {LM_CHECK_LEN} against a prefill of {LM_CHECK_LEN + 1}: "
          f"relative Frobenius {cmp['rel_frobenius']:.3e} (bound {cmp['bound']}), max |diff| "
          f"{cmp['max_abs']:.4f} at scale {cmp['scale']:.3f}, top-1 agreement "
          f"{cmp['top1_agree']:.2f}")
    for arch, f in lm["families"].items():
        print(f"  {arch} ({f['family']}, full width, {f['layers']} layers, {f['params']} "
              f"parameters, float32): card against CPU, max |diff| / scale "
              + ", ".join(f"{k} {v:.2e}" for k, v in f["rel_max_err"].items())
              + f" (bound {f['bound']}); card {f['card_ms']:.1f} ms, CPU {f['cpu_ms']:.1f} ms")
    b = lm["band_split"]
    print(f"  WaveletBandSplit {b['scheme']}/{b['mode']} {b['levels']} levels on "
          f"{tuple(b['shape'])}: bands {b['bands']} equal to the plain version's, "
          f"{b['ms']:.3f} ms, launches {b['launches']}, no plain version on a CUDA tensor")
    print(f"launches on the LM path: {lm['launches']}; phase 13 {lm['s']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: training.
# ---------------------------------------------------------------------------

# (a) stablelm-2-1.6b (repro_torch.configs) uncut, bfloat16, remat=True
# (the config's), init_train_state from --seed on the card; one repeated
# SyntheticLM batch
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 6
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=6)
# (b) full width, depth cut to 2, under deterministic algorithms
DET_LAYERS, DET_STEPS = 2, 2
# (c) phase 10's tree (full width, 4 layers) on 2 gloo pods sharing the
# card: 3 steps with the 1-D codec, then 1 with the 2-D and 3-D codecs
POD_TRAIN = dict(levels=2, codec="bands", n_pods=POD_RANKS, min_size=256)
POD_TRAIN_STEPS = 3
POD_LOSS_BOUND = 0.05  # relative to the plain step's loss (tests/test_distributed.py)
# (d) phase 13 (b)'s families, float32; the gradients' bound relative to
# each leaf's largest magnitude (the hybrid's RG-LRU: LM_FAMILY_BOUND)
TRAIN_FAMILY_BOUND = {"hybrid": 3e-2}
TRAIN_FAMILY_BOUND_DEFAULT = 2e-3


def _train_batches(cfg, seed: int, n: int, dev) -> list:
    """``n`` SyntheticLM batches of TRAIN_BATCH x TRAIN_SEQ on ``dev``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import batch_to_device

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=seed))
    return [batch_to_device(cfg, data.batch(s), dev) for s in range(n)]


def _event_ms(fn, dev):
    """``fn()`` and its CUDA-event ms."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def train_full_depth(dev, seed: int) -> dict:
    """Phase 14 (a): the plain step on stablelm-2-1.6b at full size."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_train_state
    from repro_torch.train import optim
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(TRAIN_ARCH)
    if not cfg.remat:
        raise AssertionError(f"{TRAIN_ARCH}'s config has remat off")
    state, init_ms = _timed(lambda: init_train_state(cfg, seed, dev), dev)
    (batch,) = _train_batches(cfg, seed, 1, dev)
    step = make_train_step(cfg, optim.AdamWConfig(**TRAIN_OPT))
    p, o = state.pop("params"), state.pop("opt")  # one live state: each step makes the next
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(TRAIN_STEPS):
        (p, o, m), ms = _event_ms(lambda: step(p, o, batch), dev)
        losses.append(float(m["loss"]))
        step_ms.append(ms)
    peak_training = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{TRAIN_ARCH} at full size: losses {losses} (want finite, falling)")
    busy = _pass_ms(lambda: step(p, o, batch), reps=2, warm=1, every_kernel=True)
    busy_ms = sum(busy.values()) if all(isinstance(v, float) for v in busy.values()) else None
    memory = {}
    for remat in (True, False):
        one = make_train_step(dataclasses.replace(cfg, remat=remat),
                              optim.AdamWConfig(**TRAIN_OPT))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        ms = _event_ms(lambda: one(p, o, batch), dev)[1]  # the step's results dropped here
        torch.cuda.synchronize(dev)
        memory["remat" if remat else "no_remat"] = {
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "state_bytes": before, "step_ms": ms}
    steady = statistics.median(step_ms[1:])
    out = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "params": sum(
        t.numel() for t in T.leaves(p)), "init_ms": init_ms, "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "losses": losses, "step_ms": step_ms, "step_ms_p50": steady,
        "busy_ms": busy_ms, "busy_by_kernel_top": dict(sorted(
            ((k, v) for k, v in busy.items() if isinstance(v, float)),
            key=lambda kv: -kv[1])[:8]),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (steady / 1e3),
        "max_memory_allocated_6_steps": peak_training, "memory": memory}
    del p, o, m
    torch.cuda.empty_cache()
    return out


def train_determinism(dev, seed: int) -> dict:
    """Phase 14 (b): two runs of DET_STEPS steps from the same seed, and a
    remat step against a no-remat step, under deterministic algorithms."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_train_state
    from repro_torch.train import optim
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=DET_LAYERS)
    batches = _train_batches(cfg, seed, DET_STEPS, dev)
    opt_cfg = optim.AdamWConfig(**TRAIN_OPT)

    def run(c, steps):
        state = init_train_state(c, seed, dev)
        p, o = state["params"], state["opt"]
        step = make_train_step(c, opt_cfg)
        for b in batches[:steps]:
            p, o, _ = step(p, o, b)
        return T.leaves(p) + T.leaves(o.m) + T.leaves(o.v)

    def unequal(a, b):
        return [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            twice = unequal(run(cfg, DET_STEPS), run(cfg, DET_STEPS))
            remat = unequal(run(dataclasses.replace(cfg, remat=True), 1),
                            run(dataclasses.replace(cfg, remat=False), 1))
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have")[0][:120] for w in caught
                  if "deterministic" in str(w.message)})
    if twice:
        raise AssertionError(f"two runs from seed {seed} differ at {len(twice)} leaves "
                             f"(ops without a deterministic version: {ops})")
    if remat and not ops:
        raise AssertionError(f"a remat step differs from a no-remat step at {len(remat)} "
                             "leaves, and every op was deterministic")
    torch.cuda.empty_cache()
    return {"layers": DET_LAYERS, "steps": DET_STEPS, "runs_equal": True,
            "remat_equal": not remat, "remat_unequal_leaves": len(remat),
            "nondeterministic_ops": ops}


def _train_pod_rank(rank, world, init, outdir, seed, layers, device_type):
    """Phase 14 (c), one rank: the wavelet-synced step on phase 10's tree;
    replicas against the other rank's, ring bytes against the analytic
    payload, the smallest leaf of each route against the same sync on
    the CPU, launches under the plain-version guard."""
    from repro_torch import kernels as K
    from repro_torch import obs
    from repro_torch import tree as T
    from repro_torch.collectives import AxisComm
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_train_state
    from repro_torch.train import grad_compress as G
    from repro_torch.train import optim
    from repro_torch.train import train_step as S

    mesh = _world("gloo", rank, world, init, device_type, axis="pod")
    dev = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    comm = AxisComm(mesh, "pod")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=layers)
    state = init_train_state(cfg, seed, dev)  # the same seed on every rank
    batches = _train_batches(cfg, seed, POD_TRAIN_STEPS + 1, dev)
    opt_cfg = optim.AdamWConfig(**TRAIN_OPT)
    cases = [("1d", G.WaveletSyncConfig(**POD_TRAIN))] * POD_TRAIN_STEPS + [
        ("spatial", G.WaveletSyncConfig(**POD_TRAIN, spatial_2d=True, spatial_3d=True))]
    p, o = S.podded(state["params"], 1), S.podded_opt(state["opt"], 1)
    err = S.init_podded_error_feedback(state["params"], 1)
    del state
    rec = {"rank": rank, "route": comm.route(dev), "steps": [], "launches": {}}
    orig = G.pod_sync_tree
    sync = {}

    def timed_sync(grads, err_fb, cfg_s, axis_name="pod", mesh=None):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = orig(grads, err_fb, cfg_s, axis_name, mesh=mesh)
        torch.cuda.synchronize(dev)
        sync["ms"] = (time.perf_counter() - t) * 1e3
        sync["ring_bytes"] = _ring_bytes()
        sync["payload"] = ring_payload(dict(T.leaf_paths(grads)), cfg_s)
        sync["routes"] = sorted({G.leaf_route(g, cfg_s) for g in T.leaves(grads)})
        if sync.pop("compare", False):  # the path's kernels against the CPU sync
            named, named_err = dict(T.leaf_paths(grads)), dict(T.leaf_paths(err_fb))
            got, got_err = dict(T.leaf_paths(out[0])), dict(T.leaf_paths(out[1]))
            for route in sync["routes"]:
                name = min((k for k, g in named.items() if G.leaf_route(g, cfg_s) == route),
                           key=lambda k: named[k].numel())
                s_cpu, e_cpu = orig({name: named[name].cpu()}, {name: named_err[name].cpu()},
                                    cfg_s, axis_name, mesh=mesh)
                if not (torch.equal(s_cpu[name], got[name].cpu())
                        and torch.equal(e_cpu[name], got_err[name].cpu())):
                    raise AssertionError(f"rank {rank} route {route} leaf {name}: card sync != "
                                         "CPU sync")
                sync.setdefault("checked", []).append(f"{route}:{name}")
        return out

    G.pod_sync_tree = timed_sync
    guard = PlainGuard(PlainGuard.TARGETS + PlainGuard.TARGETS_2D)
    try:
        for i, (case, scfg) in enumerate(cases):
            step = S.make_wavelet_train_step(cfg, mesh, opt_cfg, scfg)
            sync["compare"] = i in (0, POD_TRAIN_STEPS)
            obs.reset()
            K.launches.reset()
            with guard:
                (p, o, err, m), ms = _timed(lambda: step(p, o, err, batches[i]), dev)
            launched = K.launches.snapshot()
            if guard.calls:
                raise AssertionError(f"rank {rank} step {i}: plain versions on CUDA tensors "
                                     f"{guard.calls}")
            if sync["ring_bytes"] != sync["payload"]:
                raise AssertionError(f"rank {rank} step {i}: ring shipped {sync['ring_bytes']} "
                                     f"bytes, analytic payload {sync['payload']}")
            for k, v in launched.items():
                rec["launches"][k] = rec["launches"].get(k, 0) + v
            rec["steps"].append({"case": case, "loss": float(m["loss"]), "ms": ms,
                                 "pod_sync_ms": sync["ms"], "ring_bytes": sync["ring_bytes"],
                                 "routes": sync["routes"], "launches": launched,
                                 "checked": sync.pop("checked", [])})
    finally:
        G.pod_sync_tree = orig
    # the replicas against the other rank's, leaf by leaf (one ring hop)
    leaves = T.leaves(p) + T.leaves(o.m) + T.leaves(o.v)
    rec["replica_leaves_equal"] = sum(bool(torch.equal(x, comm.shift(x, op="check")))
                                      for x in leaves)
    rec["replica_leaves"] = len(leaves)
    rec["step"] = int(o.step)
    import torch.distributed as dist

    dist.barrier()
    (pathlib.Path(outdir) / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def train_pods(dev, seed: int) -> dict:
    """Phase 14 (c): the wavelet-synced step on 2 gloo ranks, against the
    plain step on the same batches in this process."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_train_state
    from repro_torch.train import optim
    from repro_torch.train.train_step import make_train_step

    tmp = _scratch("train_pod_")
    t = time.perf_counter()
    try:
        ranks = _spawn(_train_pod_rank, POD_RANKS, (seed, POD_LAYERS, dev.type), tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=POD_LAYERS)
    state = init_train_state(cfg, seed, dev)
    step = make_train_step(cfg, optim.AdamWConfig(**TRAIN_OPT))
    p, o, plain = state["params"], state["opt"], []
    for b in _train_batches(cfg, seed, POD_TRAIN_STEPS + 1, dev):
        p, o, m = step(p, o, b)
        plain.append(float(m["loss"]))
    del state, p, o
    torch.cuda.empty_cache()
    for r in ranks:
        if r["replica_leaves_equal"] != r["replica_leaves"] or r["step"] != POD_TRAIN_STEPS + 1:
            raise AssertionError(f"rank {r['rank']}: {r['replica_leaves_equal']} of "
                                 f"{r['replica_leaves']} replica leaves equal the other rank's")
        for i, (st, want) in enumerate(zip(r["steps"], plain)):
            if st["loss"] != ranks[0]["steps"][i]["loss"] or not (
                    abs(st["loss"] - want) <= POD_LOSS_BOUND * abs(want)):
                raise AssertionError(f"rank {r['rank']} step {i} ({st['case']}): loss "
                                     f"{st['loss']} against the plain step's {want}")
        one_d = [s["launches"] for s in r["steps"] if s["case"] == "1d"]
        spatial = [s["launches"] for s in r["steps"] if s["case"] == "spatial"][0]
        if not all(ln.get("lift1d_fwd") and ln.get("lift1d_inv") for ln in one_d):
            raise AssertionError(f"rank {r['rank']}: a 1-D step launched {one_d}")
        if not (any(spatial.get(k) for k in ("whole3d_fwd", "slab3d_fwd"))
                and any(spatial.get(k) for k in ("whole2d_fwd", "tiled2d_fwd"))):
            raise AssertionError(f"rank {r['rank']}: the spatial step launched {spatial}")
    return {"layers": POD_LAYERS, "sync": POD_TRAIN, "ranks": ranks, "plain_losses": plain,
            "s": secs}


def filled_params(defs, seed: int, dtype, dev) -> dict:
    """Phase 10's fill rule (``fill_kind``: normal(0, 0.02) matrices and
    embeddings, ones for scales, zeros for biases), drawn on ``dev`` from
    a ``torch.Generator`` seeded with ``seed``."""
    from repro_torch import tree as T

    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(defn):
        kind = fill_kind(defn)
        if kind == "normal":
            x = torch.randn(defn.shape, generator=gen, dtype=torch.float32, device=dev)
            return x.mul_(0.02).to(dtype)
        return (torch.ones if kind == "ones" else torch.zeros)(defn.shape, dtype=dtype, device=dev)

    return T.map_leaves(make, defs)


def _grad_spread(got, want, names) -> tuple:
    """The largest max |got - want| over a leaf's largest magnitude, and
    its leaf."""
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, got, want):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item() / scale if scale else (a - b).abs().max().item()
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def train_families(rng, dev, seed: int) -> dict:
    """Phase 14 (d): ``loss_fn``'s gradients per family at full width,
    the card against the CPU from the same parameters and batch.

    The parameters follow phase 10's fill rule.  Under the reference's
    init rule (``init_params``: std 1/sqrt(dim 0), and dim 0 of a stacked
    leaf is the layer count) the attention logits saturate and float32
    gradients at full width are ill-conditioned: the CPU's own gradients
    move with its thread count.  That is measured on stablelm (``init``)
    and printed, not bounded."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as TF
    from repro_torch.train.train_step import _grads_of

    cpu = torch.device("cpu")

    def grads(cfg, params_card, batch):
        on_cpu = T.map_leaves(lambda t: t.cpu(), params_card)
        ms, got = {}, {}
        for where, params, d in (("card", params_card, dev), ("cpu", on_cpu, cpu)):
            t = time.perf_counter()
            loss, _, g = _grads_of(cfg, 0)(params, {k: v.to(d) for k, v in batch.items()})
            got[where] = (loss.cpu(), [x.cpu() for x in T.leaves(g)])
            ms[where] = (time.perf_counter() - t) * 1e3
        return got, ms, on_cpu

    def family_batch(cfg):
        batch = _lm_inputs(cfg, rng, 1, LM_FAMILY_LEN)
        batch["labels"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (1, LM_FAMILY_LEN), dtype=np.int32))
        return batch

    out = {}
    for arch, layers in LM_FAMILIES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers, param_dtype="float32",
                                  compute_dtype="float32")
        on_card = filled_params(TF.model_defs(cfg), seed, torch.float32, dev)
        got, ms, on_cpu = grads(cfg, on_card, family_batch(cfg))
        bound = TRAIN_FAMILY_BOUND.get(cfg.family, TRAIN_FAMILY_BOUND_DEFAULT)
        names = [n for n, _ in T.leaf_paths(on_cpu)]
        for name, a, b in zip(names, got["card"][1], got["cpu"][1]):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item() / scale if scale else (a - b).abs().max().item()
            if a.shape != b.shape or not torch.isfinite(a).all() or err > bound:
                raise AssertionError(f"{arch} ({layers} layers) grad {name}: card against CPU "
                                     f"{err:.3e} of the leaf's scale {scale:.3g} (bound {bound})")
        worst, worst_name = _grad_spread(got["card"][1], got["cpu"][1], names)
        loss_err = abs(got["card"][0].item() - got["cpu"][0].item()) / abs(got["cpu"][0].item())
        if loss_err > bound:
            raise AssertionError(f"{arch}: loss card against CPU {loss_err:.3e} (bound {bound})")
        out[arch] = {"family": cfg.family, "layers": layers, "leaves": len(names),
                     "params": sum(t.numel() for t in T.leaves(on_cpu)), "loss": got["cpu"][0].item(),
                     "loss_rel_err": loss_err, "worst_rel_err": worst, "worst_leaf": worst_name,
                     "bound": bound, "card_ms": ms["card"], "cpu_ms": ms["cpu"],
                     "s": time.perf_counter() - t0}
        del on_card, on_cpu, got
        torch.cuda.empty_cache()
    # the reference's init rule on stablelm, 2 layers: card against CPU,
    # and the CPU against itself on one thread
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    on_card = ML.init_params(TF.model_defs(cfg), seed, torch.float32, device=dev)
    batch = family_batch(cfg)
    got, ms, on_cpu = grads(cfg, on_card, batch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, one = _grads_of(cfg, 0)(on_cpu, batch)
    finally:
        torch.set_num_threads(threads)
    names = [n for n, _ in T.leaf_paths(on_cpu)]
    out["init_params"] = {
        "arch": TRAIN_ARCH, "layers": 2, "card_vs_cpu": _grad_spread(got["card"][1],
                                                                     got["cpu"][1], names),
        "cpu_threads_1_vs_n": _grad_spread(T.leaves(one), got["cpu"][1], names),
        "threads": threads, "s": time.perf_counter() - t0}
    del on_card, on_cpu, got, one
    torch.cuda.empty_cache()
    return out


def training(rng, dev, seed: int) -> dict:
    """Phase 14: the counters reset just before and read just after, the
    plain-version guard on in this process (and in each rank of (c))."""
    from repro_torch import kernels as K

    t = time.perf_counter()
    K.launches.reset()
    with PlainGuard(PlainGuard.TARGETS + PlainGuard.TARGETS_2D) as guard:
        out = {"full_depth": train_full_depth(dev, seed)}
        out["determinism"] = train_determinism(dev, seed)
        out["pods"] = train_pods(dev, seed)
        out["families"] = train_families(rng, dev, seed)
    out["launches_here"] = K.launches.snapshot()
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors in training: {guard.calls}")
    # the training path's launches: those of rank 0 of (c), where the
    # gradient sync runs the kernels (the plain step launches none)
    out["launches"] = dict(out["pods"]["ranks"][0]["launches"])
    for k, v in out["launches_here"].items():
        out["launches"][k] = out["launches"].get(k, 0) + v
    if not (out["launches"].get("lift1d_fwd") and out["launches"].get("lift1d_inv")):
        raise AssertionError(f"lift1d never launched on the training path: {out['launches']}")
    out["s"] = time.perf_counter() - t
    return out


def print_training(tr: dict, card: str) -> None:
    a = tr["full_depth"]
    mem = a["memory"]
    print(f"training: {a['arch']} at full width and depth ({a['layers']} layers, {a['params']} "
          f"parameters, bfloat16, remat), batch {a['batch'][0]} x {a['batch'][1]} repeated, "
          f"{TRAIN_STEPS} steps: losses " + ", ".join(f"{v:.4f}" for v in a["losses"])
          + f"; step ms (events) " + ", ".join(f"{v:.1f}" for v in a["step_ms"])
          + f", p50 of steps 2-{TRAIN_STEPS} {a['step_ms_p50']:.1f} ms, the card busy "
          f"{_fmt_ms(a['busy_ms'])} ms a step (profiler), {a['tokens_per_s']:.0f} tokens/s; "
          f"max_memory_allocated {a['max_memory_allocated_6_steps']} bytes; one step with remat "
          f"{mem['remat']['max_memory_allocated']} bytes ({mem['remat']['step_ms']:.1f} ms), "
          f"without {mem['no_remat']['max_memory_allocated']} bytes "
          f"({mem['no_remat']['step_ms']:.1f} ms), the state {mem['remat']['state_bytes']} "
          f"bytes ({card})")
    print("  busiest kernels a step (profiler, ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in a["busy_by_kernel_top"].items()))
    d = tr["determinism"]
    print(f"  determinism ({d['layers']} layers, full width, deterministic algorithms): two runs "
          f"of {d['steps']} steps torch.equal; remat step "
          + ("torch.equal to a no-remat step" if d["remat_equal"] else
             f"differs at {d['remat_unequal_leaves']} leaves")
          + f"; ops without a deterministic version: {d['nondeterministic_ops'] or 'none'}")
    pd = tr["pods"]
    for r in pd["ranks"]:
        print(f"  wavelet step rank {r['rank']} of {POD_RANKS} ({POD_LAYERS} layers, transport "
              f"{r['route']}): " + "; ".join(
                  f"{s['case']} loss {s['loss']:.4f} {s['ms']:.1f} ms (pod_sync_tree "
                  f"{s['pod_sync_ms']:.1f}), ring {s['ring_bytes']} bytes a hop = payload, "
                  f"routes {s['routes']}" + (f", {s['checked']} == CPU sync" if s["checked"]
                                             else "")
                  for s in r["steps"])
              + f"; replicas {r['replica_leaves_equal']} / {r['replica_leaves']} leaves equal; "
              f"launches {r['launches']} ({card})")
    print("  plain step on the same batches: losses " + ", ".join(
        f"{v:.4f}" for v in pd["plain_losses"]) + f" (bound {POD_LOSS_BOUND:.0%}); "
        f"ranks {pd['s']:.1f} s")
    fam = dict(tr["families"])
    ref_init = fam.pop("init_params")
    for arch, f in fam.items():
        print(f"  {arch} ({f['family']}, full width, {f['layers']} layers, {f['params']} "
              f"parameters, float32, phase 10's fill): loss_fn grads card against CPU, worst "
              f"{f['worst_rel_err']:.2e} of the leaf's scale ({f['worst_leaf']}), loss "
              f"{f['loss_rel_err']:.2e} (bound {f['bound']}); card {f['card_ms']:.1f} ms, CPU "
              f"{f['cpu_ms']:.1f} ms")
    print(f"  {ref_init['arch']} ({ref_init['layers']} layers) under the reference's init rule "
          f"(not bounded): card against CPU {ref_init['card_vs_cpu'][0]:.2e} of the leaf's "
          f"scale ({ref_init['card_vs_cpu'][1]}); the CPU on 1 thread against "
          f"{ref_init['threads']} threads {ref_init['cpu_threads_1_vs_n'][0]:.2e} "
          f"({ref_init['cpu_threads_1_vs_n'][1]})")
    print(f"launches on the training path: {tr['launches']}; phase 14 {tr['s']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 15: the dry run and the roofline.
# ---------------------------------------------------------------------------

# (a) phase 14 (a)'s step as a dry-run cell: stablelm-2-1.6b uncut,
# bfloat16, 8 x 256, remat on and off
DRY_CELL = ("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
DRY_PEAK_BOUND = 0.10  # |estimate - max_memory_allocated| / max_memory_allocated
DRY_SHARE_BOUND = 1.05  # max(compute_s, memory_s) / the card's busy s
# (b) every SHAPE_SUITE cell of stablelm-1.6b and one MoE decode cell
DRY_EXTRA_CELLS = (("phi3.5-moe-42b-a6.6b", "decode_32k"),)
# (d) the ported examples, run in process on the card
EXAMPLES = ("torch_quickstart", "torch_wavelet_pipeline", "torch_codec_roundtrip",
            "torch_observe_serve")


def dry_run_against_card(dev, seed: int) -> dict:
    """Phase 15 (a): the dry run of phase 14's step, then the same step on
    the card under the same counters, remat on and off."""
    from repro_torch import roofline as RL
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.train import init_train_state

    cell = ShapeCell(*DRY_CELL)
    cfg = get_config(TRAIN_ARCH)
    state = init_train_state(cfg, seed, dev)
    (batch,) = _train_batches(cfg, seed, 1, dev)
    p, o = state.pop("params"), state.pop("opt")
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        art = D.run_cell(TRAIN_ARCH, cell.name, False, save=False, cfg=c, cell=cell, probe=remat)
        if art["status"] != "OK":
            raise AssertionError(f"dry run of {TRAIN_ARCH} {cell}: {art}")
        if art["probe"] and not art["probe"].get("equals_trace"):
            raise AssertionError(f"remat={remat}: the probes' extrapolation {art['probe']} is not "
                                 f"the full-depth trace {art['trace']}")
        step, _, _ = D.build_cell(c, cell, D.make_mesh(False)[0], False)
        t_trace = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        real = D.count_step(step, (p, o, batch))
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        trace, mem = art["trace"], art["memory_analysis"]
        if (real["flops"], real["bytes"]) != (trace["flops"], trace["bytes"]):
            raise AssertionError(f"remat={remat}: the card's step counted {real['flops']} FLOPs, "
                                 f"{real['bytes']} bytes; the meta trace {trace['flops']}, "
                                 f"{trace['bytes']}")
        peak_err = abs(mem["peak_bytes_est"] - peak) / peak
        if peak_err > DRY_PEAK_BOUND:
            raise AssertionError(f"remat={remat}: peak estimate {mem['peak_bytes_est']} against "
                                 f"max_memory_allocated {peak} ({peak_err:.1%})")
        t_card = time.perf_counter()
        busy = _pass_ms(lambda: step(p, o, batch), reps=1, warm=0, every_kernel=True)
        if not busy or not all(isinstance(v, float) for v in busy.values()):
            busy = _pass_ms(lambda: step(p, o, batch), reps=2, warm=1, every_kernel=True)
        if not busy or not all(isinstance(v, float) for v in busy.values()):
            raise AssertionError(f"remat={remat}: the card's busy time was not measured, so the "
                                 f"roofline share cannot be checked: {busy}")
        t_busy = time.perf_counter()
        busy_ms = sum(busy.values())
        report = RL.build_report(
            arch=TRAIN_ARCH, cell=cell.name, mesh_name="h100x1", chips=1,
            cost={"flops": trace["flops"], "bytes accessed": trace["bytes"]},
            collectives=RL.CollectiveStats(), model_flops=art["roofline"]["model_flops"],
            compute_dtype=c.compute_dtype)
        share = max(report.compute_s, report.memory_s) / (busy_ms / 1e3)
        if share > DRY_SHARE_BOUND:
            raise AssertionError(f"remat={remat}: the roofline ({report.compute_s:.4f} s, "
                                 f"{report.memory_s:.4f} s) exceeds the card's busy "
                                 f"{busy_ms:.1f} ms ({share:.2f}): a count is wrong")
        out["remat" if remat else "no_remat"] = {
            "flops": trace["flops"], "bytes": trace["bytes"], "ops": trace["ops"],
            "card_ops": real["ops"], "probe": art["probe"] and {
                "flops": art["probe"]["flops"], "bytes": art["probe"]["bytes"]},
            "peak_bytes_est": mem["peak_bytes_est"], "argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"], "max_memory_allocated": peak, "peak_err": peak_err,
            "compute_s": report.compute_s, "memory_s": report.memory_s, "busy_ms": busy_ms,
            "share": share, "model_flops": report.model_flops, "trace_s": trace["seconds"],
            "card_count_s": t_card - t_trace, "busy_s": t_busy - t_card}
    del p, o, batch
    torch.cuda.empty_cache()
    return out


def dry_run_cells() -> list:
    """Phase 15 (b): stablelm-1.6b over SHAPE_SUITE and DRY_EXTRA_CELLS,
    from the meta trace (no probes: (a) holds them)."""
    from repro_torch.configs.base import SHAPE_SUITE
    from repro_torch.launch import dryrun as D

    rows = []
    for arch, cell in [(TRAIN_ARCH, c.name) for c in SHAPE_SUITE] + list(DRY_EXTRA_CELLS):
        r = D.run_cell(arch, cell, False, save=False, probe=False)
        if r["status"] == "FAIL":
            raise AssertionError(f"dry run {arch} {cell}: {r.get('error')}")
        rows.append(r)
    return rows


def dry_run_wavelet(tr: dict) -> dict:
    """Phase 15 (c): the wavelet sync's schedule on phase 14 (c)'s tree
    and codecs against the ring bytes phase 14 (c) counted a hop."""
    from repro_torch.launch import dryrun_wavelet as DW

    sync = {k: v for k, v in POD_TRAIN.items() if k not in ("levels", "codec", "n_pods")}
    out = {}
    for case, extra in (("1d", {}), ("spatial", {"spatial_2d": True, "spatial_3d": True})):
        _, stats, mesh = DW.lower_wavelet_cell(TRAIN_ARCH, "train_4k", POD_TRAIN["levels"],
                                               n_layers=POD_LAYERS, **sync, **extra)
        hop = stats.by_op_bytes["ring"] / (mesh.axes["pod"] - 1)
        measured = {st["ring_bytes"] for r in tr["pods"]["ranks"] for st in r["steps"]
                    if st["case"] == case}
        if measured != {hop}:
            raise AssertionError(f"{case}: the schedule's ring {hop} bytes a hop, phase 14 (c) "
                                 f"counted {sorted(measured)}")
        out[case] = {"ring_bytes_per_hop": hop, "wire_per_device": stats.wire_bytes_per_device,
                     "counts": stats.counts}
    out["result"] = DW.wavelet_result(TRAIN_ARCH, "train_4k", POD_TRAIN["levels"],
                                      n_layers=POD_LAYERS, **sync)
    return out


def _example_flags(lines: list) -> list:
    """The flags an example prints: each line that asks a question or
    names losslessness, with the True / False words after a ``?`` or
    ``:`` in it."""
    import re

    return [(ln, re.findall(r"[?:]\s*(True|False)\b", ln)) for ln in lines
            if "?" in ln or "lossless" in ln]


def run_examples(dev) -> dict:
    """Phase 15 (d): each ported example's ``main`` on the card, in a
    scratch directory; every flag it prints must be True, quickstart's
    "kernel == plain?" included; its launches per kernel."""
    import importlib.util
    import io

    from repro_torch import kernels as K

    out = {}
    tmp = _scratch("examples_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            K.launches.reset()
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mod.main(["--device", dev.type])
            torch.cuda.synchronize(dev)
            lines = buf.getvalue().splitlines()
            flags = _example_flags(lines)
            if name == "torch_observe_serve":  # its flags: a retry healed, a trace of spans
                healed = any(ln.startswith("retry episode: 1 retry -> 1 heal") for ln in lines)
                spans = json.loads((tmp / mod.TRACE_PATH).read_text())["traceEvents"]
                flags = [("retry -> heal", [str(healed)]), ("trace spans", [str(bool(spans))])]
            if not flags or any(v != ["True"] for _, v in flags):
                raise AssertionError(f"{name} on the card printed {flags}")
            out[name] = {"launches": K.launches.snapshot(), "flags": len(flags),
                         "s": time.perf_counter() - t,
                         "lines": [ln for ln, _ in flags]}
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    if not any(v["launches"] for v in out.values()):
        raise AssertionError("no kernel launched in the examples")
    return out


def dry_run(dev, seed: int, tr: dict) -> dict:
    """Phase 15: (a) the dry run against the card, (b) the cells, (c) the
    wavelet sync's schedule, (d) the examples."""
    t = time.perf_counter()
    out, secs = {}, {}
    for key, fn in (("card", lambda: dry_run_against_card(dev, seed)), ("cells", dry_run_cells),
                    ("wavelet", lambda: dry_run_wavelet(tr)),
                    ("examples", lambda: run_examples(dev))):
        t0 = time.perf_counter()
        out[key] = fn()
        secs[key] = time.perf_counter() - t0
    out["part_s"] = secs
    out["launches"] = {}
    for ex in out["examples"].values():
        for k, v in ex["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    out["s"] = time.perf_counter() - t
    return out


def print_dry_run(dr: dict, card: str) -> None:
    for key, a in dr["card"].items():
        probe = (f"; the probes extrapolate {a['probe']['flops']:.0f} FLOPs, "
                 f"{a['probe']['bytes']:.0f} bytes (== the trace)" if a["probe"] else "")
        print(f"dry run ({key}): {TRAIN_ARCH} {DRY_CELL[2]} x {DRY_CELL[1]} full depth: meta trace "
              f"{a['flops']} FLOPs, {a['bytes']} bytes ({a['ops']} ops, {a['trace_s']:.1f} s) == "
              f"the card's step under the same counters ({a['card_ops']} ops, "
              f"{a['card_count_s']:.1f} s; profile {a['busy_s']:.1f} s){probe}; peak estimate {a['peak_bytes_est']:.0f} B "
              f"(arguments {a['argument_bytes']} + temp {a['temp_bytes']}) against "
              f"max_memory_allocated {a['max_memory_allocated']} ({a['peak_err']:.2%}, bound "
              f"{DRY_PEAK_BOUND:.0%}); compute_s {a['compute_s'] * 1e3:.2f} ms, memory_s "
              f"{a['memory_s'] * 1e3:.2f} ms, the card busy {_fmt_ms(a['busy_ms'])} ms "
              f"(profiler), share {a['share']:.4f} "
              f"(bound {DRY_SHARE_BOUND}), useful {a['model_flops'] / a['flops']:.3f} ({card})")
    for r in dr["cells"]:
        if r["status"] != "OK":
            print(f"  cell {r['arch']} {r['cell']}: {r['status']} {r['reason']}")
            continue
        rl, mem = r["roofline"], r["memory_analysis"]
        print(f"  cell {r['arch']} {r['cell']}: OK, {rl['hlo_flops'] / 1e9:.1f} GFLOPs, "
              f"{rl['hlo_bytes'] / 1e9:.1f} GB moved, peak {mem['peak_bytes_est'] / 1e9:.1f} GB, "
              f"fits {mem['fits']}, dominant {rl['dominant']} (C {rl['compute_s']:.4f} s, "
              f"M {rl['memory_s']:.4f} s), trace {r['lower_s']} s ({r['device']['card']})")
    w = dr["wavelet"]
    res = w["result"]
    print(f"  wavelet sync schedule ({POD_LAYERS} layers, levels {POD_TRAIN['levels']}, min_size "
          f"{POD_TRAIN['min_size']}): ring {w['1d']['ring_bytes_per_hop']:.0f} bytes a hop (1-D), "
          f"{w['spatial']['ring_bytes_per_hop']:.0f} (2-D / 3-D) == phase 14 (c)'s counters; "
          f"baseline {res['baseline_wire_per_device']:.0f} B a device against "
          f"{res['wavelet_wire_per_device']:.0f} ({res['pod_axis_reduction']:.3f}x, analytic "
          f"{res['analytic_ratio']:.3f}x)")
    for name, ex in dr["examples"].items():
        print(f"  example {name} on the card: {ex['flags']} flags True, {ex['s']:.1f} s, "
              f"launches {ex['launches']}")
    print(f"launches in the examples: {dr['launches']}; phase 15 {dr['s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in dr["part_s"].items()) + ")")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--json-out", default="", help="also write the full record here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    # phase 14 (b) runs under deterministic algorithms, which need cuBLAS's
    # fixed workspace: it is read when CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; INT32 rate {int32_ops_per_s():.4g} ops/s "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs x "
          f"{INT32_LANES_PER_SM} lanes x {_smi('clocks.max.sm')}); torch {torch.__version__} "
          f"(CUDA {torch.version.cuda})", flush=True)

    from repro_torch.kernels import _build

    t = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t:.2f} s for {list(_build.SOURCES)}", flush=True)
    for name in _build.SOURCES:
        regs = [ln.strip() for ln in _build.build_log(name).splitlines() if "registers" in ln]
        print(f"  {name}: {regs}")

    rng = np.random.default_rng(args.seed)
    t = time.perf_counter()
    checks = parity_sweep(rng, dev)
    checks.update(rice_sweep(rng, dev))
    print(f"parity: kernel == plain version on every case {checks} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    srv = serve(rng, dev, args.requests)
    for bucket, plan in srv["plans"].items():
        print(f"plan_2d {bucket}: {plan}")
    print(f"serve: {srv['requests']} requests ({srv['undersized']} undersized) in "
          f"{srv['batches']} batches, {srv['requests_per_s']:.2f} req/s, batch latency "
          f"p50 {srv['batch_ms_p50']:.2f} ms p99 {srv['batch_ms_p99']:.2f} ms; every "
          f"response reconstructs bit-exact", flush=True)
    print(f"launches on the serve path: forward {srv['launches_forward']}, "
          f"with reconstruction {srv['launches']}")
    print("one 2048^2 batch, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in srv["breakdown_2048_ms"].items()))

    enc = serve_encoded(rng, dev, args.requests)
    print(f"encoded serve: {enc['requests']} requests ({enc['undersized']} undersized) in "
          f"{enc['batches']} batches, {enc['requests_per_s']:.2f} req/s, batch latency "
          f"p50 {enc['batch_ms_p50']:.2f} ms p99 {enc['batch_ms_p99']:.2f} ms; every "
          f"container decoded on the card and every request bit-exact; plain-encode "
          f"containers equal for {enc['plain_container_checked']}; encode degrades "
          f"{enc['encode_degrades']}, quarantines {enc['encode_quarantines']}", flush=True)
    print(f"launches on the encoded serve path: serving {enc['launches_serve']} (rice_encode "
          f"once per encoded batch), with the client's decode and reconstruction "
          f"{enc['launches']}")
    bd = enc["breakdown_2048_ms"]
    print(f"one encoded 2048^2 x 8 step ({bd['coefficients']} coefficients, "
          f"{bd['payload_bytes']} payload bytes, {bd['container_bytes']} container bytes), ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in bd["ms"].items()))

    t = time.perf_counter()
    checks.update(parity_sweep_1d(rng, dev))
    print(f"1-D parity: lift1d and row-pass kernels == plain versions on every case, "
          f"{checks['cases_1d']} cases; comparison launches {checks.pop('launches')} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    lib = library_path_1d(rng, dev)
    print(f"1-D path: LARGE, LARGE_HAAR, LARGE_97M (64 x 65536 int32, 4 levels) forward and "
          f"inverse, checked and not, equal to the plain versions and bit-exact round trips; "
          f"over-range 97m raised IntegerOverflowError for {sorted(lib['raised'])}; "
          f"{lib['container_bytes']}-byte WZRC container and {lib['stream_bytes']}-byte WZRS "
          f"stream equal to the plain encode and decoded exactly on the card", flush=True)
    print(f"launches on the 1-D path: {lib['launches']}; plain versions called on CUDA "
          f"tensors: {sum(lib['plain_calls_on_cuda'].values())}")
    print("lift1d launches a call (forward / inverse): " + "; ".join(
        f"{k} {v['forward']} / {v['inverse']}" for k, v in lib["lift1d_per_call"].items()))
    print("1-D path, ms: " + "; ".join(
        f"{k} " + (f"{v:.3f}" if isinstance(v, float) else
                   ", ".join(f"{a} {b:.3f}" for a, b in v.items()))
        for k, v in lib["ms"].items()))
    for name, plan in lib["plans"].items():
        print(f"plan_1d {name}: {plan}")

    t = time.perf_counter()
    checks.update(parity_sweep_3d(rng, dev))
    keys_3d = ("whole3d", "whole3d_multipass", "whole3d_by_cluster", "slab3d", "slab3d_plane_pass",
               "slab3d_row_col_passes", "library")
    print(f"3-D parity: whole3d and slab3d kernels == plain versions on every case "
          f"{ {k: checks[k] for k in keys_3d} } "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    t = time.perf_counter()
    vp = volume_paths(rng, dev)
    print(f"3-D path: {VOLUME} CT-like volume, {VOL_LEVELS} levels, {VOL_SCHEME}/{VOL_MODE} and "
          f"cdf22/paper, checked and not, equal to the plain oracle with bit-exact round trips; "
          f"over-range 97m raised IntegerOverflowError for {sorted(vp['raised'])} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    for name, plan in vp["plans"].items():
        print(f"plan_3d {name} {VOLUME}: {plan}")
    for key, sv in vp["serve"].items():
        print(f"3-D serve ({key}): {sv['requests']} volumes ({sv['undersized']} undersized) in "
              f"{sv['batches']} batches over buckets {list(VOL_BUCKETS)}, {VOL_SLOTS} slots, "
              f"{sv['requests_per_s']:.3f} req/s, batch p50 {sv['batch_ms_p50']:.1f} ms; every "
              f"response reconstructed on the card bit-exact")
    print(f"3-D encoded serve: containers equal to the plain encode for "
          f"{vp['plain_container_checked']}; thumbnail of request {vp['thumbnail_uid']} == its "
          f"approx band; WZRS volume stream ({vp['stream_bytes']} bytes, slab=8, levels=3) equal "
          f"to the plain encode and decoded exactly on the card")
    print(f"launches on the 3-D path: {vp['launches']}; plain versions called on CUDA tensors: "
          f"{sum(vp['plain_calls_on_cuda'].values())}")
    print("3-D path, ms: " + "; ".join(
        f"{k} " + (f"{v:.3f}" if isinstance(v, float) else
                   ", ".join(f"{a} {b:.3f}" for a, b in v.items()))
        for k, v in vp["ms"].items()))
    bd = vp["breakdown_ms"]
    print(f"one encoded {VOL_SLOTS} x {VOL_BUCKETS[-1]} step ({bd['coefficients']} coefficients, "
          f"{bd['payload_bytes']} payload bytes, {bd['container_bytes']} container bytes), ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in bd["ms"].items()))

    kernels = time_kernels(rng, dev) + time_rice(rng, dev)
    for k in kernels:
        k["launches"] = enc["launches"][k["name"]]
    kernels_1d = time_1d(rng, dev)
    shapes_1d = {}
    for k in kernels_1d:
        k["launches"] = lib["launches"][k["name"]]
        shapes_1d[k["name"]] = k.pop("shapes")
        for key, sh in shapes_1d[k["name"]].items():
            what = ("run of 4 levels" + (" (policy)" if sh["policy"] else "")
                    if "policy" in sh else "one level")
            print(f"  {k['name']} ({key}) {sh['scheme']} {sh['shape']} {what}: {sh['ms']:.4f} ms "
                  f"events, device {_fmt_ms(sh['device_ms'])} ms, host {sh['host_us']:.1f} us "
                  f"a call, {sh['launches_a_call']} launch(es) a call; plain "
                  f"{sh['plain_ms']:.3f} ms, bound {sh['bound_ms']:.4f} ms ({card})")
    chains_2d = {}
    for k in kernels:
        for ch in k.pop("chains", []):
            chains_2d.setdefault(k["name"], []).append(ch)
            print(f"  {k['name']} {ch['label']} {ch['shape']} x {ch['levels']} levels: "
                  f"{ch['ms']:.4f} ms (device {_fmt_ms(ch['device_ms'])} ms, host "
                  f"{ch['host_us']:.1f} us a call, launches (levels, cluster) {ch['launches']}; "
                  f"plain {ch['plain_ms']:.3f} ms, bound {ch['bound_ms']:.6f} ms)")
        for lv in k.pop("levels"):
            if "tile" in lv:  # a 2-D kernel's level
                tile = f", tile {lv['tile']}" if lv["tile"] else ""
                whole = (f", host {lv['host_us']:.1f} us a call, cluster {lv['cluster']}"
                         if "host_us" in lv else "")
                dev_ms = ", ".join(f"{a} {_fmt_ms(b)}" for a, b in lv["device_ms"].items())
                print(f"  {k['name']} {lv['shape']}: {lv['ms']:.4f} ms (plain {lv['plain_ms']:.3f}"
                      f" ms, bound {lv['bound_ms']:.4f} ms{tile}{whole}; device: {dev_ms})")
            elif "set" in lv:  # the decode of one container's bands, one launch
                dev_ms = ", ".join(f"{a} {_fmt_ms(b)}" for a, b in lv["device_ms"].items())
                print(f"  {k['name']} {lv['set']}: {lv['ms']:.4f} ms (device: {dev_ms}; "
                      f"decode_bands {lv['decode_bands_ms']:.4f} ms, host "
                      f"{lv['decode_bands_host_us']:.1f} us a call; bound {lv['bound_ms']:.4f} ms)")
            else:  # the Rice kernels: all bands of the batch at once
                print(f"  {k['name']} {lv}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms,"
                      f" bound {k['bound_ms']:.4f} ms, {k['bound_by']})")
    kernels_3d = time_3d(rng, dev)
    levels_3d = {}
    for k in kernels_3d:
        k["launches"] = vp["launches"][k["name"]]
        levels_3d[k["name"]] = {"levels": k.pop("levels"), "other_levels": k.pop("other_levels")}
        for lv in levels_3d[k["name"]]["levels"]:
            path = ""
            if "passes" in lv:
                path = (f", td {lv['td']}, {lv['passes']} passes"
                        + (f" (plane pass of {lv['plane_rows']} rows)" if lv["plane_rows"]
                           else " (row and column passes)")
                        + "; by kernel: " + ", ".join(f"{a} {_fmt_ms(b)}"
                                                      for a, b in lv["pass_ms"].items()))
            else:
                path = (f", device {_fmt_ms(lv['device_ms'])} ms, host {lv['host_us']:.1f} us a "
                        f"call, cluster {lv['cluster']}")
            print(f"  {k['name']} {lv['shape']}: {lv['ms']:.4f} ms (plain {lv['plain_ms']:.3f} ms, "
                  f"bound {lv['bound_ms']:.4f} ms{path})")
        for label, lv in (levels_3d[k["name"]]["other_levels"] or {}).items():
            print(f"  {k['name']} {label} {lv['shape']} {lv['scheme']}: {lv['ms']:.4f} ms "
                  f"(device {_fmt_ms(lv['device_ms'])} ms, host {lv['host_us']:.1f} us a call, "
                  f"cluster {lv['cluster']}; plain {lv['plain_ms']:.3f} ms, bound "
                  f"{lv['bound_ms']:.4f} ms)")
    t = time.perf_counter()
    ck = checkpoint_path(rng, dev, card)
    print_checkpoint(ck, card, time.perf_counter() - t)
    pe = paper_evaluation(rng, dev)
    print_paper(pe, card)
    sp = sharded_paths(rng, dev, args.requests)
    print_sharded(sp, card)
    lm = lm_serving(rng, dev, args.seed)
    print_lm(lm, card)
    tr = training(rng, dev, args.seed)
    print_training(tr, card)
    dr = dry_run(dev, args.seed, tr)
    print_dry_run(dr, card)
    kernels_paper = [filterbank_entry(pe)]
    for k in kernels + kernels_1d + kernels_3d + kernels_paper:
        k["launches_ckpt"] = ck["launches"].get(k["name"], 0)
        k["launches_sharded"] = (sp["serve"]["runs"]["encoded"]["launches"].get(k["name"], 0)
                                 + sp["transform"]["ranks"][0]["launches"].get(k["name"], 0))
        k["launches_lm"] = lm["launches"].get(k["name"], 0)
        k["launches_train"] = tr["launches"].get(k["name"], 0)
        k["launches_examples"] = dr["launches"].get(k["name"], 0)
    if args.json_out:
        record = {"card": card, "torch": torch.__version__, "seed": args.seed,
                  "checkpoint": ck,
                  "parity_cases": checks, "serve": srv, "serve_encoded": enc,
                  "path_1d": lib, "kernels_1d_shapes": shapes_1d, "path_3d": vp,
                  "kernels_3d_levels": levels_3d, "whole2d_chains": chains_2d,
                  "paper_evaluation": pe, "sharded": sp, "lm_serving": lm, "training": tr,
                  "dry_run": dr,
                  "kernels": kernels + kernels_1d + kernels_3d + kernels_paper}
        out = pathlib.Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    kernels += kernels_1d + kernels_3d + kernels_paper
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
