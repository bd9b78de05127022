"""End-to-end training driver (port of ``repro.launch.train``).

Runs on the card by default and on the CPU when asked, with reduced
configs (the examples use it):

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

The state is ``{"params", "opt": AdamWState}``; parameters are drawn by
``models.layers.init_params`` from a ``torch.Generator`` seeded with
``seed`` on the device, so their values differ from ``jax.random``'s.
:func:`state_from_numpy` carries the reference's state across instead.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.ckpt.ft import TrainLoopRunner
from repro_torch.configs import get_config
from repro_torch.configs import reduced as make_reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.train import optim
from repro_torch.train.train_step import make_train_step


def init_train_state(cfg: ArchConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    pdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.param_dtype]
    params = L.init_params(TF.model_defs(cfg), seed, pdt, device=device)
    return {"params": params, "opt": optim.adamw_init(params)}


def state_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's ``{"params", "opt": AdamWState}``, given as host
    arrays (or anything ``np.asarray`` takes), as the port's state on
    ``device``: bfloat16 leaves by their bits, ``step`` a 0-dim int32
    tensor."""
    step, m, v = tree["opt"]
    dev = resolve_device(device)
    return {"params": L.params_from_numpy(tree["params"], dev),
            "opt": optim.AdamWState(
                step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
                m=L.params_from_numpy(m, dev), v=L.params_from_numpy(v, dev))}


def embeds_stub(cfg: ArchConfig) -> np.ndarray:
    """The modality front-end stub of the ``embeds`` archs: a fixed
    (vocab, d_model) float32 projection of tokens, the reference's draw."""
    rng = np.random.default_rng(7)
    return rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(np.float32) * 0.02


def batch_to_device(cfg: ArchConfig, batch: Dict[str, np.ndarray], device,
                    proj: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """A host batch of ``tokens`` / ``labels`` as the model's inputs on
    ``device`` (``embeds`` through ``proj`` for the ``embeds`` archs)."""
    if cfg.input_mode == "embeds":
        proj = embeds_stub(cfg) if proj is None else proj
        batch = {"embeds": proj[batch["tokens"]], "labels": batch["labels"]}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def train(
    cfg: ArchConfig,
    *,
    steps: int,
    global_batch: int,
    seq_len: int,
    ckpt_dir: Optional[str] = None,
    opt_cfg: Optional[optim.AdamWConfig] = None,
    n_microbatches: int = 1,
    log_every: int = 10,
    fail_at: Optional[int] = None,
    seed: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    dev = resolve_device(device)
    opt_cfg = opt_cfg or optim.AdamWConfig(
        lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps
    )
    data = SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch, seed=seed)
    )
    inner = make_train_step(cfg, opt_cfg, n_microbatches=n_microbatches)
    proj = embeds_stub(cfg) if cfg.input_mode == "embeds" else None

    def step_fn(state, batch):
        params, opt, metrics = inner(state["params"], state["opt"],
                                     batch_to_device(cfg, batch, dev, proj))
        return {"params": params, "opt": opt}, metrics

    state = init_train_state(cfg, seed, dev)
    start = 0
    runner = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=2, device=dev)
        runner = TrainLoopRunner(ckpt=mgr, save_every=max(steps // 4, 1))
        state, start = runner.resume_or_init(state)

    losses = []

    def on_metrics(step: int, m: Dict) -> None:
        losses.append(float(m["loss"]))
        if step % log_every == 0 or step == steps - 1:
            print(
                f"step {step:5d} loss {float(m['loss']):.4f} "
                f"gnorm {float(m.get('grad_norm', 0)):.3f} lr {float(m.get('lr', 0)):.2e}"
            )

    t0 = time.time()
    if runner is not None:
        state, end_step = runner.run(
            state, step_fn, data.batch, steps, start_step=start,
            on_metrics=on_metrics, fail_at=fail_at,
        )
    else:
        for s in range(start, steps):
            state, m = step_fn(state, data.batch(s))
            on_metrics(s, m)
        end_step = steps
    wall = time.time() - t0
    return {
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "losses": losses,
        "steps": end_step,
        "wall_s": wall,
        "state": state,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    out = train(
        cfg,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        n_microbatches=args.microbatches,
        device=args.device,
    )
    print(
        f"done: {out['steps']} steps in {out['wall_s']:.1f}s on {args.device} | "
        f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
