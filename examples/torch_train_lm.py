"""The port's training driver end to end (``examples/train_lm.py`` on
``repro_torch``): train a ~100M-param LM on the synthetic pipeline with
checkpointing and the straggler watchdog.

    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 50 --device cpu

Runs on the card by default; ``--device cpu`` runs the same code path on
the CPU (``tiny`` in seconds).  The 100m preset is the deliverable
configuration.
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.train import optim

PRESETS = {
    # ~103M params: 12L x 768d, vocab 16384, swiglu — stablelm family
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                 d_ff=2048, vocab_size=16384, seq=256, batch=8),
    # ~10M: CI-speed
    "10m": dict(n_layers=6, d_model=256, n_heads=8, n_kv_heads=8, head_dim=32,
                d_ff=1024, vocab_size=8192, seq=128, batch=8),
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                 d_ff=256, vocab_size=512, seq=64, batch=4),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    p = dict(PRESETS[args.preset])
    seq, batch = p.pop("seq"), p.pop("batch")
    base = get_config("stablelm-1.6b")
    cfg = dataclasses.replace(
        base, param_dtype="float32", compute_dtype="float32", attn_chunk=64, **p
    )
    n_params = cfg.param_count()
    print(f"preset={args.preset}: {n_params/1e6:.1f}M params, "
          f"seq={seq} batch={batch} steps={args.steps} device={args.device}")
    out = train(
        cfg,
        steps=args.steps,
        global_batch=batch,
        seq_len=seq,
        ckpt_dir=args.ckpt_dir,
        opt_cfg=optim.AdamWConfig(lr=6e-4, warmup_steps=max(args.steps // 20, 1),
                                  total_steps=args.steps),
        log_every=max(args.steps // 20, 1),
        device=args.device,
    )
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"in {out['wall_s']:.0f}s ({out['steps']} steps)")
    if out["final_loss"] >= out["first_loss"]:
        raise SystemExit("training must reduce loss")


if __name__ == "__main__":
    main()
