"""AdamW + global-norm clipping, from scratch (port of ``repro.train.optim``).

Moments are kept in float32 whatever the parameter dtype: the update is
computed in float32 and cast back to the parameter's dtype.  State is a
tree mirroring the parameters, with the reference's ``AdamWState`` named
tuple, so checkpoint leaf names follow ``jax.tree_util``'s paths
(``opt/m/...``, ``opt/step``) through ``repro_torch.tree``.

The formula is the reference's, written in plain torch ops (not
``torch.optim.AdamW``, which places ``eps`` after dividing ``sqrt(v)`` by
``sqrt(1 - b2^t)`` and applies the decay as a separate multiply, so it
rounds differently).  Every division has a float32 tensor on both sides:
a CUDA divide by a Python number multiplies by its reciprocal
(``core.compression.divide_f32``).  Multiplies by Python numbers round
the number to float32 first, as XLA does with a weakly typed constant.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import Tensor

from repro_torch import tree as T

PyTree = Any


class AdamWState(NamedTuple):
    step: Tensor  # 0-dim int32, on the parameters' device
    m: PyTree  # float32 first moment
    v: PyTree  # float32 second moment


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _f32(x: float, device) -> Tensor:
    """``x`` rounded to a 0-dim float32 tensor on ``device``."""
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def adamw_init(params: PyTree) -> AdamWState:
    def zeros(p):
        return torch.zeros(tuple(p.shape), dtype=torch.float32, device=p.device)

    first = T.leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                      m=T.map_leaves(zeros, params), v=T.map_leaves(zeros, params))


def _recip(d: float, device) -> Tensor:
    """``1 / d`` rounded to float32 (``d`` rounded first), as a 0-dim
    tensor: XLA divides by a constant by multiplying by this."""
    one = np.float32(1.0) / np.float32(d)
    return torch.tensor(float(one), dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio`` (float32, on
    ``step``'s device).  The reference's compiled program divides by its
    two constant denominators as products with their float32 reciprocals
    and fuses ``min_lr_ratio + (1 - min_lr_ratio) * cos`` into one
    multiply-add, rounded once; the port does the same (the fused sum in
    float64: exact product, one rounding to float32).  Its float32 ``cos``
    is within an ulp of the cosine but not correctly rounded; the port
    rounds a float64 cosine, which agrees with it more often than torch's
    float32 one (ROADMAP.md Queue 3, "AdamW rounding")."""
    dev = step.device
    s = step.to(torch.float32)
    warm = torch.clamp(s * _recip(max(cfg.warmup_steps, 1), dev), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) * _recip(max(cfg.total_steps - cfg.warmup_steps, 1),
                                                        dev), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos((math.pi * prog).to(torch.float64)).to(torch.float32))
    slope = float(np.float32(1.0 - cfg.min_lr_ratio))
    scale = (cos.to(torch.float64) * slope + float(np.float32(cfg.min_lr_ratio))).to(torch.float32)
    return cfg.lr * warm * scale


def global_norm(tree: PyTree) -> Tensor:
    """sqrt of the float32 sum of every leaf's float32 sum of squares."""
    total = None
    for leaf in T.leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(gn: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(_f32(max_norm, gn.device) / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> Tuple[PyTree, Tensor]:
    """Scale every leaf by ``min(1, max_norm / max(gn, 1e-9))``, the scale
    cast to the leaf's dtype first (a bfloat16 grad is scaled by a
    bfloat16 scale, as the reference's ``scale.astype(g.dtype)``)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return T.map_leaves(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_update(grads: PyTree, state: AdamWState, params: PyTree,
                 cfg: AdamWConfig) -> Tuple[PyTree, AdamWState, Dict[str, Tensor]]:
    """One AdamW step: ``(new_params, new_state, {"grad_norm", "lr"})``.
    Nothing given is changed; every returned tensor is new.

    The clip is folded into the update as the reference's compiled program
    computes it: a leaf's grad times the scale cast to the leaf's dtype,
    the product kept in float32 (XLA keeps the excess precision of its
    fusions, so a bfloat16 grad's clipped value is not rounded to
    bfloat16 before the moments take it)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    step = state.step + 1
    dev = step.device
    lr = lr_schedule(cfg, step)
    s = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, dev), s)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, dev), s)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32) * scale.to(g.dtype).to(torch.float32)
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g32)
        m_hat = m_new / b1c
        v_hat = v_new / b2c
        p32 = p.to(torch.float32)
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m_new, v_new

    flat = [T.leaves(t) for t in (params, grads, state.m, state.v)]
    if len({len(f) for f in flat}) != 1:
        raise ValueError(f"params, grads, m and v have {[len(f) for f in flat]} leaves")
    out = [upd(*leaves) for leaves in zip(*flat)]
    new_p = T.unflatten(params, [o[0] for o in out])
    new_m = T.unflatten(params, [o[1] for o in out])
    new_v = T.unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, m=new_m, v=new_v), {"grad_norm": gn, "lr": lr}
