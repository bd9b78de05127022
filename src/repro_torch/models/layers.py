"""Shared model building blocks (plain functions on tensors).

Port of ``repro.models.layers``.  Parameter convention: every layer
declares its parameters as a tree of ``ParamDef`` (shape + logical axes
+ initializer).  ``init_params`` materializes them; ``logical_axes``
extracts the parallel axes tree that ``repro_torch.sharding`` maps onto
a device mesh; ``abstract_params`` gives ``meta``-device stand-ins.
Parameters are nested dicts of tensors whose leaf names, shapes and
dtypes are the reference's, so ``repro_torch.tree`` walks them in the
reference's order (checkpoints keep its manifest).

``params_from_numpy`` turns the reference's parameters, as host arrays,
into the port's.  The reference's ``vma_like`` exists only for JAX's
``shard_map`` and has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch import tree as T
from repro_torch.kernels.backend import resolve_device

PyTree = Any


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (len == ndim)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _materialize(defn: ParamDef, gen: torch.Generator, dtype, device) -> Tensor:
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=dtype, device=device)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=dtype, device=device)
    fan_in = defn.shape[0] if len(defn.shape) >= 1 else 1
    std = 1.0 if defn.init == "embed" else defn.scale / np.sqrt(max(fan_in, 1))
    x = torch.randn(defn.shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(float(std)).to(dtype)


def init_params(defs: PyTree, gen: Union[torch.Generator, int] = 0,
                dtype=torch.float32, device="cuda") -> PyTree:
    """The tree ``defs`` describes, drawn leaf after leaf (the reference's
    leaf order) from ``gen``: a ``torch.Generator`` on ``device`` or a
    seed for one.  The values differ from ``jax.random``'s; tests pass
    the reference's parameters through :func:`params_from_numpy`."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return T.map_leaves(lambda d: _materialize(d, gen, dtype, dev), defs)


def params_from_numpy(tree: PyTree, device="cuda") -> PyTree:
    """The reference's parameters (or caches), given as host arrays, as
    tensors on ``device`` with the same leaf names.  bfloat16 leaves
    (ml_dtypes) keep their bits."""
    dev = resolve_device(device)
    return T.map_leaves(lambda a: T.to_tensor(a).to(dev), tree)


def logical_axes(defs: PyTree) -> PyTree:
    return T.map_leaves(lambda d: d.axes, defs)


def abstract_params(defs: PyTree, dtype) -> PyTree:
    """``meta``-device stand-ins (shapes and dtypes; no allocation)."""
    return T.map_leaves(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def stack_layer_defs(defs: PyTree, n_layers: int) -> PyTree:
    """Prefix every ParamDef with a leading 'layers' axis (stacked layers)."""
    return T.map_leaves(
        lambda d: ParamDef((n_layers,) + d.shape, ("layers",) + d.axes, d.init, d.scale), defs
    )


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def norm_defs(d_model: int, kind: str) -> Dict[str, ParamDef]:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d_model,), ("embed",), "ones")}
    if kind == "layernorm":
        return {
            "scale": ParamDef((d_model,), ("embed",), "ones"),
            "bias": ParamDef((d_model,), ("embed",), "zeros"),
        }
    raise ValueError(kind)


def apply_norm(params: Dict[str, Tensor], x: Tensor, kind: str, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].float()
        return y.to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)  # jnp.var: population variance
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (partial-rotary supported, e.g. StableLM 25%)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, rotary_pct: float, theta: float, device=None) -> Tensor:
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exps)  # (rot_dim/2,)


def apply_rope(x: Tensor, positions: Tensor, rotary_pct: float, theta: float) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    if rot_dim == 0:
        return x
    inv = rope_frequencies(head_dim, rotary_pct, theta, x.device)
    ang = positions[..., :, None].float() * inv  # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :]  # (..., seq, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    x_rot = x[..., :rot_dim].float()
    x_pass = x[..., rot_dim:]
    x1 = x_rot[..., 0::2]
    x2 = x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([y, x_pass], dim=-1) if rot_dim < head_dim else y


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_defs(d_model: int, d_ff: int, act: str) -> Dict[str, ParamDef]:
    if act == "swiglu":
        return {
            "w_gate": ParamDef((d_model, d_ff), ("embed", "mlp")),
            "w_up": ParamDef((d_model, d_ff), ("embed", "mlp")),
            "w_down": ParamDef((d_ff, d_model), ("mlp", "embed")),
        }
    return {
        "w_up": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(params: Dict[str, Tensor], x: Tensor, act: str) -> Tensor:
    cdt = x.dtype
    if act == "swiglu":
        g = x @ params["w_gate"].to(cdt)
        u = x @ params["w_up"].to(cdt)
        h = F.silu(g.float()).to(cdt) * u
    elif act == "gelu":
        h = gelu((x @ params["w_up"].to(cdt)).float()).to(cdt)
    elif act == "relu2":  # nemotron squared-ReLU
        h = x @ params["w_up"].to(cdt)
        h = torch.square(F.relu(h.float())).to(cdt)
    else:
        raise ValueError(act)
    return h @ params["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_defs(vocab: int, d_model: int) -> Dict[str, ParamDef]:
    return {"embedding": ParamDef((vocab, d_model), ("vocab", "embed"), "embed")}


def apply_embed(params: Dict[str, Tensor], tokens: Tensor, compute_dtype) -> Tensor:
    return F.embedding(tokens.long(), params["embedding"]).to(compute_dtype)


def head_defs(d_model: int, vocab: int) -> Dict[str, ParamDef]:
    return {"w_out": ParamDef((d_model, vocab), ("embed", "vocab"))}


def apply_head(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    return x @ params["w_out"].to(x.dtype)
