"""Mixture-of-Experts layer: top-k router + capacity-based dispatch.

Port of ``repro.models.moe``.  Dispatch is *row-local*: positions within
an expert are an exclusive cumsum over the row's S*K assignment slots
(token-major priority).  Tokens beyond an expert's capacity
C = ceil(S*K/E * capacity_factor) go to a drop bin (row ``C`` of the
dispatch tables), which is cropped; the gathered (B, E, C, d) activations
run the expert FFN and are scatter-added back (``index_add_``; on a CUDA
tensor its float order is not fixed).

Top-k keeps the lower expert index on a tie, as ``jax.lax.top_k`` does:
the probabilities are sorted with a stable descending sort.  With
``dispatch_dtype="int16"`` the one-hot is int16; ``torch.cumsum`` returns
int64, with the same values.  ``REPRO_BASELINE_MOE_NO_CONSTRAIN`` keeps
its reference meaning (skip the sharding constraints); on a plain tensor
``constrain`` is the identity either way.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import ParamDef
from repro_torch.sharding import constrain


def moe_defs(d_model: int, moe: MoEConfig) -> Dict[str, ParamDef]:
    e, f = moe.n_experts, moe.d_ff_expert
    defs = {
        "w_router": ParamDef((d_model, e), ("embed", None)),
        "w_gate": ParamDef((e, d_model, f), ("experts", "embed", "mlp")),
        "w_up": ParamDef((e, d_model, f), ("experts", "embed", "mlp")),
        "w_down": ParamDef((e, f, d_model), ("experts", "mlp", "embed")),
    }
    if moe.shared_expert:
        defs.update(
            {
                "ws_gate": ParamDef((d_model, f), ("embed", "mlp")),
                "ws_up": ParamDef((d_model, f), ("embed", "mlp")),
                "ws_down": ParamDef((f, d_model), ("mlp", "embed")),
            }
        )
    return defs


def capacity(seq_len: int, moe: MoEConfig) -> int:
    c = int(seq_len * moe.experts_per_token / moe.n_experts * moe.capacity_factor)
    return max(8, min(c, seq_len * moe.experts_per_token))


def top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equals."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def one_hot(ids: Tensor, n: int, dtype: torch.dtype) -> Tensor:
    """``F.one_hot(ids, n).to(dtype)`` as one comparison: the same values,
    and the same ops on every device (``F.one_hot`` checks its range on
    the host on a CPU tensor and takes another path on ``meta``)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def apply_moe(params: Dict[str, Tensor], x: Tensor, moe: MoEConfig) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    cdt = x.dtype
    b, s, d = x.shape
    e, k = moe.n_experts, moe.experts_per_token
    cap = capacity(s, moe)
    dev = x.device

    logits = (x @ params["w_router"].to(cdt)).float()  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)  # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # ---- positions within experts (row-local, token-major priority) -------
    bk_dtype = torch.int16 if moe.dispatch_dtype == "int16" else torch.int32
    ids_flat = expert_ids.reshape(b, s * k)  # (B, S*K)
    gates_flat = gate_vals.reshape(b, s * k)
    oh = one_hot(ids_flat, e, bk_dtype)  # (B, S*K, E)
    pos_in_e = torch.cumsum(oh, dim=1) - oh  # exclusive cumsum
    pos_flat = (pos_in_e * oh).sum(dim=-1)  # (B, S*K)
    keep = pos_flat < cap
    tok_idx = torch.arange(s * k, device=dev) // k  # owning token

    # ---- scatter dispatch tables (B, E, C) --------------------------------
    # kept slots are distinct; only the drop bin (row `cap`) takes
    # duplicate writes, and it is cropped
    b_idx = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    safe_pos = torch.where(keep, pos_flat, cap)
    where = (b_idx, ids_flat, safe_pos)
    idx_table = torch.zeros((b, e, cap + 1), dtype=torch.int64, device=dev)
    idx_table = idx_table.index_put(where, tok_idx.expand(b, s * k))
    gate_table = torch.zeros((b, e, cap + 1), dtype=torch.float32, device=dev)
    gate_table = gate_table.index_put(where, gates_flat)
    idx_table, gate_table = idx_table[:, :, :cap], gate_table[:, :, :cap]

    # ---- gather -> expert FFN -> combine -----------------------------------
    noc = bool(os.environ.get("REPRO_BASELINE_MOE_NO_CONSTRAIN"))
    ec = ("batch", "experts", None, None)
    x_exp = x[torch.arange(b, device=dev)[:, None, None], idx_table]  # (B,E,C,D)
    x_exp = x_exp if noc else constrain(x_exp, ec)
    g = torch.einsum("becd,edf->becf", x_exp, params["w_gate"].to(cdt))
    u = torch.einsum("becd,edf->becf", x_exp, params["w_up"].to(cdt))
    h = F.silu(g.float()).to(cdt) * u
    h = h if noc else constrain(h, ("batch", "experts", None, "mlp"))
    y_exp = torch.einsum("becf,efd->becd", h, params["w_down"].to(cdt))
    y_exp = y_exp if noc else constrain(y_exp, ec)
    y_exp = y_exp * gate_table[..., None].to(cdt)

    rows = (torch.arange(b, device=dev)[:, None] * s + idx_table.reshape(b, e * cap)).reshape(-1)
    out = torch.zeros((b * s, d), dtype=cdt, device=dev)
    out.index_add_(0, rows, y_exp.reshape(b * e * cap, d))
    out = out.reshape(b, s, d)

    if moe.shared_expert:
        sg = x @ params["ws_gate"].to(cdt)
        su = x @ params["ws_up"].to(cdt)
        sh = F.silu(sg.float()).to(cdt) * su
        out = out + sh @ params["ws_down"].to(cdt)

    # ---- switch-style load-balance auxiliary loss --------------------------
    me = probs.mean(dim=(0, 1))  # (E,) mean router prob
    ce = one_hot(expert_ids[..., 0], e, torch.float32).mean(dim=(0, 1))  # top-1 frac
    aux = e * torch.sum(me * ce)
    return out, aux
