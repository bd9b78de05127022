"""RWKV-6 "Finch" time-mix and channel-mix layers (attention-free SSM).

Port of ``repro.models.rwkv6``.  Recurrence per head (state S in
R^{K x V}):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T           (w_t = data-dependent decay)
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)     (u = per-head bonus)

Three execution paths:
  * ``timemix_scan``     — sequential oracle (exact; used by tests and the
                           single-token decode step),
  * ``timemix_chunked``  — chunk-parallel form used for train/prefill: within
                           a chunk an attention-like einsum with decay
                           ratios (log space), across chunks a short loop
                           carries the state,
  * decode step          — one recurrence application, O(1) state.

Log-decays are clamped to ``>= LOG_W_MIN`` per step, so within a chunk of
``CHUNK`` steps every ``exp(±lw_cum)`` stays below float32's exp range
(16 * 5 = 80 < 88).  The per-head group norm's variance is the
population variance (``correction=0``), as ``jnp``'s.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.models.layers import ParamDef

LOG_W_MIN = -5.0  # per-step clamp on log decay
CHUNK = 16


def timemix_defs(d_model: int, n_heads: int) -> Dict[str, ParamDef]:
    hd = d_model // n_heads
    return {
        "w_r": ParamDef((d_model, d_model), ("embed", "heads_flat")),
        "w_k": ParamDef((d_model, d_model), ("embed", "heads_flat")),
        "w_v": ParamDef((d_model, d_model), ("embed", "heads_flat")),
        "w_g": ParamDef((d_model, d_model), ("embed", "heads_flat")),
        "w_decay": ParamDef((d_model, d_model), ("embed", "heads_flat"), scale=0.1),
        "w_o": ParamDef((d_model, d_model), ("heads_flat", "embed")),
        "bonus_u": ParamDef((n_heads, hd), ("heads", "head_dim"), "zeros"),
        "mix_r": ParamDef((d_model,), ("embed",), "zeros"),
        "mix_k": ParamDef((d_model,), ("embed",), "zeros"),
        "mix_v": ParamDef((d_model,), ("embed",), "zeros"),
        "ln_out_scale": ParamDef((d_model,), ("embed",), "ones"),
    }


def channelmix_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w_k": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_v": ParamDef((d_ff, d_model), ("mlp", "embed")),
        "w_r": ParamDef((d_model, d_model), ("embed", None)),
    }


def _project(params: Dict[str, Tensor], x: Tensor, x_prev: Tensor, n_heads: int):
    """Token-shift mixing + projections. x: (B,S,D); x_prev: (B,S,D)."""
    cdt = x.dtype
    b, s, d = x.shape
    hd = d // n_heads

    def mix(name):
        m = params[f"mix_{name}"].to(cdt)
        return x + (x_prev - x) * m

    r = (mix("r") @ params["w_r"].to(cdt)).reshape(b, s, n_heads, hd)
    k = (mix("k") @ params["w_k"].to(cdt)).reshape(b, s, n_heads, hd)
    v = (mix("v") @ params["w_v"].to(cdt)).reshape(b, s, n_heads, hd)
    g = F.silu((x @ params["w_g"].to(cdt)).float())
    # data-dependent decay (Finch): log w_t from the token itself
    wraw = (x @ params["w_decay"].to(cdt)).float()
    log_w = -torch.exp(torch.clamp(wraw, -20.0, 3.0))  # in (-inf, 0)
    log_w = torch.clamp(log_w, LOG_W_MIN, -1e-4).reshape(b, s, n_heads, hd)
    return r, k, v, g, log_w


def _shift(x: Tensor) -> Tensor:
    """x_{t-1} with zero at t=0 (RWKV token shift)."""
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def timemix_scan(
    r: Tensor, k: Tensor, v: Tensor, log_w: Tensor, u: Tensor, state0: Tensor
) -> Tuple[Tensor, Tensor]:
    """Sequential oracle. r/k/v/log_w: (B,S,H,K); state0: (B,H,K,K_v)."""
    s_prev = state0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], log_w[:, t]  # (B,H,K) each
        w = torch.exp(lwt)[..., None]  # (B,H,K,1)
        kv = kt[..., :, None] * vt[..., None, :]  # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s_prev + u[None, :, :, None] * kv))
        s_prev = w * s_prev + kv
    return torch.stack(outs, dim=1), s_prev  # (B,S,H,V), (B,H,K,V)


def timemix_chunked(
    r: Tensor, k: Tensor, v: Tensor, log_w: Tensor, u: Tensor, state0: Tensor,
    chunk: int = CHUNK, unroll: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Chunk-parallel equivalent of ``timemix_scan``."""
    b, s, h, hd = r.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    t = s // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    state = state0
    outs = []
    for c in range(t):
        rt, kt, vt, lw = (x[:, c * chunk:(c + 1) * chunk] for x in (r, k, v, log_w))
        lw_cum = torch.cumsum(lw, dim=1)  # inclusive: prod_{j<=t} w_j
        lw_total = lw_cum[:, -1:]  # (B,1,H,K)
        # decayed queries / inverse-decayed keys (log-space, fp32)
        r_dec = rt * torch.exp(lw_cum - lw)  # decay up to t-1 (exclusive)
        k_inv = kt * torch.exp(-lw_cum)
        # intra-chunk strictly-lower-triangular interaction
        att = torch.einsum("bchk,bdhk->bhcd", r_dec, k_inv)  # (B,H,C,C)
        att = torch.where(tri[None, None], att, 0.0)
        o_intra = torch.einsum("bhcd,bdhv->bchv", att, vt)
        # current-token bonus
        o_bonus = (rt * (u[None, None] * kt)).sum(dim=-1, keepdim=True) * vt
        # contribution of the carried state
        o_state = torch.einsum("bchk,bhkv->bchv", r_dec, state)
        # state update: S' = diag(prod w) S + sum_tau decay(tau->end) k v^T
        k_dec = kt * torch.exp(lw_total - lw_cum)
        state = torch.exp(lw_total).squeeze(1)[..., None] * state + torch.einsum(
            "bchk,bchv->bhkv", k_dec, vt
        )
        outs.append(o_intra + o_bonus + o_state)
    return torch.cat(outs, dim=1), state


def _group_norm_out(params: Dict[str, Tensor], o: Tensor, g: Tensor, n_heads: int,
                    dtype) -> Tensor:
    """Per-head group norm (RWKV's GroupNorm over heads), scale, gate."""
    b, s, _, hd = o.shape
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, correction=0)
    o = ((o - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, n_heads * hd)
    o = o * params["ln_out_scale"].float()
    o = (o * g).to(dtype)
    return o @ params["w_o"].to(dtype)


def apply_timemix(
    params: Dict[str, Tensor],
    x: Tensor,
    n_heads: int,
    *,
    chunked: bool = True,
    chunk: int = CHUNK,
    unroll: bool = False,
) -> Tensor:
    """Full time-mix sublayer for train/prefill. x: (B,S,D)."""
    b, s, d = x.shape
    hd = d // n_heads
    r, k, v, g, log_w = _project(params, x, _shift(x), n_heads)
    u = params["bonus_u"].float()
    state0 = torch.zeros((b, n_heads, hd, hd), dtype=torch.float32, device=x.device)
    args = (r.float(), k.float(), v.float(), log_w)
    if chunked:
        o, _ = timemix_chunked(*args, u, state0, chunk=chunk, unroll=unroll)
    else:
        o, _ = timemix_scan(*args, u, state0)
    return _group_norm_out(params, o, g, n_heads, x.dtype)


def apply_timemix_decode(
    params: Dict[str, Tensor],
    x: Tensor,  # (B,1,D)
    state: Tensor,  # (B,H,K,V) recurrent state
    x_prev: Tensor,  # (B,1,D) previous token's activations (token shift)
    n_heads: int,
) -> Tuple[Tensor, Tensor]:
    """One decode step; returns (out, new_state)."""
    r, k, v, g, log_w = _project(params, x, x_prev, n_heads)
    u = params["bonus_u"].float()
    o, state = timemix_scan(r.float(), k.float(), v.float(), log_w, u, state)
    return _group_norm_out(params, o, g, n_heads, x.dtype), state


def apply_channelmix(params: Dict[str, Tensor], x: Tensor, x_prev: Tensor) -> Tensor:
    """RWKV channel-mix (squared-ReLU FFN with receptance gate)."""
    cdt = x.dtype
    k = x @ params["w_k"].to(cdt)
    k = torch.square(F.relu(k.float())).to(cdt)
    r = torch.sigmoid((x_prev @ params["w_r"].to(cdt)).float())
    return (r * (k @ params["w_v"].to(cdt)).float()).to(cdt)
