"""Memory-efficient causal GQA attention.

Port of ``repro.models.attention``: the chunked (flash-style)
online-softmax attention of the reference in plain torch, with its
additive mask bias (``NEG_INF``), sliding window and GQA groups; the
single-token decode path over a static KV cache, and the ring-buffer
variant used by RecurrentGemma's local-attention layers.  No fused
attention kernel is used: ``F.scaled_dot_product_attention`` rounds and
masks differently, and the reference has no attention kernel to port.

``REPRO_OPT_ATTN_BF16_PROBS`` keeps its reference meaning: the
probabilities enter the PV product in bfloat16, the softmax statistics
and the accumulator stay float32.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from repro_torch.models.layers import ParamDef, apply_rope

NEG_INF = -1e30


def attention_defs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int):
    return {
        "wq": ParamDef((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((n_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }


def causal_waste(seq_len: int, chunk: int) -> float:
    """Fraction of computed block-pairs that the causal mask zeroes out."""
    t = max(seq_len // chunk, 1)
    useful = t * (t + 1) / 2
    return 1.0 - useful / (t * t)


def _mask_bias(q_pos: Tensor, kv_pos: Tensor, window: Optional[int]) -> Tensor:
    """(..., q, kv) additive bias: 0 where attendable, NEG_INF elsewhere."""
    m = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m = m & (q_pos[..., :, None] - kv_pos[..., None, :] < window)
    return torch.where(m, 0.0, NEG_INF)


def _scale(hd: int) -> float:
    """``1 / sqrt(hd)`` rounded to float32, as the reference computes it."""
    return float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(hd))))


def chunked_causal_attention(
    q: Tensor,  # (B, S, H, hd)
    k: Tensor,  # (B, S, KV, hd)
    v: Tensor,  # (B, S, KV, hd)
    chunk: int,
    window: Optional[int] = None,
    base_pos: int = 0,
    unroll: bool = False,
) -> Tensor:
    """Flash-style chunked attention with online softmax. Returns (B,S,H,hd).

    Every query chunk runs the reference's loop over all key chunks; the
    query chunks go side by side (the reference maps over them one at a
    time, each with the same math)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    t = s // chunk
    scale = _scale(hd)
    f32 = torch.float32
    bf16_probs = bool(os.environ.get("REPRO_OPT_ATTN_BF16_PROBS"))

    # (B, T, C, KV, G, hd) view of q; k/v (B, T, C, KV, hd)
    qc = q.reshape(b, t, chunk, kv, g, hd).to(f32)
    kc = k.reshape(b, t, chunk, kv, hd)
    vc = v.reshape(b, t, chunk, kv, hd)
    pos = base_pos + torch.arange(s, dtype=torch.int32, device=q.device).reshape(t, chunk)

    m = torch.full((b, t, chunk, kv, g), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, t, chunk, kv, g), dtype=f32, device=q.device)
    acc = torch.zeros((b, t, chunk, kv, g, hd), dtype=f32, device=q.device)
    for j in range(t):
        kj, vj = kc[:, j], vc[:, j]  # (B, Ck, KV, hd)
        # scores: (B, T, C, KV, G, Ck)
        sc = torch.einsum("btckgh,bdkh->btckgd", qc, kj.to(f32)) * scale
        bias = _mask_bias(pos, pos[j], window)  # (T, C, Ck)
        sc = sc + bias[None, :, :, None, None, :]
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = p.to(torch.bfloat16) if bf16_probs else p
        acc = acc * alpha[..., None] + torch.einsum(
            "btckgd,bdkh->btckgh", pv, vj.to(pv.dtype)
        ).to(f32)
        m = m_new
    out = (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
    return out.reshape(b, s, h, hd)


def decode_attention(
    q: Tensor,  # (B, 1, H, hd)
    k_cache: Tensor,  # (B, S, KV, hd)
    v_cache: Tensor,  # (B, S, KV, hd)
    cache_len,  # (B,) or scalar int: valid prefix length
    window: Optional[int] = None,
) -> Tensor:
    """Single-token attention over a static cache. Returns (B, 1, H, hd)."""
    b, s, kvh, hd = k_cache.shape
    h = q.shape[2]
    g = h // kvh
    scale = _scale(hd)
    qg = q.reshape(b, kvh, g, hd).float()
    sc = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * scale
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
    cl = cl[..., None] if cl.ndim == 1 else cl[None]
    valid = pos[None, :] < cl  # (B, S)
    if window is not None:
        valid = valid & (pos[None, :] >= cl - window)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _project_qkv(params: Dict[str, Tensor], x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    cdt = x.dtype
    return tuple(torch.einsum("bsd,dhk->bshk", x, params[w].to(cdt)) for w in ("wq", "wk", "wv"))


def project_out(params: Dict[str, Tensor], o: Tensor) -> Tensor:
    return torch.einsum("bshk,hkd->bsd", o, params["wo"].to(o.dtype))


def apply_attention(
    params: Dict[str, Tensor],
    x: Tensor,  # (B, S, D)
    positions: Tensor,  # (B, S)
    *,
    rotary_pct: float,
    rope_theta: float,
    chunk: int,
    window: Optional[int] = None,
    unroll: bool = False,
) -> Tensor:
    """Full training/prefill attention pass (projections + rope + attn + out)."""
    q, k, v = _project_qkv(params, x)
    q = apply_rope(q, positions, rotary_pct, rope_theta)
    k = apply_rope(k, positions, rotary_pct, rope_theta)
    o = chunked_causal_attention(q, k, v, chunk=chunk, window=window, unroll=unroll)
    return project_out(params, o)


def write_slot(cache: Tensor, val: Tensor, slot: Tensor) -> Tensor:
    """``cache`` (B, cap, ...) with row b's entry ``slot[b]`` set to
    ``val[b, 0]``, as a new tensor.  An out-of-range slot is clamped to
    the last entry, as ``jax.lax.dynamic_update_slice_in_dim`` clamps its
    start: the serve engine's decode runs past the capacity."""
    b, cap = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    return cache.index_put((rows, slot.clamp(0, cap - 1).long()), val[:, 0].to(cache.dtype))


def apply_attention_decode(
    params: Dict[str, Tensor],
    x: Tensor,  # (B, 1, D)
    k_cache: Tensor,
    v_cache: Tensor,
    cache_len,
    *,
    rotary_pct: float,
    rope_theta: float,
    window: Optional[int] = None,
    ring: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Decode attention; returns (out, new_k_cache, new_v_cache).

    ``ring=True`` treats the cache as a circular window buffer of capacity
    cap == window: new tokens overwrite slot ``cache_len % cap`` and every
    populated slot is attendable (RoPE is applied with absolute positions
    at write time so relative geometry survives the wrap-around).
    ``cache_len`` stays on the device: nothing here waits for the host.
    """
    b = x.shape[0]
    cap = k_cache.shape[1]
    q, k, v = _project_qkv(params, x)
    cl = torch.as_tensor(cache_len, device=x.device).to(torch.int32)
    abs_pos = torch.broadcast_to(cl.reshape(-1, 1), (b, 1))
    q = apply_rope(q, abs_pos, rotary_pct, rope_theta)
    k = apply_rope(k, abs_pos, rotary_pct, rope_theta)
    slot = torch.remainder(abs_pos, cap) if ring else abs_pos
    k_cache = write_slot(k_cache, k, slot[:, 0])
    v_cache = write_slot(v_cache, v, slot[:, 0])
    valid = torch.clamp(cl + 1, max=cap) if ring else cl + 1
    o = decode_attention(q, k_cache, v_cache, valid, window=None if ring else window)
    return project_out(params, o), k_cache, v_cache

