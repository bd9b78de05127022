"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Port of ``repro.models.rglru``:

    r_t = sigmoid(W_a x_t + b_a)                  recurrence gate
    i_t = sigmoid(W_x x_t + b_x)                  input gate
    log a_t = -c * softplus(Lambda) * r_t         (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence runs as a parallel associative scan for train /
prefill (:func:`associative_scan`: the recursion of
``jax.lax.associative_scan``, pairs combined level by level, O(log S)
depth) and as a single step for decode.  The exponents stay sums of
``log a <= 0``, so nothing overflows (a cumulative product
``exp(-cumsum(log a))`` would).  The rounding follows the reference's
combine order but not its ``exp``; tests hold it at 2e-4.

The Griffin recurrent block wraps the RG-LRU with a short temporal conv
and a GeLU (tanh form, ``jax.nn.gelu``'s default) gating branch.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.models.layers import ParamDef, gelu

C_FACTOR = 8.0


def rglru_defs(d_model: int, lru_width: int, conv_width: int) -> Dict[str, ParamDef]:
    return {
        "w_in_x": ParamDef((d_model, lru_width), ("embed", "mlp")),
        "w_in_g": ParamDef((d_model, lru_width), ("embed", "mlp")),
        "conv_w": ParamDef((conv_width, lru_width), (None, "mlp"), scale=0.5),
        "conv_b": ParamDef((lru_width,), ("mlp",), "zeros"),
        "w_a": ParamDef((lru_width, lru_width), ("mlp", None), scale=0.5),
        "b_a": ParamDef((lru_width,), (None,), "zeros"),
        "w_x": ParamDef((lru_width, lru_width), ("mlp", None), scale=0.5),
        "b_x": ParamDef((lru_width,), (None,), "zeros"),
        "lam": ParamDef((lru_width,), (None,), "ones"),
        "w_out": ParamDef((lru_width, d_model), ("mlp", "embed")),
    }


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(params: Dict[str, Tensor], x: Tensor) -> Tuple[Tensor, Tensor]:
    """(log_a, gated_input) from the post-conv activations x: (B,S,W)."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(xf @ params["w_x"].float() + params["b_x"])
    log_a = -C_FACTOR * _softplus(params["lam"].float()) * r
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * i * xf


def _interleave(a: Tensor, b: Tensor, dim: int) -> Tensor:
    """a at the even positions along ``dim``, b at the odd ones."""
    n = a.shape[dim] + b.shape[dim]
    shape = list(a.shape)
    shape[dim] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(fn: Callable[[Sequence[Tensor], Sequence[Tensor]], Sequence[Tensor]],
                     elems: Sequence[Tensor], dim: int) -> list:
    """Inclusive scan of ``elems`` along ``dim`` with the associative
    ``fn(earlier, later)``, by ``jax.lax.associative_scan``'s recursion:
    combine adjacent pairs, scan the half, then fill the even positions."""

    def sl(x: Tensor, start: int, stop, step: int = 1) -> Tensor:
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return list(xs)
        reduced = fn([sl(x, 0, -1, 2) for x in xs], [sl(x, 1, None, 2) for x in xs])
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn([sl(o, 0, -1) for o in odd], [sl(x, 2, None, 2) for x in xs])
        else:
            even = fn(odd, [sl(x, 2, None, 2) for x in xs])
        even = [torch.cat([sl(x, 0, 1), e], dim=dim) for x, e in zip(xs, even)]
        return [_interleave(e, o, dim) for e, o in zip(even, odd)]

    return scan(list(elems))


def lru_scan(log_a: Tensor, u: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """h_t = a_t h_{t-1} + u_t via associative scan over the seq axis.

    log_a, u: (B, S, W); h0: (B, W).  Returns (h_seq, h_last).
    """
    u = u.clone()
    u[:, 0] = u[:, 0] + torch.exp(log_a[:, 0]) * h0  # fold h0 into the first input

    def combine(c1, c2):
        la1, b1 = c1
        la2, b2 = c2
        return [la1 + la2, torch.exp(la2) * b1 + b2]

    _, h = associative_scan(combine, (log_a, u), dim=1)
    return h, h[:, -1]


def _causal_conv(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    """Short causal temporal conv, width K. x: (B,S,W)."""
    w = params["conv_w"].to(x.dtype)  # (K, W)
    k = w.shape[0]
    acc = x * w[k - 1]
    for i in range(1, k):
        acc = acc + F.pad(x[:, :-i], (0, 0, i, 0)) * w[k - 1 - i]
    return acc + params["conv_b"].to(x.dtype)


def apply_rglru_block(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    """Griffin recurrent block for train/prefill. x: (B,S,D) -> (B,S,D)."""
    cdt = x.dtype
    g = gelu((x @ params["w_in_g"].to(cdt)).float())
    xi = x @ params["w_in_x"].to(cdt)
    xi = _causal_conv(params, xi)
    log_a, u = _gates(params, xi)
    b, s, w = u.shape
    h, _ = lru_scan(log_a, u, torch.zeros((b, w), dtype=torch.float32, device=x.device))
    y = (h * g).to(cdt)
    return y @ params["w_out"].to(cdt)


def apply_rglru_block_decode(
    params: Dict[str, Tensor],
    x: Tensor,  # (B,1,D)
    h_state: Tensor,  # (B,W) recurrent state
    conv_state: Tensor,  # (B,K-1,W) trailing conv inputs
) -> Tuple[Tensor, Tensor, Tensor]:
    """One decode step; returns (out, new_h_state, new_conv_state)."""
    cdt = x.dtype
    g = gelu((x @ params["w_in_g"].to(cdt)).float())
    xi = x @ params["w_in_x"].to(cdt)  # (B,1,W)
    w = params["conv_w"].to(cdt)
    hist = torch.cat([conv_state, xi], dim=1)  # (B,K,W)
    conv = torch.einsum("bkw,kw->bw", hist, w)[:, None] + params["conv_b"].to(cdt)
    log_a, u = _gates(params, conv)
    a = torch.exp(log_a[:, 0])
    h_new = a * h_state + u[:, 0]
    y = (h_new[:, None] * g).to(cdt)
    return y @ params["w_out"].to(cdt), h_new, hist[:, 1:]
