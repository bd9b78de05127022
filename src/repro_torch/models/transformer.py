"""Decoder-only model assembly for all assigned architecture families.

Port of ``repro.models.transformer``.  Families:
  dense / moe / audio / vlm : pre-norm attention + MLP/MoE blocks
  ssm (rwkv6)               : time-mix + channel-mix blocks (attention-free)
  hybrid (recurrentgemma)   : (rec, rec, local-attn) super-layers

Parameters keep the reference's stacked ``layers`` axis; the layers run
as a Python loop over views of the stacked leaves (the reference scans
over them), each layer rematerialized in training as ``cfg.remat`` and
``cfg.remat_policy`` say (``torch.utils.checkpoint``).  Entry points: ``forward`` (train / prefill logits),
``loss_fn``, ``prefill`` and ``decode_step`` with their caches
(``init_caches``; ``abstract_caches`` on ``meta`` for the dry run), and the
``embeds`` input mode of the modality-frontend stub archs (musicgen,
internvl2).  Everything runs where the parameters live; a cache's
``len`` is a 0-dim int32 tensor there, so a decode step never waits for
the host.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.sharding import constrain

PyTree = Any

DECODE_CACHE_MARGIN = 8  # capacity beyond the prefilled length


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------


def _dense_layer_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    defs: Dict[str, Any] = {
        "ln1": L.norm_defs(d, cfg.norm),
        "attn": attn.attention_defs(d, cfg.n_heads, cfg.n_kv_heads, hd),
        "ln2": L.norm_defs(d, cfg.norm),
    }
    if cfg.moe is not None:
        defs["moe"] = moe_mod.moe_defs(d, cfg.moe)
    else:
        defs["mlp"] = L.mlp_defs(d, cfg.d_ff, cfg.act)
    return defs


def _ssm_layer_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": L.norm_defs(d, cfg.norm),
        "tm": rwkv_mod.timemix_defs(d, cfg.n_heads),
        "ln2": L.norm_defs(d, cfg.norm),
        "cm": rwkv_mod.channelmix_defs(d, cfg.d_ff),
    }


def _rec_layer_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    h = cfg.hybrid
    return {
        "ln1": L.norm_defs(d, cfg.norm),
        "rglru": rglru_mod.rglru_defs(d, h.lru_width or d, h.conv_width),
        "ln2": L.norm_defs(d, cfg.norm),
        "mlp": L.mlp_defs(d, cfg.d_ff, cfg.act),
    }


def _attn_layer_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "ln1": L.norm_defs(d, cfg.norm),
        "attn": attn.attention_defs(d, cfg.n_heads, cfg.n_kv_heads, hd),
        "ln2": L.norm_defs(d, cfg.norm),
        "mlp": L.mlp_defs(d, cfg.d_ff, cfg.act),
    }


def hybrid_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(#super_layers, #trailing_rec) for the (rec,rec,attn) pattern."""
    p = cfg.hybrid.attn_period
    return cfg.n_layers // p, cfg.n_layers % p


def model_defs(cfg: ArchConfig) -> Dict[str, Any]:
    defs: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        defs["embed"] = L.embed_defs(cfg.vocab_size, cfg.d_model)
    if cfg.family == "ssm":
        defs["layers"] = L.stack_layer_defs(_ssm_layer_defs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        n_super, n_tail = hybrid_layout(cfg)
        super_defs = {
            "rec1": _rec_layer_defs(cfg),
            "rec2": _rec_layer_defs(cfg),
            "attn": _attn_layer_defs(cfg),
        }
        defs["layers"] = L.stack_layer_defs(super_defs, n_super)
        for i in range(n_tail):
            defs[f"tail_{i}"] = _rec_layer_defs(cfg)
    else:
        defs["layers"] = L.stack_layer_defs(_dense_layer_defs(cfg), cfg.n_layers)
    defs["ln_f"] = L.norm_defs(cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        defs["head"] = L.head_defs(cfg.d_model, cfg.vocab_size)
    return defs


# ---------------------------------------------------------------------------
# Block bodies (train / prefill path)
# ---------------------------------------------------------------------------


def _dense_block(p: Dict[str, Tensor], x: Tensor, positions: Tensor, cfg: ArchConfig,
                 window: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    x = constrain(x, ("batch", "seq", "embed"))
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    h = attn.apply_attention(
        p["attn"], h, positions,
        rotary_pct=cfg.rotary_pct, rope_theta=cfg.rope_theta,
        chunk=cfg.attn_chunk, window=window, unroll=cfg.unroll_loops,
    )
    x = x + h
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is not None:
        h, aux = moe_mod.apply_moe(p["moe"], h, cfg.moe)
    else:
        h = L.apply_mlp(p["mlp"], h, cfg.act)
    return x + h, aux


def _ssm_block(p: Dict[str, Tensor], x: Tensor, cfg: ArchConfig) -> Tensor:
    x = constrain(x, ("batch", "seq", "embed"))
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    x = x + rwkv_mod.apply_timemix(
        p["tm"], h, cfg.n_heads, chunk=cfg.rwkv_chunk, unroll=cfg.unroll_loops
    )
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + rwkv_mod.apply_channelmix(p["cm"], h, rwkv_mod._shift(h))


def _rec_block(p: Dict[str, Tensor], x: Tensor, cfg: ArchConfig) -> Tensor:
    x = constrain(x, ("batch", "seq", "embed"))
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    x = x + rglru_mod.apply_rglru_block(p["rglru"], h)
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], h, cfg.act)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _embed_in(params, cfg: ArchConfig, tokens: Optional[Tensor], embeds: Optional[Tensor]):
    cdt = _dtype(cfg.compute_dtype)
    if cfg.input_mode == "tokens":
        assert tokens is not None
        x = L.apply_embed(params["embed"], tokens, cdt)
    else:
        assert embeds is not None
        x = embeds.to(cdt)
    return constrain(x, ("batch", "seq", "embed"))


def _logits_out(params, cfg: ArchConfig, x: Tensor) -> Tensor:
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].to(x.dtype).T
    else:
        logits = L.apply_head(params["head"], x)
    return constrain(logits, ("batch", "seq", "vocab"))


def _layer_slice(stacked: PyTree, i: int) -> PyTree:
    """Layer ``i``'s parameters (or caches): views of the stacked leaves."""
    return T.map_leaves(lambda a: a[i], stacked)


def _layer_slices(stacked: PyTree, n: int) -> List[PyTree]:
    """Every layer's parameters, by one ``unbind`` a stacked leaf: its
    backward stacks the layers' gradients once, where ``n`` selects
    would each fill a whole stack of zeros."""
    per_leaf = [a.unbind(0) for a in T.leaves(stacked)]
    return [T.unflatten(stacked, [u[i] for u in per_leaf]) for i in range(n)]


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dims (``aten.mm``,
    ``aten.addmm``: every projection, whose leading dims torch folds into
    rows); recompute the rest.  Attention's ``bmm`` has batch dims and is
    recomputed, as ``dots_with_no_batch_dims_saveable`` recomputes a
    ``dot_general`` with batch dims."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body: Callable, cfg: ArchConfig, for_training: bool) -> Callable:
    """The reference's ``_remat``: with ``cfg.remat`` and ``for_training``
    a layer body keeps only its inputs for the backward pass and runs
    again there (``torch.utils.checkpoint``, non-reentrant); the ``dots``
    policy also keeps its matmul outputs (:func:`_dots_policy`)."""
    if not (cfg.remat and for_training):
        return body
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, body, use_reentrant=False, **kw)


def _n_stacked(cfg: ArchConfig) -> int:
    return hybrid_layout(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(
    params: PyTree,
    cfg: ArchConfig,
    tokens: Optional[Tensor] = None,
    embeds: Optional[Tensor] = None,
    *,
    for_training: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Returns (logits, moe_aux_loss).  With ``for_training`` and
    ``cfg.remat`` every layer body (a (rec, rec, attn) super layer for the
    hybrid) is rematerialized in the backward pass, by ``cfg.remat_policy``
    (:func:`_remat`); the values are the same either way."""
    x = _embed_in(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _layer_slices(params["layers"], _n_stacked(cfg))

    if cfg.family == "ssm":
        body = _remat(lambda h, lp: _ssm_block(lp, h, cfg), cfg, for_training)
        for lp in layers:
            x = body(x, lp)
    elif cfg.family == "hybrid":
        win = cfg.hybrid.local_window

        def super_layer(h, lp):
            h = _rec_block(lp["rec1"], h, cfg)
            h = _rec_block(lp["rec2"], h, cfg)
            return _dense_block(lp["attn"], h, positions, cfg, window=win)[0]

        body = _remat(super_layer, cfg, for_training)
        for lp in layers:
            x = body(x, lp)
        for i in range(hybrid_layout(cfg)[1]):
            x = _rec_block(params[f"tail_{i}"], x, cfg)
    else:
        def dense_layer(h, aux_c, lp):
            h, aux_n = _dense_block(lp, h, positions, cfg)
            return h, aux_c + aux_n

        body = _remat(dense_layer, cfg, for_training)
        for lp in layers:
            x, aux = body(x, aux, lp)

    return _logits_out(params, cfg, x), aux


def loss_fn(
    params: PyTree,
    cfg: ArchConfig,
    batch: Dict[str, Tensor],
    *,
    aux_weight: float = 0.01,
    ce_chunk: int = 0,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Causal-LM cross-entropy (+ MoE aux). batch: tokens/embeds + labels."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"))
    labels = batch["labels"].long()

    def ce_sum(lg: Tensor, y: Tensor) -> Tensor:
        lg = lg.float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, y[..., None])[..., 0]
        return torch.sum(lse - gold)

    if ce_chunk and labels.shape[1] % ce_chunk == 0 and labels.shape[1] > ce_chunk:
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for c in range(labels.shape[1] // ce_chunk):
            cut = slice(c * ce_chunk, (c + 1) * ce_chunk)
            total = total + ce_sum(logits[:, cut], labels[:, cut])
        ce = total / (labels.shape[0] * labels.shape[1])
    else:
        lg = logits.float()
        ce = torch.mean(torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, labels[..., None])[..., 0])

    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, prefill_len: int, device="cuda") -> PyTree:
    """Zero caches for a serving shape, on ``device``."""
    return _zero_caches(cfg, batch, prefill_len, resolve_device(device))


def abstract_caches(cfg: ArchConfig, batch: int, prefill_len: int) -> PyTree:
    """``meta``-device stand-ins for :func:`init_caches`' tree (the same
    leaves, shapes and dtypes; no allocation): the reference's
    ``jax.eval_shape(lambda: init_caches(cfg, batch, prefill_len))``."""
    return _zero_caches(cfg, batch, prefill_len, torch.device("meta"))


def _zero_caches(cfg: ArchConfig, batch: int, prefill_len: int, dev: torch.device) -> PyTree:
    cdt = _dtype(cfg.compute_dtype)
    f32 = torch.float32
    hd = cfg.resolved_head_dim
    cap = prefill_len + DECODE_CACHE_MARGIN

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    length = zeros((), torch.int32)
    if cfg.family == "ssm":
        return {
            "state": zeros((cfg.n_layers, batch, cfg.n_heads, hd, hd), f32),
            "prev1": zeros((cfg.n_layers, batch, 1, cfg.d_model), cdt),
            "prev2": zeros((cfg.n_layers, batch, 1, cfg.d_model), cdt),
            "len": length,
        }
    if cfg.family == "hybrid":
        n_super, n_tail = hybrid_layout(cfg)
        w = cfg.hybrid.lru_width or cfg.d_model
        k = cfg.hybrid.conv_width
        win = min(cfg.hybrid.local_window, cap)
        caches = {
            "h": zeros((n_super, 2, batch, w), f32),
            "conv": zeros((n_super, 2, batch, k - 1, w), cdt),
            "k": zeros((n_super, batch, win, cfg.n_kv_heads, hd), cdt),
            "v": zeros((n_super, batch, win, cfg.n_kv_heads, hd), cdt),
            "len": length,
        }
        for i in range(n_tail):
            caches[f"tail_h_{i}"] = zeros((batch, w), f32)
            caches[f"tail_conv_{i}"] = zeros((batch, k - 1, w), cdt)
        return caches
    return {
        "k": zeros((cfg.n_layers, batch, cap, cfg.n_kv_heads, hd), cdt),
        "v": zeros((cfg.n_layers, batch, cap, cfg.n_kv_heads, hd), cdt),
        "len": length,
    }


def cache_axes(cfg: ArchConfig) -> PyTree:
    """Logical axes for the cache tree (for sharding the decode step)."""
    if cfg.family == "ssm":
        return {
            "state": ("layers", "batch", "heads", "head_dim", None),
            "prev1": ("layers", "batch", None, "embed"),
            "prev2": ("layers", "batch", None, "embed"),
            "len": (),
        }
    if cfg.family == "hybrid":
        n_super, n_tail = hybrid_layout(cfg)
        axes = {
            "h": ("layers", None, "batch", "mlp"),
            "conv": ("layers", None, "batch", None, "mlp"),
            "k": ("layers", "batch", None, "kv_heads", "head_dim"),
            "v": ("layers", "batch", None, "kv_heads", "head_dim"),
            "len": (),
        }
        for i in range(n_tail):
            axes[f"tail_h_{i}"] = ("batch", "mlp")
            axes[f"tail_conv_{i}"] = ("batch", None, "mlp")
        return axes
    return {
        "k": ("layers", "batch", None, "kv_heads", "head_dim"),
        "v": ("layers", "batch", None, "kv_heads", "head_dim"),
        "len": (),
    }


def _dense_block_decode(p, x, caches_l, cache_len, cfg: ArchConfig,
                        window: Optional[int] = None):
    """x: (B,1,D). caches_l: dict k/v (B,cap,KV,hd). Returns (x, new_k, new_v)."""
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    h, k_new, v_new = attn.apply_attention_decode(
        p["attn"], h, caches_l["k"], caches_l["v"], cache_len,
        rotary_pct=cfg.rotary_pct, rope_theta=cfg.rope_theta, window=window,
    )
    x = x + h
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    if cfg.moe is not None:
        h, _ = moe_mod.apply_moe(p["moe"], h, cfg.moe)
    else:
        h = L.apply_mlp(p["mlp"], h, cfg.act)
    return x + h, k_new, v_new


def _ssm_block_decode(p, x, state, prev1, prev2, cfg: ArchConfig):
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    o, state = rwkv_mod.apply_timemix_decode(p["tm"], h, state, prev1, cfg.n_heads)
    x = x + o
    h2 = L.apply_norm(p["ln2"], x, cfg.norm)
    x = x + rwkv_mod.apply_channelmix(p["cm"], h2, prev2)
    return x, state, h, h2


def _rec_block_decode(p, x, h_state, conv_state, cfg: ArchConfig):
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    o, h_state, conv_state = rglru_mod.apply_rglru_block_decode(
        p["rglru"], h, h_state, conv_state
    )
    x = x + o
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], h, cfg.act), h_state, conv_state


def decode_step(
    params: PyTree,
    cfg: ArchConfig,
    caches: PyTree,
    tokens: Optional[Tensor] = None,  # (B, 1) int
    embeds: Optional[Tensor] = None,  # (B, 1, D)
) -> Tuple[Tensor, PyTree]:
    """One serving step: consume one token, emit logits, update caches.
    The caches given are left as they are; new ones are returned."""
    x = _embed_in(params, cfg, tokens, embeds)
    cache_len = caches["len"]
    layers = params["layers"]

    if cfg.family == "ssm":
        ys = []
        for i in range(cfg.n_layers):
            x, state, h1, h2 = _ssm_block_decode(
                _layer_slice(layers, i), x, caches["state"][i], caches["prev1"][i],
                caches["prev2"][i], cfg,
            )
            ys.append((state, h1, h2))
        state, prev1, prev2 = (torch.stack([y[j] for y in ys]) for j in range(3))
        new_caches = {"state": state, "prev1": prev1, "prev2": prev2, "len": cache_len + 1}
    elif cfg.family == "hybrid":
        n_super, n_tail = hybrid_layout(cfg)
        ys = []
        for i in range(n_super):
            lp = _layer_slice(layers, i)
            h_st, conv_st = caches["h"][i], caches["conv"][i]
            x, h0, c0 = _rec_block_decode(lp["rec1"], x, h_st[0], conv_st[0], cfg)
            x, h1, c1 = _rec_block_decode(lp["rec2"], x, h_st[1], conv_st[1], cfg)
            # ring-buffer local attention over the window-sized cache
            h = L.apply_norm(lp["attn"]["ln1"], x, cfg.norm)
            o, k_new, v_new = attn.apply_attention_decode(
                lp["attn"]["attn"], h, caches["k"][i], caches["v"][i], cache_len,
                rotary_pct=cfg.rotary_pct, rope_theta=cfg.rope_theta, ring=True,
            )
            x = x + o
            h = L.apply_norm(lp["attn"]["ln2"], x, cfg.norm)
            x = x + L.apply_mlp(lp["attn"]["mlp"], h, cfg.act)
            ys.append((torch.stack([h0, h1]), torch.stack([c0, c1]), k_new, v_new))
        h_new, conv_new, k_new, v_new = (torch.stack([y[j] for y in ys]) for j in range(4))
        new_caches = dict(caches)
        new_caches.update({"h": h_new, "conv": conv_new, "k": k_new, "v": v_new,
                           "len": cache_len + 1})
        for i in range(n_tail):
            x, hs, cs = _rec_block_decode(
                params[f"tail_{i}"], x, caches[f"tail_h_{i}"], caches[f"tail_conv_{i}"], cfg
            )
            new_caches[f"tail_h_{i}"] = hs
            new_caches[f"tail_conv_{i}"] = cs
    else:
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, k_new, v_new = _dense_block_decode(
                _layer_slice(layers, i), x, {"k": caches["k"][i], "v": caches["v"][i]},
                cache_len, cfg,
            )
            ks.append(k_new)
            vs.append(v_new)
        new_caches = {"k": torch.stack(ks), "v": torch.stack(vs), "len": cache_len + 1}

    return _logits_out(params, cfg, x), new_caches


def prefill(
    params: PyTree,
    cfg: ArchConfig,
    tokens: Optional[Tensor] = None,
    embeds: Optional[Tensor] = None,
) -> Tuple[Tensor, PyTree]:
    """Prefill pass: full forward returning last-position logits + caches.

    The dense families get their roped k/v per layer, padded to the
    decode capacity.  For ``ssm`` and ``hybrid`` the reference returns
    the forward's logits with ZERO recurrent states (``init_caches``)
    and ``len`` = s; the port keeps that behaviour.
    """
    x = _embed_in(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    dev = x.device
    length = torch.tensor(s, dtype=torch.int32, device=dev)

    if cfg.family in ("ssm", "hybrid"):
        logits, _ = forward(params, cfg, tokens=tokens, embeds=embeds, for_training=False)
        caches = _zero_caches(cfg, b, s, dev)
        caches["len"] = length
        return logits[:, -1:], caches

    positions = _positions(b, s, dev)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer_slice(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        q, k, v = attn._project_qkv(lp["attn"], h)
        q = L.apply_rope(q, positions, cfg.rotary_pct, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rotary_pct, cfg.rope_theta)
        o = attn.chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk,
                                          unroll=cfg.unroll_loops)
        x = x + attn.project_out(lp["attn"], o)
        h = L.apply_norm(lp["ln2"], x, cfg.norm)
        if cfg.moe is not None:
            h, _ = moe_mod.apply_moe(lp["moe"], h, cfg.moe)
        else:
            h = L.apply_mlp(lp["mlp"], h, cfg.act)
        x = x + h
        ks.append(k)
        vs.append(v)
    logits = _logits_out(params, cfg, x[:, -1:])
    pad = (0, 0, 0, 0, 0, DECODE_CACHE_MARGIN)  # (L, B, S, KV, hd): S to s + margin
    caches = {
        "k": F.pad(torch.stack(ks), pad),
        "v": F.pad(torch.stack(vs), pad),
        "len": length,
    }
    return logits, caches
