"""Architecture / run configuration system (port of ``repro.configs.base``).

One ``ArchConfig`` per assigned architecture (exact, from public
literature) plus a ``reduced()`` transform producing the CPU-smoke-test
variant of the same family.  Shape suites are the four canonical
(seq_len, global_batch) cells from the assignment.

The same names and values as the reference; dtype fields stay strings
(``repro_torch.models.transformer`` maps them to torch dtypes).  ``remat``
and ``remat_policy`` act as in the reference: in training each layer body
is recomputed in the backward pass (``torch.utils.checkpoint``; ``dots``
keeps the matmul outputs).  The port runs its layers as a Python loop and
has no scan, so ``scan_layers`` and ``unroll_loops`` are kept but change
nothing in it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int  # top-k
    d_ff_expert: int
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on shared expert
    # dispatch bookkeeping dtype: int32 baseline; int16 halves the one-hot
    # + position-cumsum HBM traffic (safe: positions < seq*k < 2^15) — §Perf
    dispatch_dtype: str = "int32"


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style block pattern: attn every `attn_period` layers."""

    attn_period: int = 3  # 1 local-attention layer per 3 (1:2 ratio)
    local_window: int = 2048
    lru_width: Optional[int] = None  # defaults to d_model
    conv_width: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"  # swiglu | gelu | relu2
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rotary_pct: float = 1.0
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    input_mode: str = "tokens"  # tokens | embeds (modality-frontend stubs)
    moe: Optional[MoEConfig] = None
    hybrid: Optional[HybridConfig] = None
    # --- numerics / partitioning policy ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    fsdp: bool = False  # shard params+opt over the data axis too
    remat: bool = True
    remat_policy: str = "full"  # full (save nothing) | dots (save matmul outs)
    scan_layers: bool = True
    attn_chunk: int = 1024  # kv/q chunk for memory-efficient attention
    rwkv_chunk: int = 16  # rwkv chunk-parallel block (exp-safety: chunk*5<88)
    ce_chunk: int = 0  # 0 = whole-sequence fp32 CE; >0 = chunked logsumexp
    # cost-probe mode in the reference (unrolled loops for XLA's
    # cost_analysis); the port's loops are Python loops, so its probes
    # (launch/dryrun.py probe_cfg) set it and it changes nothing
    unroll_loops: bool = False
    # --- source provenance ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-context decode cell?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        per_layer = 0
        if self.family == "ssm":  # rwkv6: time-mix + channel-mix
            # r,k,v,w,g projections + output + small lora/mixing params
            tm = 5 * d * d + d * d
            cm = d * f + f * d + d * d  # k, v, r of channel mix
            per_layer = tm + cm + 2 * d
        else:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            attn = q + kv + o
            if self.act == "swiglu":
                mlp = 3 * d * f
            else:
                mlp = 2 * d * f
            if self.moe is not None:
                fe = self.moe.d_ff_expert
                mlp = self.moe.n_experts * 3 * d * fe + d * self.moe.n_experts
                if self.moe.shared_expert:
                    mlp += 3 * d * fe
            if self.family == "hybrid":
                h = self.hybrid
                lw = h.lru_width or d
                rec = d * lw * 2 + lw * d + lw * h.conv_width + 3 * lw  # gates etc
                n_attn = self.n_layers // h.attn_period
                n_rec = self.n_layers - n_attn
                per_layer = 0  # handled below (heterogeneous)
                mlp_all = self.n_layers * 3 * d * f
                attn_all = n_attn * attn
                rec_all = n_rec * rec
                return emb + head + mlp_all + attn_all + rec_all + 2 * d * self.n_layers
            per_layer = attn + mlp + 2 * d
        return emb + head + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k) for MODEL_FLOPS."""
        if self.moe is None:
            return self.param_count()
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        fe = self.moe.d_ff_expert
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        active_mlp = self.moe.experts_per_token * 3 * d * fe + d * self.moe.n_experts
        if self.moe.shared_expert:
            active_mlp += 3 * d * fe
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        return emb + head + self.n_layers * (attn + active_mlp + 2 * d)


# ---------------------------------------------------------------------------
# Shape suites (assignment: LM shapes are seq_len x global_batch).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_SUITE: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_SUITE:
        if c.name == name:
            return c
    raise KeyError(name)


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Does this (arch, shape) cell run? (brief: long_500k needs sub-quadratic)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attn): 500k decode requires sub-quadratic context"
    return True, ""


# ---------------------------------------------------------------------------
# Reduced (smoke-test) configs: same family, tiny dims.
# ---------------------------------------------------------------------------


def reduced(cfg: ArchConfig) -> ArchConfig:
    """A tiny config of the same family for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.hybrid is None else 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk=32,
        fsdp=False,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=4,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff_expert=64,
            capacity_factor=2.0,
            shared_expert=cfg.moe.shared_expert,
        )
    if cfg.hybrid is not None:
        kw["hybrid"] = HybridConfig(
            attn_period=cfg.hybrid.attn_period,
            local_window=32,
            lru_width=64,
            conv_width=cfg.hybrid.conv_width,
        )
        kw["n_layers"] = 4  # pattern: rec, rec, attn, rec
    return replace(cfg, **kw)
