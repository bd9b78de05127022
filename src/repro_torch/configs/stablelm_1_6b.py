"""stablelm-2-1.6b: dense, MHA (kv=32), partial rotary (25%), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    act="swiglu",
    norm="layernorm",
    rotary_pct=0.25,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
